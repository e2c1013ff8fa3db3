"""Farthest point sampling in numpy, for the keypoint tool (the port's
copy of scflow_tpu/ops/fps.py; the reference's tools/collect_3d_keypoints.py
called mmcv's CUDA furthest_point_sample)."""

import numpy as np


def farthest_point_sample(points: np.ndarray, k: int) -> np.ndarray:
    """points (N, 3) -> indices (k,) of the FPS-selected points; O(k*N).

    Starts from point 0 like mmcv's op (its idxs[0] = 0), so keypoints are
    reproducible against reference-generated assets.  k == N returns
    arange(N); k > N raises ValueError (no FPS of that size exists, and
    fewer indices would break fixed-size keypoint banks downstream)."""
    n = len(points)
    if k > n:
        raise ValueError(f"cannot FPS-sample {k} points from {n}")
    if k == n:
        return np.arange(n)
    idx = np.zeros(k, np.int64)
    dist = np.linalg.norm(points - points[idx[0]], axis=-1)
    for i in range(1, k):
        idx[i] = int(np.argmax(dist))
        dist = np.minimum(dist, np.linalg.norm(points - points[idx[i]], axis=-1))
    return idx
