"""Pose from predicted flow by PnP on 2D-3D correspondences (the RAFT
baseline's test path, reference base_flow_refiner.py:99-155).  Port of
scflow_tpu/refiners/flow_pose.py: `solve_poses_from_flow`, numpy per
object on the host (cv2's RANSAC-EPnP as cv_pnp.py rebuilds it), and
`solve_poses_from_flow_device`, the batched RANSAC of pnp.py on the flow's
device."""

from typing import Dict, Optional

import numpy as np
import torch

from scflow_tpu_torch.geometry import coords_grid, lift_depth_to_object_points
from scflow_tpu_torch.pnp import solve_pnp_ransac, solve_pnp_ransac_device


def _lift_points(depth, K, R, t):
    ys, xs = np.nonzero(depth > 0)
    d = depth[ys, xs]
    homo = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64) * d[:, None]
    cam = (np.linalg.inv(K.astype(np.float64)) @ homo.T).T
    obj = (R.astype(np.float64).T @ (cam - t).T).T
    return np.stack([xs, ys], -1).astype(np.float32), obj.astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def solve_poses_from_flow(flow, rendered_depths, ref_rotations, ref_translations, internal_k,
                          occlusion=None, occ_thresh: float = 0.5,
                          sample_points: Optional[Dict] = None,
                          reprojection_error: float = 3.0, iterations: int = 100,
                          rng: Optional[np.random.Generator] = None):
    """flow (N, H, W, 2), rendered_depths and occlusion (N, H, W), the
    reference poses and intrinsics, as numpy arrays or tensors.  Returns
    numpy (rotations (N, 3, 3), translations (N, 3), ok (N,) bool); a
    failed solve keeps the reference pose.  The correspondences are the
    rendered pixels (with occlusion > occ_thresh where given) and their
    targets pixel + flow; sample_points {'num', 'mode': 'random' | 'topk'}
    subsamples them as the reference does.  The solve is
    pnp.solve_pnp_ransac (cv2's RANSAC-EPnP in numpy: no cv2)."""
    rng = rng or np.random.default_rng(0)
    flow, rendered_depths, internal_k = _np(flow), _np(rendered_depths), _np(internal_k)
    ref_rotations, ref_translations = _np(ref_rotations), _np(ref_translations)
    occlusion = None if occlusion is None else _np(occlusion)
    n = len(flow)
    out_r = np.array(ref_rotations, np.float32, copy=True)
    out_t = np.array(ref_translations, np.float32, copy=True)
    ok = np.zeros(n, bool)
    for i in range(n):
        depth = rendered_depths[i]
        valid = depth > 0
        if occlusion is not None:
            valid = valid & (occlusion[i] > occ_thresh)
        d = np.where(valid, depth, 0.0)
        p2d, p3d = _lift_points(d, internal_k[i], ref_rotations[i], ref_translations[i])
        if len(p2d) < 4:
            continue
        f = flow[i][p2d[:, 1].astype(int), p2d[:, 0].astype(int)]
        tgt2d = p2d + f
        if sample_points is not None and len(p2d) > sample_points.get("num", 1000):
            num = sample_points.get("num", 1000)
            if sample_points.get("mode", "random") == "topk" and occlusion is not None:
                conf = occlusion[i][p2d[:, 1].astype(int), p2d[:, 0].astype(int)]
                idx = np.argsort(-conf)[:num]
            else:
                # len - 1: the reference's randperm(n - 1) (base_flow_refiner.py:54)
                # never draws the last correspondence; kept for sampling parity
                idx = rng.permutation(len(p2d) - 1)[:num]
            tgt2d, p3d = tgt2d[idx], p3d[idx]
        R, t, ret = solve_pnp_ransac(p3d, tgt2d, internal_k[i],
                                     reprojection_error=reprojection_error,
                                     iterations=iterations)
        if ret:
            out_r[i], out_t[i], ok[i] = R, t, True
    return out_r, out_t, ok


def flow_only_score(h: int, w: int, device=None) -> torch.Tensor:
    """The fixed pseudo-random (H, W) score that ranks the valid pixels when
    no occlusion is predicted: a spatially uniform subsample, where a
    constant score would take the top rows first.  The port's own draw
    (torch.Generator seeded 7, uniform [0, 1)), not JAX's
    jax.random.uniform(PRNGKey(7)), so the two packages select different
    pixels when more than num_points are valid."""
    g = torch.Generator().manual_seed(7)
    return torch.rand((h, w), generator=g).to(device)


def solve_poses_from_flow_device(flow, rendered_depths, ref_rotations, ref_translations,
                                 internal_k, occlusion=None, occ_thresh: float = 0.5,
                                 num_points: int = 1024, num_hypotheses: int = 64,
                                 reprojection_error: float = 3.0,
                                 generator: Optional[torch.Generator] = None,
                                 uniforms: Optional[torch.Tensor] = None,
                                 flow_score: Optional[torch.Tensor] = None):
    """Batched pose recovery from flow on the flow's device, no host round
    trip: lift the rendered depth (N, H, W) into the object frame, take the
    num_points highest-scoring valid pixels (score: the occlusion
    confidence, or flow_only_score without one; a stable sort, so ties take
    the lower index first, as jax.lax.top_k does), pair them with pixel +
    flow and run solve_pnp_ransac_device (DLT and planar solves, RANSAC,
    Gauss-Newton).  Returns (R (N, 3, 3), t (N, 3), ok (N,)); a failed solve
    keeps the reference pose.  generator (on the flow's device) draws the
    hypotheses, seeded 0 by default; it replaces JAX's `key`.  uniforms and
    flow_score are those draws made beforehand (pnp.hypothesis_uniforms
    for (N, num_hypotheses, min(num_points, H*W)); flow_only_score), which
    an infer fn makes once and a traced graph holds as constants."""
    n, h, w = rendered_depths.shape
    pts_obj, valid = lift_depth_to_object_points(rendered_depths, internal_k, ref_rotations,
                                                 ref_translations)
    if occlusion is not None:
        valid = valid & (occlusion > occ_thresh)
        score = occlusion
    else:
        if flow_score is None:
            flow_score = flow_only_score(h, w, flow.device)
        score = flow_score[None].expand(n, h, w)
    score = torch.where(valid, score.to(flow.dtype), torch.full_like(flow[..., 0], -float("inf")))
    tgt = coords_grid(h, w, flow.dtype, flow.device)[None] + flow
    idx = torch.sort(score.reshape(n, h * w), dim=-1, descending=True,
                     stable=True).indices[:, :num_points]

    def take(a):
        return a.reshape(n, h * w, a.shape[-1]).gather(1, idx[..., None].expand(-1, -1,
                                                                                a.shape[-1]))

    val_sel = valid.reshape(n, h * w).gather(1, idx)
    res = solve_pnp_ransac_device(take(pts_obj), take(tgt), internal_k, val_sel, generator,
                                  num_hypotheses=num_hypotheses,
                                  inlier_thresh_px=reprojection_error, uniforms=uniforms)
    ok = res.ok & (val_sel.sum(dim=1) >= 4)
    R = torch.where(ok[:, None, None], res.rotation, ref_rotations)
    t = torch.where(ok[:, None], res.translation, ref_translations)
    return R, t, ok
