"""The two helpers of the JAX package's utils/visualize.py that the train
workflow's TensorBoard panels use, without cv2: the mmcv flow colour wheel
and the reference's forward splat of an image by a flow."""

import numpy as np

from scflow_tpu_torch.datasets.pipelines.imops import hsv2bgr


def flow2rgb(flow: np.ndarray, unknown_thr: float = 1e6) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) float RGB in [0, 1] (mmcv's colour wheel:
    hue the direction, saturation the magnitude over the largest); flow
    beyond unknown_thr or not finite is black."""
    fx, fy = flow[..., 0], flow[..., 1]
    unknown = ((np.abs(fx) > unknown_thr) | (np.abs(fy) > unknown_thr)
               | ~np.isfinite(fx) | ~np.isfinite(fy))
    fx = np.where(unknown, 0, fx)
    fy = np.where(unknown, 0, fy)
    mag = np.sqrt(fx**2 + fy**2)
    ang = np.arctan2(-fy, -fx) / np.pi  # [-1, 1]
    hsv = np.zeros(flow.shape[:2] + (3,), np.float32)
    hsv[..., 0] = (ang + 1) * 90  # hue in [0, 180), cv2's convention
    maxm = mag.max() if mag.max() > 0 else 1.0
    hsv[..., 1] = np.clip(mag / maxm, 0, 1) * 255
    hsv[..., 2] = 255
    rgb = hsv2bgr(hsv.astype(np.uint8))[..., ::-1].astype(np.float32) / 255.0
    rgb[unknown] = 0
    return rgb


def simple_forward_warp(image, flow, mask, background=(0.5, 0.5, 0.5)):
    """Forward-splat `image` (H, W, 3) by `flow` (H, W, 2) at the pixels
    where mask > 0.5 (reference models/utils/utils.py:81-97): nearest
    pixel, target coordinates clipped and truncated, background
    elsewhere."""
    h, w = image.shape[:2]
    out = np.empty_like(image)
    out[...] = np.asarray(background, image.dtype)
    ys, xs = np.nonzero(mask > 0.5)
    if len(ys):
        wx = np.clip(xs + flow[ys, xs, 0], 0, w - 1).astype(np.int64)
        wy = np.clip(ys + flow[ys, xs, 1], 0, h - 1).astype(np.int64)
        out[wy, wx] = image[ys, xs]
    return out
