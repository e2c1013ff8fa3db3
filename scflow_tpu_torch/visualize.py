"""The JAX package's utils/visualize.py without cv2: the pose overlays of
cli visualize and cli browse (projected points, object axes, the contour
of a rendered mask, 2D keypoints with their box wireframe, a grid of
panels), drawn by drawing.py and imops.fill_circle pixel for pixel as
cv2 draws them, BGR uint8 in and out; and the TensorBoard panels' mmcv
flow colour wheel and the reference's forward splat of an image by a
flow."""

from typing import Sequence

import numpy as np

from scflow_tpu_torch.datasets.pipelines.imops import fill_circle, hsv2bgr
from scflow_tpu_torch.drawing import draw_contours, find_contours_external, line
from scflow_tpu_torch.host_geometry import project_3d_point


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


def imshow_projected_points(img, points_3d, K, R, t, color=(0, 255, 0), radius: int = 1):
    """Draw mesh points projected under a pose (filled circles, the
    points whose truncated pixel lies in the image)."""
    out = np.ascontiguousarray(img.copy())
    pts = project_3d_point(points_3d, K, R, t)
    h, w = out.shape[:2]
    for x, y in pts.astype(int):
        if 0 <= x < w and 0 <= y < h:
            fill_circle(out, (int(x), int(y)), radius, color)
    return out


def imshow_pose_axis(img, K, R, t, axis_len: float = 80.0, thickness: int = 2):
    """Draw the object frame's axes (x red, y green, z blue, BGR) from the
    projected origin, each end point truncated to int."""
    out = np.ascontiguousarray(img.copy())
    origin_axes = np.array(
        [[0, 0, 0], [axis_len, 0, 0], [0, axis_len, 0], [0, 0, axis_len]],
        np.float32,
    )
    pts = project_3d_point(origin_axes, K, R, t).astype(int)
    colors = [(0, 0, 255), (0, 255, 0), (255, 0, 0)]  # BGR
    for i, c in enumerate(colors):
        line(out, tuple(pts[0]), tuple(pts[i + 1]), c, thickness)
    return out


def imshow_pose_contour(img, mask: np.ndarray, color=(0, 255, 0), thickness=2):
    """Overlay the outer contour of a rendered mask (mask > 0)."""
    out = np.ascontiguousarray(img.copy())
    contours = find_contours_external((mask > 0).astype(np.uint8))
    draw_contours(out, contours, color, thickness)
    return out


def imshow_2d_keypoints(img, keypoints_2d, color=(255, 0, 0), radius=3, connect_box=True):
    """Draw 2D keypoints; 8 of them are also joined as a 3D box's
    wireframe (collect_3d_keypoints' corner order: x-major binary)."""
    out = np.ascontiguousarray(img.copy())
    kps = np.asarray(keypoints_2d).astype(int)
    for x, y in kps:
        fill_circle(out, (int(x), int(y)), radius, color)
    if connect_box and len(kps) == 8:
        edges = [
            (0, 1), (0, 2), (3, 1), (3, 2),
            (4, 5), (4, 6), (7, 5), (7, 6),
            (0, 4), (1, 5), (2, 6), (3, 7),
        ]
        for a, b in edges:
            line(out, tuple(kps[a]), tuple(kps[b]), color, 1)
    return out


def make_grid(images: Sequence[np.ndarray], cols: int = 4, pad: int = 2) -> np.ndarray:
    """Tile images (all H x W x 3) into a grid, `pad` black pixels after
    each row and column."""
    n = len(images)
    cols = min(cols, n)
    rows = (n + cols - 1) // cols
    h, w = images[0].shape[:2]
    grid = np.zeros((rows * (h + pad), cols * (w + pad), 3), images[0].dtype)
    for i, img in enumerate(images):
        r, c = divmod(i, cols)
        grid[r * (h + pad): r * (h + pad) + h, c * (w + pad): c * (w + pad) + w] = img
    return grid


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
