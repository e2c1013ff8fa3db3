"""Pose and camera geometry of the inference path (batched, on tensors).

Ports of scflow_tpu/geometry: rotation.py::rotmat_from_ortho6d,
se3.py::apply_delta_pose, camera.py::coords_grid and
lift_depth_to_object_points_at, flow.py::flow_from_object_points_at.
Same arithmetic and layouts (pixel grids in (x, y) order, NHWC maps).
"""

from typing import Tuple

import torch

_EPS = 1e-12


def _normalize(v: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    # torch.nn.functional.normalize semantics: v / max(||v||, eps)
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def rotmat_from_ortho6d(o6d: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) by Gram-Schmidt; columns are (x, y, z)."""
    x = _normalize(o6d[..., 0:3])
    z = _normalize(torch.linalg.cross(x, o6d[..., 3:6]))
    y = torch.linalg.cross(z, x)
    return torch.stack([x, y, z], dim=-1)


def apply_delta_pose(
    rotation_delta: torch.Tensor,  # (N, 6) ortho6d
    translation_delta: torch.Tensor,  # (N, 3)
    rotation_src: torch.Tensor,  # (N, 3, 3)
    translation_src: torch.Tensor,  # (N, 3)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """R_dst = dR @ R_src; v_z = t_z / exp(dz); v_xy = v_z (d_xy / 10 +
    t_xy / t_z) — the 'exp' depth transform and weight of the reference.
    Inference only, so the detach options of the JAX version have nothing
    to do."""
    rotation_dst = rotmat_from_ortho6d(rotation_delta) @ rotation_src
    tx, ty, tz = translation_src.unbind(-1)
    dx, dy, dz = translation_delta.unbind(-1)
    vz = tz / torch.exp(dz)
    vx = vz * (dx / 10.0 + tx / tz)
    vy = vz * (dy / 10.0 + ty / tz)
    return rotation_dst, torch.stack([vx, vy, vz], dim=-1)


def coords_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(H, W, 2) grid of pixel coordinates in (x, y) order."""
    ys = torch.arange(h, dtype=dtype, device=device)
    xs = torch.arange(w, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def lift_depth_to_object_points_at(
    depth: torch.Tensor,  # (N, h', w') sampled at pix
    K: torch.Tensor,  # (N, 3, 3)
    R: torch.Tensor,  # (N, 3, 3)
    t: torch.Tensor,  # (N, 3)
    pix: torch.Tensor,  # (h', w', 2) pixel coordinates (x, y)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """X_cam = depth K^-1 [x, y, 1]^T, X_obj = R^T (X_cam - t) at the given
    pixels.  Returns (points_obj (N, h', w', 3), valid (N, h', w') bool)."""
    homo = torch.cat([pix, torch.ones_like(pix[..., :1])], dim=-1)
    rays = torch.einsum("nij,hwj->nhwi", torch.linalg.inv(K), homo)
    points_cam = rays * depth[..., None]
    points_obj = torch.einsum("nji,nhwj->nhwi", R, points_cam - t[:, None, None, :])
    return points_obj, depth > 0


def flow_from_object_points_at(
    points_obj: torch.Tensor,  # (N, h', w', 3)
    valid: torch.Tensor,  # (N, h', w') bool
    R_dst: torch.Tensor,
    t_dst: torch.Tensor,
    K: torch.Tensor,
    pix: torch.Tensor,  # (h', w', 2)
) -> torch.Tensor:
    """Pose-induced flow of the lifted points under (R_dst, t_dst):
    reprojection minus pix, 0 where the depth was empty (the refiner's
    invalid_flow_num)."""
    pts_cam = torch.einsum("nij,nhwj->nhwi", R_dst, points_obj) + t_dst[:, None, None, :]
    uvw = torch.einsum("nij,nhwj->nhwi", K, pts_cam)
    v = valid[..., None]
    z = torch.where(v, uvw[..., 2:3], torch.ones_like(uvw[..., 2:3]))
    flow = uvw[..., :2] / z - pix[None]
    return torch.where(v, flow, torch.zeros_like(flow))
