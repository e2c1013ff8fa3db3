"""Pose, camera and flow geometry (batched, on tensors).

Ports of scflow_tpu/geometry: rotation.py::rotmat_from_ortho6d,
rotmat_from_quat, quat_from_rotmat, rotmat_from_euler, rotmat_from_axis_angle
and axis_angle_from_rotmat, se3.py::apply_delta_pose,
camera.py::coords_grid, project_points and lift_depth_to_object_points(_at),
flow.py::flow_from_object_points(_at), flow_from_pose_and_depth,
flow_to_coords, filter_flow_by_mask, filter_flow_by_depth,
filter_flow_by_face_index and cal_epe.  Same arithmetic and layouts (pixel
grids in (x, y) order, NHWC maps).
"""

from typing import Dict, Optional, Tuple

import torch

from scflow_tpu_torch.ops.sampling import grid_sample

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


def rotmat_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Scalar-last quaternion (x, y, z, w), normalized first -> rotation
    matrix, (..., 4) -> (..., 3, 3)."""
    x, y, z, w = _normalize(q).unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
                     2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
                     2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_from_rotmat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> scalar-last quaternion (x, y, z, w),
    branchless, as the JAX function: each component's magnitude from the
    diagonal, the vector's signs from the skew part, then normalized."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp(1 + tr, min=0.0)) / 2
    qx = torch.sqrt(torch.clamp(1 + m00 - m11 - m22, min=0.0)) / 2
    qy = torch.sqrt(torch.clamp(1 - m00 + m11 - m22, min=0.0)) / 2
    qz = torch.sqrt(torch.clamp(1 - m00 - m11 + m22, min=0.0)) / 2
    qx = torch.copysign(qx, m21 - m12)
    qy = torch.copysign(qy, m02 - m20)
    qz = torch.copysign(qz, m10 - m01)
    return _normalize(torch.stack([qx, qy, qz, qw], dim=-1))


def rotmat_from_euler(angles: torch.Tensor, order: str = "xyz",
                      degrees: bool = False) -> torch.Tensor:
    """Euler angles (..., 3) -> rotation (..., 3, 3), extrinsic axes applied
    in `order` (later axes multiply from the left): scipy's
    Rotation.from_euler(order) for lower-case orders."""
    if degrees:
        angles = torch.deg2rad(angles)

    def axis_rot(axis, a):
        c, s = torch.cos(a), torch.sin(a)
        o, i = torch.zeros_like(a), torch.ones_like(a)
        if axis == "x":
            rows = [i, o, o, o, c, -s, o, s, c]
        elif axis == "y":
            rows = [c, o, s, o, i, o, -s, o, c]
        else:
            rows = [c, -s, o, s, c, o, o, o, i]
        return torch.stack(rows, dim=-1).reshape(a.shape + (3, 3))

    R = None
    for idx, ax in enumerate(order):
        Ri = axis_rot(ax, angles[..., idx])
        R = Ri if R is None else Ri @ R
    return R


def rotmat_from_axis_angle(rvec: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation (..., 3, 3), in the JAX
    function's form, I + sin(t) K + (1 - cos(t)) K^2 with the axis
    rvec / max(t, 1e-12), so that t -> 0 gives I."""
    theta = torch.linalg.norm(rvec, dim=-1, keepdim=True)
    axis = rvec / torch.clamp(theta, min=_EPS)
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    K = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1).reshape(
        rvec.shape[:-1] + (3, 3))
    t = theta[..., None]
    return torch.eye(3, dtype=rvec.dtype, device=rvec.device) + torch.sin(t) * K + (
        1 - torch.cos(t)) * (K @ K)


def axis_angle_from_rotmat(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues (..., 3, 3) -> (..., 3), the JAX function's branch
    formulas: theta = arccos((tr R - 1) / 2) clipped to [-1, 1], the skew
    part scaled by theta / (2 sin theta) where sin theta > 1e-6, else by
    0.5 (the small-angle limit; near theta = pi the skew part vanishes and
    so does the vector, as in JAX)."""
    cos = torch.clamp((R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2, -1.0, 1.0)
    theta = torch.arccos(cos)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin = torch.sin(theta)[..., None]
    scale = torch.where(sin > 1e-6, theta[..., None] / torch.clamp(2 * sin, min=_EPS),
                        torch.full_like(sin, 0.5))
    return v * scale


DEPTH_TRANSFORMS = ("exp", "linear")


def check_depth_transform(name: str) -> str:
    """The JAX function reads every name but 'exp' as 'linear'; here any
    other than the two raises."""
    if name not in DEPTH_TRANSFORMS:
        raise ValueError(f"unknown depth_transform {name!r}; expected one of "
                         f"{DEPTH_TRANSFORMS}")
    return name


def apply_delta_pose(
    rotation_delta: torch.Tensor,  # (N, 6) ortho6d or (N, 4) scalar-last quaternion
    translation_delta: torch.Tensor,  # (N, 3)
    rotation_src: torch.Tensor,  # (N, 3, 3)
    translation_src: torch.Tensor,  # (N, 3)
    weight: float = 10.0,
    depth_transform: str = "exp",
    detach_depth_for_xy: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """R_dst = dR @ R_src, dR from the ortho6d delta (Gram-Schmidt) or the
    quaternion one (rotmat_from_quat); v_z = t_z / exp(dz) ('exp', the
    shipped configuration's) or t_z (dz + 1) ('linear'); v_xy = v_z (d_xy /
    weight + t_xy / t_z).  detach_depth_for_xy stops v_z's gradient in the
    x/y terms (the shipped configuration sets it).  Any other
    depth_transform raises (check_depth_transform)."""
    check_depth_transform(depth_transform)
    if rotation_delta.shape[-1] == 4:
        dR = rotmat_from_quat(rotation_delta)
    else:
        dR = rotmat_from_ortho6d(rotation_delta)
    rotation_dst = dR @ rotation_src
    tx, ty, tz = translation_src.unbind(-1)
    dx, dy, dz = translation_delta.unbind(-1)
    vz = tz / torch.exp(dz) if depth_transform == "exp" else tz * (dz + 1.0)
    vz_xy = vz.detach() if detach_depth_for_xy else vz
    vx = vz_xy * (dx / weight + tx / tz)
    vy = vz_xy * (dy / weight + ty / tz)
    return rotation_dst, torch.stack([vx, vy, vz], dim=-1)


def coords_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(H, W, 2) grid of pixel coordinates in (x, y) order."""
    ys = torch.arange(h, dtype=dtype, device=device)
    xs = torch.arange(w, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def project_points(points: torch.Tensor, K: torch.Tensor, R: Optional[torch.Tensor] = None,
                   t: Optional[torch.Tensor] = None, eps: float = 0.0) -> torch.Tensor:
    """Points (..., P, 3), in the object frame when R (..., 3, 3) and t
    (..., 3) are given, else in the camera's, projected by K (..., 3, 3) to
    pixels (..., P, 2) in (x, y) order: uv / (w + eps)."""
    if R is not None:
        points = torch.einsum("...ij,...pj->...pi", R, points) + t[..., None, :]
    uvw = torch.einsum("...ij,...pj->...pi", K, points)
    return uvw[..., :2] / (uvw[..., 2:3] + eps)


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


def lift_depth_to_object_points(depth: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
                                t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every pixel of depth (N, H, W) lifted into the object frame."""
    h, w = depth.shape[1:]
    return lift_depth_to_object_points_at(depth, K, R, t,
                                          coords_grid(h, w, depth.dtype, depth.device))


def flow_from_object_points_at(
    points_obj: torch.Tensor,  # (N, h', w', 3)
    valid: torch.Tensor,  # (N, h', w') bool
    R_dst: torch.Tensor,
    t_dst: torch.Tensor,
    K: torch.Tensor,
    pix: torch.Tensor,  # (h', w', 2)
    invalid_num: float = 0.0,
) -> torch.Tensor:
    """Pose-induced flow of the lifted points under (R_dst, t_dst):
    reprojection minus pix, invalid_num where the depth was empty (by
    default 0, the refiner's invalid_flow_num, which the decoder uses; the
    JAX function defaults to 400)."""
    pts_cam = torch.einsum("nij,nhwj->nhwi", R_dst, points_obj) + t_dst[:, None, None, :]
    uvw = torch.einsum("nij,nhwj->nhwi", K, pts_cam)
    v = valid[..., None]
    z = torch.where(v, uvw[..., 2:3], torch.ones_like(uvw[..., 2:3]))
    flow = uvw[..., :2] / z - pix[None]
    return torch.where(v, flow, torch.full_like(flow, invalid_num))


def flow_from_object_points(points_obj, valid, R_dst, t_dst, K,
                            invalid_num: float = 400.0) -> torch.Tensor:
    """flow_from_object_points_at on the dense pixel grid: (N, H, W, 2)."""
    h, w = points_obj.shape[1:3]
    return flow_from_object_points_at(points_obj, valid, R_dst, t_dst, K,
                                      coords_grid(h, w, points_obj.dtype, points_obj.device),
                                      invalid_num)


def flow_from_pose_and_depth(R_src, t_src, R_dst, t_dst, depth_src, K,
                             invalid_num: float = 400.0) -> torch.Tensor:
    """Flow from pose (R_src, t_src) to (R_dst, t_dst) of the pixels the
    source depth (N, H, W) covers; invalid_num elsewhere."""
    points_obj, valid = lift_depth_to_object_points(depth_src, K, R_src, t_src)
    return flow_from_object_points(points_obj, valid, R_dst, t_dst, K, invalid_num)


def flow_to_coords(flow: torch.Tensor) -> torch.Tensor:
    """Flow (N, H, W, 2) -> the absolute target coordinates pixel + flow."""
    n, h, w, _ = flow.shape
    return coords_grid(h, w, flow.dtype, flow.device)[None] + flow


def _normalized_grid_from_flow(flow: torch.Tensor) -> torch.Tensor:
    """The [-1, 1] sampling grid at pixel + flow, scaled by 2 / (size - 1)
    whatever align_corners, as the reference's warp.coords_grid
    (models/utils/warp.py:9-28) and the JAX package scale it."""
    n, h, w, _ = flow.shape
    coords = flow_to_coords(flow)
    gx = coords[..., 0] * 2.0 / max(w - 1, 1) - 1.0
    gy = coords[..., 1] * 2.0 / max(h - 1, 1) - 1.0
    return torch.stack([gx, gy], dim=-1)


def filter_flow_by_mask(flow: torch.Tensor, gt_mask: torch.Tensor,
                        invalid_num: float = 400.0, align_corners: bool = False
                        ) -> torch.Tensor:
    """Set to invalid_num the flow (N, H, W, 2) whose target samples the
    target mask (N, H, W) below 0.9 (bilinear), and flow that is already
    invalid.  As the reference (models/utils/flow.py:6-26) and the JAX
    package: the grid is normalized by 2 / (size - 1) and then sampled with
    align_corners (False by default, which shifts the sample by half a
    pixel)."""
    sampled = grid_sample(gt_mask[..., None].to(flow.dtype), _normalized_grid_from_flow(flow),
                          mode="bilinear", padding_mode="zeros",
                          align_corners=align_corners)[..., 0]
    already_invalid = (flow[..., 0] >= invalid_num) & (flow[..., 1] >= invalid_num)
    bad = (sampled < 0.9) | already_invalid
    return torch.where(bad[..., None], torch.full_like(flow, invalid_num), flow)


def filter_flow_by_depth(flow: torch.Tensor, depth1: torch.Tensor, depth0: torch.Tensor,
                         invalid_num: float = 400.0, thr: float = 0.2) -> torch.Tensor:
    """Invalidate the flow (N, H, W, 2) of image 0 whose target's depth in
    image 1, sampled bilinearly (align_corners=True, zeros outside), differs
    from depth0 by thr or more relative to depth0 + 0.1; already invalid flow
    stays invalid.  The JAX function's documented intent (`already_invalid
    | ~consistent`), not the reference's AND, which is a no-op."""
    d1 = torch.where(depth1 > 0, depth1, torch.zeros_like(depth1))
    d0 = torch.where(depth0 > 0, depth0, torch.zeros_like(depth0))
    warped = grid_sample(d1[..., None], _normalized_grid_from_flow(flow), mode="bilinear",
                         padding_mode="zeros", align_corners=True)[..., 0]
    consistent = torch.abs(d0 - warped) / (d0 + 0.1) < thr
    already_invalid = (flow[..., 0] >= invalid_num) & (flow[..., 1] >= invalid_num)
    bad = already_invalid | ~consistent
    return torch.where(bad[..., None], torch.full_like(flow, invalid_num), flow)


def filter_flow_by_face_index(flow: torch.Tensor, face_index1: torch.Tensor,
                              face_index2: torch.Tensor, invalid_num: float = 400.0
                              ) -> torch.Tensor:
    """Invalidate the flow (N, H, W, 2) whose target's face id in
    face_index2 (N, H, W), sampled nearest (align_corners=True; the JAX
    sampler's nearest, ops/sampling.py), differs from the source's in
    face_index1, and flow that is already invalid (models/utils/flow.py:
    47-59).  The ids compare in the flow's dtype, as in JAX."""
    warped = grid_sample(face_index2[..., None].to(flow.dtype), _normalized_grid_from_flow(flow),
                         mode="nearest", padding_mode="zeros", align_corners=True)[..., 0]
    consistent = warped == face_index1.to(flow.dtype)
    already_invalid = (flow[..., 0] >= invalid_num) & (flow[..., 1] >= invalid_num)
    bad = already_invalid | ~consistent
    return torch.where(bad[..., None], torch.full_like(flow, invalid_num), flow)


def cal_epe(flow_tgt: torch.Tensor, flow_pred: torch.Tensor, mask: Optional[torch.Tensor],
            max_flow: float = 400.0, reduction: str = "mean", threshs=(1, 3, 5)):
    """End-point error and the share of valid pixels under each threshold
    (flows (N, H, W, 2); mask (N, H, W) or None; valid: |flow_tgt| <
    max_flow and mask >= 0.5).  reduction 'none': the masked error map;
    'mean': {"mean", "1px", ...} per sample; 'total_mean': over the batch."""
    mag = torch.sqrt(torch.sum(flow_tgt ** 2, dim=-1))
    valid = mag < max_flow
    if mask is not None:
        valid = valid & (mask >= 0.5)
    err = torch.sqrt(torch.sum((flow_tgt - flow_pred) ** 2, dim=-1))
    validf = valid.to(err.dtype)
    if reduction == "none":
        return err * validf
    if reduction == "mean":
        dims = (-1, -2)
    elif reduction == "total_mean":
        dims = tuple(range(err.ndim))
    else:
        raise ValueError(reduction)
    total = validf.sum(dim=dims) + 1e-10
    out: Dict[str, torch.Tensor] = {"mean": (err * validf).sum(dim=dims) / total}
    err_masked = torch.where(valid, err, torch.full_like(err, float("inf")))
    for t in threshs:
        out[f"{t}px"] = (err_masked < t).sum(dim=dims) / total
    return out
