"""Host-side (numpy) pose utilities of the data pipeline and the
evaluation: the port's copy of scflow_tpu/geometry/host.py
(reference datasets/pose.py:18-119) without cv2.  remap_pose solves its
PnP with the port's own float64 DLT (pnp.py) and a Levenberg-Marquardt
refinement on the keypoints' projections (refine_pose_lm), where the JAX package calls cv2's
EPnP; the host RANSAC (pnp.solve_pnp_ransac, cv2's RANSAC-EPnP rebuilt in
numpy by cv_pnp.py) stays with pnp.py."""

import numpy as np


def project_3d_point(pt3d, K, rotation, translation, transform_matrix=None,
                     return_3d=False):
    """(V, 3) mesh points -> 2D projections under K, R, t (single or batched
    over the leading axis of K/R/t)."""
    single = rotation.ndim == 2
    R = rotation[None] if single else rotation
    t = np.asarray(translation).reshape(-1, 3) if single else np.asarray(translation).reshape(len(rotation), 3)
    Kb = K[None] if K.ndim == 2 else K
    cam = np.einsum("nij,vj->nvi", R, pt3d) + t[:, None]
    uvw = np.einsum("nij,nvj->nvi", Kb, cam)
    if transform_matrix is not None:
        Tm = transform_matrix[None] if transform_matrix.ndim == 2 else transform_matrix
        uvw = np.einsum("nij,nvj->nvi", Tm, uvw)
    xy = uvw[..., :2] / (uvw[..., 2:3] + 1e-8)
    if single:
        xy, cam = xy[0], cam[0]
    if return_3d:
        return xy, cam
    return xy


def _rodrigues(v: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(v))
    k = np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]])
    if theta < 1e-12:
        return np.eye(3) + k
    k /= theta
    return np.eye(3) + np.sin(theta) * k + (1.0 - np.cos(theta)) * (k @ k)


def refine_pose_lm(R, t, pt3d, pt2d, K, iters: int = 100):
    """Levenberg-Marquardt on the summed squared pixel error of the points
    under K (R p + t), float64, with the exact Jacobian of a rotation
    increment applied on the left (R <- exp([d]x) R): quadratic convergence
    from a DLT start, where pnp.refine_gauss_newton, built for RANSAC's
    near-exact starts, converges linearly."""
    X = np.asarray(pt3d, np.float64)
    x = np.asarray(pt2d, np.float64)
    K = np.asarray(K, np.float64)
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)

    def residual(R, t):
        uvw = (X @ R.T + t) @ K.T
        return (uvw[:, :2] / uvw[:, 2:] - x).ravel()

    cost, lam = float(residual(R, t) @ residual(R, t)), 1e-3
    for _ in range(iters):
        P = X @ R.T + t
        uvw = P @ K.T
        proj = uvw[:, :2] / uvw[:, 2:]
        r = (proj - x).ravel()
        dproj = (K[None, :2, :] - proj[:, :, None] * K[None, 2:3, :]) / uvw[:, 2, None, None]
        RX = P - t
        skew = np.zeros((len(X), 3, 3))
        skew[:, 0, 1], skew[:, 0, 2], skew[:, 1, 2] = -RX[:, 2], RX[:, 1], -RX[:, 0]
        skew[:, 1, 0], skew[:, 2, 0], skew[:, 2, 1] = RX[:, 2], -RX[:, 1], RX[:, 0]
        J = np.concatenate([dproj @ -skew, dproj], axis=2).reshape(-1, 6)
        JtJ, g = J.T @ J, J.T @ r
        while True:
            delta = np.linalg.solve(JtJ + lam * np.diag(np.diag(JtJ)), -g)
            R_new, t_new = _rodrigues(delta[:3]) @ R, t + delta[3:]
            r_new = residual(R_new, t_new)
            new_cost = float(r_new @ r_new)
            if np.isfinite(new_cost) and new_cost <= cost:
                R, t, lam = R_new, t_new, max(lam / 10.0, 1e-12)
                break
            lam *= 10.0
            if lam > 1e12:
                return R, t
        if cost - new_cost <= 1e-15 * max(cost, 1e-30):
            break
        cost = new_cost
    return R, t


def remap_pose(srcK, srcR, srcT, pt3d, dstK, transform_M):
    """Re-solve the pose under a new intrinsic and 2D transform from the
    keypoints pt3d (>= 6, not coplanar: the 8 box corners of the datasets):
    dstK (R_new p + T_new) = transform_M srcK (srcR p + srcT)
    (reference datasets/pose.py:80-104).  Returns (R, T, mean reprojection
    error in pixels).  The JAX package solves it with cv2's EPnP; the port
    with the float64 DLT of pnp.py, then the least-squares pixel error
    (refine_pose_lm), which no pose the EPnP solve returns can beat.  Where
    the transform is not a camera motion (a crop scaled under the same K)
    no pose fits exactly, and the two solves differ (see the tests)."""
    import torch

    from scflow_tpu_torch.pnp import pnp_dlt

    dst_2d = project_3d_point(pt3d, srcK, srcR, srcT, transform_matrix=transform_M)
    R, t = pnp_dlt(*(torch.from_numpy(np.asarray(a, np.float64)) for a in (pt3d, dst_2d, dstK)))
    R, t = refine_pose_lm(R.numpy(), t.numpy(), pt3d, dst_2d, dstK)
    newR = R.astype(np.float32)
    newT = t.astype(np.float32)
    reproj = project_3d_point(pt3d, dstK, newR, newT)
    return newR, newT, float(np.linalg.norm(reproj - dst_2d, axis=1).mean())


def eval_rot_error(gt_r: np.ndarray, pred_r: np.ndarray) -> np.ndarray:
    cos = np.trace(np.matmul(pred_r, np.linalg.inv(gt_r)), axis1=1, axis2=2)
    cos = np.clip(0.5 * (cos - 1.0), -1.0, 1.0)
    return np.degrees(np.arccos(cos))


def eval_tran_error(gt_t: np.ndarray, pred_t: np.ndarray):
    error = np.linalg.norm(gt_t - pred_t, axis=-1)
    error_depth = np.abs(gt_t[:, -1] - pred_t[:, -1])
    error_xy = np.linalg.norm(gt_t[:, :2] - pred_t[:, :2], axis=-1)
    return error, error_depth, error_xy


def remap_pose_to_origin_resolution(
    pred_rotations, pred_translations, internal_k, meta_info
):
    """Remap patch-frame pose predictions back to the original image
    (reference models/utils/pose.py:264-309), one image's objects at a time.

    meta_info: dict with 'geometry_transform_mode', 'transform_matrix',
    'keypoints_3d', optionally 'ori_k'.
    """
    mode = meta_info["geometry_transform_mode"]
    if mode == "adapt_intrinsic":
        return pred_rotations, pred_translations
    tms = np.asarray(meta_info["transform_matrix"])
    inv_tms = np.linalg.inv(tms)
    kp3d = np.asarray(meta_info["keypoints_3d"])
    out_R, out_t = [], []
    for i in range(len(pred_rotations)):
        if mode == "target_intrinsic":
            dstK = np.asarray(meta_info["ori_k"])
        elif mode == "keep_intrinsic":
            dstK = internal_k[i]
        else:
            raise RuntimeError(mode)
        R, t, _ = remap_pose(
            internal_k[i], pred_rotations[i], pred_translations[i], kp3d[i],
            dstK, inv_tms[i],
        )
        out_R.append(R)
        out_t.append(t)
    return np.stack(out_R), np.stack(out_t)
