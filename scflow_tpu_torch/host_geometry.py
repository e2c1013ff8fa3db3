"""Host-side (numpy) pose utilities of the data pipeline and the
evaluation: the port's copy of scflow_tpu/geometry/host.py
(reference datasets/pose.py:18-119) without cv2: remap_pose solves its
PnP with cv2's EPnP as cv_pnp.py rebuilds it in numpy; the host RANSAC
(pnp.solve_pnp_ransac, cv2's RANSAC-EPnP from cv_pnp.py) stays with
pnp.py."""

import warnings

import numpy as np

from scflow_tpu_torch.cv_pnp import rodrigues_to_matrix, solve_pnp_epnp


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


def remap_pose(srcK, srcR, srcT, pt3d, dstK, transform_M):
    """Re-solve the pose under a new intrinsic and 2D transform by EPnP on
    the keypoints: dstK (R_new p + T_new) = transform_M srcK (srcR p + srcT)
    (reference datasets/pose.py:80-104).  Returns (R, T, mean reprojection
    error in pixels) as the JAX package's cv2.solvePnP(SOLVEPNP_EPNP) and
    cv2.Rodrigues give them (cv_pnp rebuilds both); where the solve fails,
    warns and returns the source pose with an error of -1.0."""
    dst_2d = project_3d_point(pt3d, srcK, srcR, srcT, transform_matrix=transform_M)
    ok, rvec, tvec = solve_pnp_epnp(np.asarray(pt3d, np.float64).reshape(-1, 3),
                                    dst_2d.reshape(-1, 2).astype(np.float64),
                                    np.asarray(dstK, np.float64))
    if ok:
        newR = rodrigues_to_matrix(rvec).astype(np.float32)
        newT = tvec.reshape(-1).astype(np.float32)
        reproj = project_3d_point(pt3d, dstK, newR, newT)
        return newR, newT, float(np.linalg.norm(reproj - dst_2d, axis=1).mean())
    warnings.warn("Error in pose remapping; keeping source pose")
    return srcR, srcT, -1.0


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
