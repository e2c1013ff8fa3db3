"""Batched PnP on tensors: weighted DLT, a planar homography solve,
Gauss-Newton refinement and fixed-size RANSAC.  Port of
scflow_tpu/geometry/pnp.py (pnp_dlt, pnp_planar, refine_gauss_newton,
solve_pnp_ransac_jax, here solve_pnp_ransac_device, and PnPResult), with
JAX's vmap turned into leading batch dimensions: every function takes
(..., P, 3) points.  The small eigh / svd / solve calls are torch.linalg,
as JAX leaves them to its linear algebra.  Also the port's copy of
scflow_tpu/geometry/host.py::solve_pnp_ransac (cv2's RANSAC-EPnP on the
host), on cv_pnp.py's numpy rebuild of cv2's solver: no cv2.

The RANSAC core, `ransac_from_indices`, takes the hypotheses' point
indices (N, H, S); `sample_hypotheses` draws them (gumbel top-k over the
valid points, as JAX does, from a torch.Generator), so that a test can
feed both packages the same draws.
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from scflow_tpu_torch import cv_pnp
from scflow_tpu_torch.geometry import axis_angle_from_rotmat, rotmat_from_axis_angle

_EPS = 1e-12


class PnPResult(NamedTuple):
    rotation: torch.Tensor  # (..., 3, 3)
    translation: torch.Tensor  # (..., 3)
    inliers: torch.Tensor  # (..., P) bool
    ok: torch.Tensor  # (...,) bool


def _normalize_points(points_2d: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixels (..., P, 2) -> normalized camera-plane coordinates by K^-1."""
    homo = torch.cat([points_2d, torch.ones_like(points_2d[..., :1])], dim=-1)
    return torch.einsum("...ij,...pj->...pi", torch.linalg.inv(K), homo)[..., :2]


def _weights(points_3d: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.ones_like(points_3d[..., 0]) if weights is None else weights


def _diag_det(det: torch.Tensor) -> torch.Tensor:
    """diag(1, 1, det) for a batch of determinants (...,)."""
    one = torch.ones_like(det)
    return torch.diag_embed(torch.stack([one, one, det], dim=-1))


def _dlt_rows(X: torch.Tensor, xn: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 2P rows [X, 0, -u X] and [0, X, -v X], scaled by w (..., P, 1)."""
    zeros = torch.zeros_like(X)
    u, v = xn[..., 0:1], xn[..., 1:2]
    row_u = torch.cat([X, zeros, -u * X], dim=-1) * w
    row_v = torch.cat([zeros, X, -v * X], dim=-1) * w
    return torch.cat([row_u, row_v], dim=-2)


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """The eigenvector of A^T A with the smallest eigenvalue, in A's dtype
    (its sign is the solver's; callers fix it).  Formed and solved in
    float64 whatever A's dtype: the normal matrix of a 6-point minimal
    sample in millimetres squares A's condition number, and a float32
    eigh of it returns noise for the smallest eigenvector (64 RANSAC
    problems of 64 hypotheses, 30% outliers: 2 poses wrong with LAPACK on
    the CPU, 4 others with cuSOLVER's batched Jacobi on an H100).  JAX's
    function solves in float32 (a documented difference, ROADMAP §3)."""
    A64 = A.to(torch.float64)
    return torch.linalg.eigh(A64.transpose(-1, -2) @ A64)[1][..., :, 0].to(A.dtype)


def pnp_dlt(points_3d: torch.Tensor, points_2d: torch.Tensor, K: torch.Tensor,
            weights: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct linear transform for [R|t] from >= 6 points (..., P, 3) and
    pixels (..., P, 2), weights (..., P) >= 0: the null vector of the 2P x
    12 system in normalized coordinates, its sign set so that the weighted
    majority of depths is positive, the 3x3 part projected onto SO(3) and
    the scale taken from its singular values."""
    xn = _normalize_points(points_2d, K)
    weights = _weights(points_3d, weights)
    w = torch.sqrt(torch.clamp(weights, min=0.0))[..., None]
    X = torch.cat([points_3d, torch.ones_like(points_3d[..., :1])], dim=-1)
    m = _null_vector(_dlt_rows(X, xn, w)).reshape(points_3d.shape[:-2] + (3, 4))
    M, tvec = m[..., :3], m[..., 3]
    depths = torch.einsum("...pj,...j->...p", points_3d, M[..., 2, :]) + tvec[..., 2:3]
    neg = torch.sum(torch.sign(depths) * weights, dim=-1) < 0
    sign = torch.where(neg, -1.0, 1.0).to(M.dtype)
    M = M * sign[..., None, None]
    tvec = tvec * sign[..., None]
    U, S, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    R = U @ _diag_det(det) @ Vt
    scale = torch.mean(S, dim=-1) * det
    scale = torch.where(torch.abs(scale) > 1e-12, scale, torch.full_like(scale, 1e-12))
    t = tvec / scale[..., None]
    return R, t


def pnp_planar(points_3d: torch.Tensor, points_2d: torch.Tensor, K: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pose of a (near-)planar point set: weighted plane fit (PCA), the
    plane -> image homography by DLT, decomposed into [R|t] (Zhang / IPPE
    style).  The complement of pnp_dlt, whose system is rank-deficient on
    coplanar points.  Invariant to the signs eigh gives its vectors: a
    flipped plane axis flips the matching homography column, and the two
    flips cancel in R; the homography's own sign is set by the centroid's
    depth."""
    xn = _normalize_points(points_2d, K)
    w = torch.clamp(_weights(points_3d, weights), min=0.0)
    wsum = torch.clamp(w.sum(dim=-1), min=1e-8)
    c = (points_3d * w[..., None]).sum(dim=-2) / wsum[..., None]
    X = points_3d - c[..., None, :]
    cov = (X * w[..., None]).transpose(-1, -2) @ X / wsum[..., None, None]
    evecs = torch.linalg.eigh(cov)[1]  # ascending: column 0 is the normal
    e1, e2 = evecs[..., :, 2], evecs[..., :, 1]
    q = torch.stack([torch.einsum("...pj,...j->...p", X, e1),
                     torch.einsum("...pj,...j->...p", X, e2)], dim=-1)
    Q = torch.cat([q, torch.ones_like(q[..., :1])], dim=-1)
    H = _null_vector(_dlt_rows(Q, xn, torch.sqrt(w)[..., None])).reshape(
        points_3d.shape[:-2] + (3, 3))
    h1, h2, b = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    scale = torch.sqrt(torch.clamp(torch.linalg.norm(h1, dim=-1) * torch.linalg.norm(h2, dim=-1),
                                   min=1e-12))[..., None]
    sign = torch.where(b[..., 2:3] < 0, -1.0, 1.0).to(H.dtype)
    a1, a2, b = h1 * sign / scale, h2 * sign / scale, b * sign / scale
    A_rot = torch.stack([a1, a2, torch.linalg.cross(a1, a2, dim=-1)], dim=-1)
    U, _, Vt = torch.linalg.svd(A_rot)
    A_rot = U @ _diag_det(torch.linalg.det(U @ Vt)) @ Vt
    E = torch.stack([e1, e2, torch.linalg.cross(e1, e2, dim=-1)], dim=-1)
    R = A_rot @ E.transpose(-1, -2)
    t = b - torch.einsum("...ij,...j->...i", R, c)
    return R, t


def _skew_apply(a: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """a (..., 3) x X (..., P, 3)."""
    return torch.linalg.cross(a[..., None, :].expand_as(X), X, dim=-1)


def _residual_and_jacobian(rvec, t, points_3d, xn, wr):
    """The weighted normalized reprojection residual (..., 2P), entries
    (x0, y0, x1, ...), and its Jacobian (..., 2P, 6) in (rvec, t): the
    derivative of JAX's expressions (Rodrigues through axis rvec /
    max(|rvec|, 1e-12), the depth floored at 1e-8) written out, which
    jax.jacfwd takes there."""
    R = rotmat_from_axis_angle(rvec)
    cam = torch.einsum("...ij,...pj->...pi", R, points_3d) + t[..., None, :]
    keep = torch.abs(cam[..., 2]) > 1e-8
    z = torch.where(keep, cam[..., 2], torch.full_like(cam[..., 2], 1e-8))
    res = (cam[..., :2] / z[..., None] - xn).flatten(-2) * wr

    theta = torch.linalg.norm(rvec, dim=-1, keepdim=True)
    big = theta > _EPS
    th = torch.clamp(theta, min=_EPS)
    a = rvec / th
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    da = torch.where(big[..., None], (eye - a[..., :, None] * a[..., None, :]) / th[..., None],
                     eye / th[..., None])  # da[..., i, k] = d a_i / d r_k
    s, c1 = torch.sin(theta)[..., None], (1 - torch.cos(theta))[..., None]
    cos = torch.cos(theta)[..., None]
    aX = _skew_apply(a, points_3d)
    aaX = _skew_apply(a, aX)
    cols = []
    for k in range(3):
        dak = da[..., :, k]
        ak = a[..., k, None, None]
        dakX = _skew_apply(dak, points_3d)
        cols.append(cos * ak * aX + s * dakX + s * ak * aaX
                    + c1 * (_skew_apply(dak, aX) + _skew_apply(a, dakX)))
    # d cam / d (rvec, t): (..., P, 3, 6)
    dcam = torch.cat([torch.stack(cols, dim=-1), eye.expand(cam.shape + (3,))], dim=-1)
    # d(c_xy / z): through z only where the floor is off
    dz = dcam[..., 2, :] * keep[..., None].to(cam.dtype)
    dproj = (dcam[..., :2, :] / z[..., None, None]
             - (cam[..., :2, None] / (z * z)[..., None, None]) * dz[..., None, :])
    J = dproj.flatten(-3, -2) * wr[..., None]
    return res, J


def refine_gauss_newton(R: torch.Tensor, t: torch.Tensor, points_3d: torch.Tensor,
                        points_2d: torch.Tensor, K: torch.Tensor,
                        weights: Optional[torch.Tensor] = None, iters: int = 8,
                        damping: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Levenberg-damped Gauss-Newton on the normalized reprojection error,
    in axis-angle and translation, from (R, t): `iters` steps of
    delta = (J^T J + damping I)^-1 J^T r."""
    xn = _normalize_points(points_2d, K)
    wr = torch.sqrt(torch.clamp(torch.repeat_interleave(_weights(points_3d, weights), 2, dim=-1),
                                min=0.0))
    rvec = axis_angle_from_rotmat(R)
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        res, J = _residual_and_jacobian(rvec, t, points_3d, xn, wr)
        Jt = J.transpose(-1, -2)
        delta = torch.linalg.solve(Jt @ J + damping * eye6, (Jt @ res[..., None]))[..., 0]
        rvec, t = rvec - delta[..., :3], t - delta[..., 3:]
    return rotmat_from_axis_angle(rvec), t


def _reproj_err_px(R, t, points_3d, points_2d, K):
    """Pixel reprojection error (..., P) of the points under (R, t)."""
    cam = torch.einsum("...ij,...pj->...pi", R, points_3d) + t[..., None, :]
    z = torch.where(torch.abs(cam[..., 2]) > 1e-8, cam[..., 2], torch.full_like(cam[..., 2], 1e-8))
    proj = torch.einsum("...ij,...pj->...pi", K, cam)[..., :2] / z[..., None]
    return torch.linalg.norm(proj - points_2d, dim=-1)


def _best_of_both(p3, p2, K, weights, points_3d, points_2d, score_on):
    """pnp_dlt and pnp_planar side by side on (p3, p2); keep the one whose
    median pixel error over the points in score_on (the fitted support) is
    lower, DLT on a tie.  The median is JAX's: errors outside score_on and
    NaNs at 1e9, sorted, the entry at score_on.sum() // 2."""
    R_g, t_g = pnp_dlt(p3, p2, K, weights)
    R_p, t_p = pnp_planar(p3, p2, K, weights)

    def med_err(R, t):
        err = _reproj_err_px(R, t, points_3d, points_2d, K)
        big = torch.full_like(err, 1e9)
        err = torch.where(score_on, torch.nan_to_num(err, nan=1e9), big)
        k = score_on.sum(dim=-1, keepdim=True) // 2
        return torch.sort(err, dim=-1).values.gather(-1, k.expand(err.shape[:-1] + (1,)))[..., 0]

    pick_g = med_err(R_g, t_g) <= med_err(R_p, t_p)
    return (torch.where(pick_g[..., None, None], R_g, R_p),
            torch.where(pick_g[..., None], t_g, t_p))


def hypothesis_uniforms(n: int, num_hypotheses: int, p: int, device=None) -> torch.Tensor:
    """The (N, H, P) uniforms solve_pnp_ransac_device draws by default: from
    a fresh torch.Generator on `device` seeded 0."""
    generator = torch.Generator(device=device).manual_seed(0)
    return torch.rand((n, num_hypotheses, p), generator=generator, device=device)


def sample_hypotheses(valid: torch.Tensor, num_hypotheses: int = 64, sample_size: int = 6,
                      generator: Optional[torch.Generator] = None,
                      uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, P) bool -> (N, H, S) point indices: per hypothesis, the top
    sample_size of gumbel noise with -1e9 on invalid points (drawing without
    replacement among the valid ones), as JAX's sampler does.  The sort is
    stable, so a tie takes the lower index first, as jax.lax.top_k does.
    uniforms: the (N, H, P) draws, drawn beforehand; else they are drawn
    from `generator`."""
    n, p = valid.shape
    u = uniforms
    if u is None:
        u = torch.rand((n, num_hypotheses, p), generator=generator, device=valid.device)
    u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
    g = -torch.log(-torch.log(u)) + torch.where(valid, 0.0, -1e9)[:, None, :]
    return torch.sort(g, dim=-1, descending=True, stable=True).indices[..., :sample_size]


def ransac_from_indices(points_3d: torch.Tensor, points_2d: torch.Tensor, K: torch.Tensor,
                        valid: torch.Tensor, idxs: torch.Tensor, inlier_thresh_px: float = 3.0,
                        refine_iters: int = 8) -> PnPResult:
    """RANSAC-PnP on given hypotheses: points (N, P, 3) and (N, P, 2), K (N,
    3, 3), valid (N, P), idxs (N, H, S).  Each hypothesis solves both ways
    on its S points (the median error over all valid points picks); the
    one with the most pixel inliers (the first on a tie) is refitted on its
    inliers (weighted, both ways) and refined by Gauss-Newton.  ok: at
    least S inliers for the best hypothesis and a finite pose."""
    n, h, s = idxs.shape
    take = idxs.reshape(n, h * s, 1)
    p3 = points_3d.gather(1, take.expand(-1, -1, 3)).reshape(n, h, s, 3)
    p2 = points_2d.gather(1, take.expand(-1, -1, 2)).reshape(n, h, s, 2)
    Kh = K[:, None].expand(n, h, 3, 3)
    all3, all2 = points_3d[:, None], points_2d[:, None]
    Rs, ts = _best_of_both(p3, p2, Kh, None, all3, all2, valid[:, None])
    inls = (_reproj_err_px(Rs, ts, all3, all2, Kh) < inlier_thresh_px) & valid[:, None]
    scores = inls.sum(dim=-1)
    best = torch.argmax(scores, dim=-1)  # the first maximum, as jnp.argmax
    rows = torch.arange(n, device=idxs.device)
    inl_best = inls[rows, best]
    enough = scores[rows, best] >= s
    w = inl_best.to(points_3d.dtype)
    R_fit, t_fit = _best_of_both(points_3d, points_2d, K, w, points_3d, points_2d,
                                 (w > 0) & valid)
    R_ref, t_ref = refine_gauss_newton(R_fit, t_fit, points_3d, points_2d, K, weights=w,
                                       iters=refine_iters)
    inliers = (_reproj_err_px(R_ref, t_ref, points_3d, points_2d, K) < inlier_thresh_px) & valid
    finite = torch.isfinite(t_ref).all(dim=-1) & torch.isfinite(R_ref).flatten(-2).all(dim=-1)
    return PnPResult(R_ref, t_ref, inliers, enough & finite)


def solve_pnp_ransac_device(points_3d: torch.Tensor, points_2d: torch.Tensor, K: torch.Tensor,
                            valid: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None,
                            num_hypotheses: int = 64, sample_size: int = 6,
                            inlier_thresh_px: float = 3.0, refine_iters: int = 8,
                            uniforms: Optional[torch.Tensor] = None) -> PnPResult:
    """Fixed-shape RANSAC-PnP on padded point sets, batched: points (N, P,
    3) and (N, P, 2), K (N, 3, 3), valid (N, P) bool (all by default); or
    one set without the N.  The port of solve_pnp_ransac_jax (and of its
    vmap, batched_pnp_ransac); `generator` (a torch.Generator on the
    points' device, seeded 0 by default) takes the place of the PRNG key.
    uniforms: the hypotheses' (N, H, P) draws made beforehand
    (hypothesis_uniforms), in place of drawing them from `generator`."""
    single = points_3d.ndim == 2
    if single:
        points_3d, points_2d, K = points_3d[None], points_2d[None], K[None]
        valid = None if valid is None else valid[None]
    if valid is None:
        valid = torch.ones(points_3d.shape[:2], dtype=torch.bool, device=points_3d.device)
    if uniforms is None and generator is None:
        uniforms = hypothesis_uniforms(valid.shape[0], num_hypotheses, valid.shape[1],
                                       points_3d.device)
    idxs = sample_hypotheses(valid, num_hypotheses, sample_size, generator, uniforms)
    res = ransac_from_indices(points_3d, points_2d, K, valid, idxs, inlier_thresh_px,
                              refine_iters)
    return PnPResult(*(v[0] for v in res)) if single else res


def solve_pnp_ransac(points_3d, points_2d, K, reprojection_error: float = 3.0,
                     iterations: int = 100):
    """cv2.solvePnPRansac with EPnP on the host (numpy in, float64 inside),
    as cv_pnp.py rebuilds it without cv2: (R (3, 3), t (3,), True) as
    float32, or (None, None, False) on fewer than 4 points, a failed solve
    or a NaN pose."""
    return cv_pnp.solve_pnp_ransac(points_3d, points_2d, K, reprojection_error, iterations)
