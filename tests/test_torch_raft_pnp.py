"""The port's PnP (pnp.py) against the JAX package's geometry/pnp.py.

The closed-form solves take the null vector of a normal matrix whose
eigenvalues span many decades.  JAX solves it in float32, where the
smallest eigenvector carries noise far above rounding (on the 3D set here
JAX's float32 DLT is 3.5e-3 in rotation and 0.9 mm off the truth); the
port solves it in float64 whatever the input dtype (pnp._null_vector).
The solves are therefore held to JAX in float64 (both packages,
`jax.enable_x64`), where they agree to 1e-8, and in float32 to the true
pose, at least as close as JAX's.  Gauss-Newton and RANSAC, whose refit
and refinement wash the difference out, are held to JAX in float32;
RANSAC on the same hypothesis indices (drawn by JAX's sampler, since two
RNG streams cannot be compared)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from scflow_tpu.geometry import pnp as jpnp
from scflow_tpu_torch import pnp

from torch_port_helpers import keep_torch_rng  # noqa: F401

P = 200
K = np.array([[572.4, 0, 128], [0, 573.5, 128], [0, 0, 1]], np.float32)
R_GT = Rotation.random(random_state=1).as_matrix().astype(np.float32)
T_GT = np.array([5, -3, 500], np.float32)


def _project(X):
    cam = X @ R_GT.T + T_GT
    uvw = cam @ K.T
    return (uvw[:, :2] / uvw[:, 2:]).astype(np.float32)


def _sets():
    """A 3D point set, a coplanar one (z = 0 in the object frame), their
    pixels, pixels with 30% outliers, and weights with a fifth at 0."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-50, 50, (P, 3)).astype(np.float32)
    Xp = X.copy()
    Xp[:, 2] = 0.0
    x = _project(X)
    noisy = x.copy()
    out = rng.random(P) < 0.3
    noisy[out] += rng.uniform(-40, 40, (out.sum(), 2)).astype(np.float32)
    w = (rng.random(P) > 0.2).astype(np.float32)
    return dict(X=X, x=x, Xp=Xp, xp=_project(Xp), noisy=noisy, w=w)


def _rot_err(R):
    return float(np.abs(R - R_GT).max())


@pytest.mark.parametrize("fn,plane", [("pnp_dlt", False), ("pnp_planar", False),
                                      ("pnp_planar", True)])
def test_closed_form_solves_match_jax_in_float64(fn, plane):
    """Weighted, on pixels with outliers (so the fit is not exact): R and t
    of both packages in float64 within 1e-8 (rotation) and 1e-6 mm.  DLT
    is not run on the coplanar set, where its null space is 4-dimensional
    and any basis is a solution."""
    s = _sets()
    X, x = (s["Xp"], s["xp"]) if plane else (s["X"], s["noisy"])
    with jax.enable_x64():
        Rj, tj = getattr(jpnp, fn)(*(jnp.asarray(a, jnp.float64) for a in (X, x, K, s["w"])))
        Rj, tj = np.asarray(Rj), np.asarray(tj)
    Rt, tt = getattr(pnp, fn)(*(torch.from_numpy(a.astype(np.float64)) for a in (X, x, K, s["w"])))
    assert Rt.dtype == torch.float64
    np.testing.assert_allclose(Rt.numpy(), Rj, atol=1e-8)
    np.testing.assert_allclose(tt.numpy(), tj, atol=1e-6)


@pytest.mark.parametrize("fn,plane", [("pnp_dlt", False), ("pnp_planar", True)])
def test_closed_form_solves_recover_the_pose_in_float32(fn, plane):
    """float32 on exact pixels (DLT on the 3D set, the planar solve on the
    coplanar one): within 1e-5 (rotation) and 1e-3 mm of the truth, and
    no further from it than JAX's float32 solve."""
    s = _sets()
    X, x = (s["Xp"], s["xp"]) if plane else (s["X"], s["x"])
    R, t = getattr(pnp, fn)(*map(torch.from_numpy, (X, x, K)))
    Rj, tj = (np.asarray(a) for a in getattr(jpnp, fn)(*map(jnp.asarray, (X, x, K))))
    err, t_err = _rot_err(R.numpy()), np.abs(t.numpy() - T_GT).max()
    assert err < 1e-5 and t_err < 1e-3
    assert err <= _rot_err(Rj) and t_err <= np.abs(tj - T_GT).max()


def test_planar_solve_ignores_eigenvector_signs(monkeypatch):
    """cuSOLVER and LAPACK may return any sign for each eigenvector: with
    every column flipped, or the plane axes alone, the planar solve gives
    the same pose (float64, atol 1e-9), as does DLT (its null vector's sign
    is set by the depths)."""
    s = _sets()
    args = [torch.from_numpy(a.astype(np.float64)) for a in (s["Xp"], s["xp"], K, s["w"])]
    args3 = [torch.from_numpy(a.astype(np.float64)) for a in (s["X"], s["noisy"], K, s["w"])]
    base = pnp.pnp_planar(*args), pnp.pnp_dlt(*args3)
    eigh = torch.linalg.eigh
    for flips in ([-1.0], [1.0, -1.0, 1.0], [1.0, 1.0, -1.0]):
        def flipped(a, flips=flips):
            vals, vecs = eigh(a)
            f = torch.ones(a.shape[-1], dtype=a.dtype)
            f[:len(flips)] = torch.tensor(flips, dtype=a.dtype)
            return vals, vecs * (f if len(flips) > 1 else -f)

        monkeypatch.setattr(torch.linalg, "eigh", flipped)
        got = pnp.pnp_planar(*args), pnp.pnp_dlt(*args3)
        for (R0, t0), (R1, t1) in zip(base, got):
            np.testing.assert_allclose(R1.numpy(), R0.numpy(), atol=1e-9)
            np.testing.assert_allclose(t1.numpy(), t0.numpy(), atol=1e-7)


def test_gauss_newton_jacobian_is_the_residuals_derivative():
    """The written-out Jacobian against torch.autograd's of the same
    residual, float64, to 1e-12."""
    from torch.autograd.functional import jacobian

    from scflow_tpu_torch.geometry import rotmat_from_axis_angle

    g = torch.Generator().manual_seed(0)
    rvec = torch.randn(3, 3, generator=g, dtype=torch.float64)
    t = torch.randn(3, 3, generator=g, dtype=torch.float64) + torch.tensor([0, 0, 10.0])
    X = torch.randn(3, 7, 3, generator=g, dtype=torch.float64)
    xn = 0.1 * torch.randn(3, 7, 2, generator=g, dtype=torch.float64)
    wr = torch.rand(3, 14, generator=g, dtype=torch.float64)
    res, J = pnp._residual_and_jacobian(rvec, t, X, xn, wr)

    def f(r, tt):
        cam = torch.einsum("...ij,...pj->...pi", rotmat_from_axis_angle(r), X) + tt[:, None]
        return (cam[..., :2] / cam[..., 2:] - xn).flatten(-2) * wr

    Jr, Jt = jacobian(f, (rvec, t))
    want = torch.cat([torch.stack([Jr[b, :, b] for b in range(3)]),
                      torch.stack([Jt[b, :, b] for b in range(3)])], dim=-1)
    torch.testing.assert_close(J, want, atol=1e-12, rtol=0)
    torch.testing.assert_close(res, f(rvec, t), atol=0, rtol=0)


def test_refine_gauss_newton_matches_jax():
    """8 weighted steps from a perturbed pose, float32: R within 1e-6, t
    within 1e-3 mm of JAX's, and both on the truth within 1e-3 mm."""
    s = _sets()
    R0 = (Rotation.from_rotvec([0.05, -0.02, 0.03]) * Rotation.from_matrix(R_GT)).as_matrix()
    R0 = R0.astype(np.float32)
    t0 = T_GT + np.array([3, -2, 10], np.float32)
    Rj, tj = jpnp.refine_gauss_newton(*(jnp.asarray(a) for a in (R0, t0, s["X"], s["x"], K,
                                                                  s["w"])))
    Rt, tt = pnp.refine_gauss_newton(*map(torch.from_numpy, (R0, t0, s["X"], s["x"], K, s["w"])))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-3)
    assert np.abs(tt.numpy() - T_GT).max() < 1e-3 and _rot_err(Rt.numpy()) < 1e-5


def _jax_indices(valid, key, num_hypotheses=64, sample_size=6):
    """solve_pnp_ransac_jax's own draw: gumbel top-k per hypothesis key."""
    v = jnp.asarray(valid)

    def sample_idx(k):
        g = jax.random.gumbel(k, (v.shape[0],)) + jnp.where(v, 0.0, -1e9)
        return jax.lax.top_k(g, sample_size)[1]

    return np.array(jax.vmap(sample_idx)(jax.random.split(key, num_hypotheses)))


@pytest.mark.parametrize("plane", [False, True])
def test_ransac_on_shared_indices_matches_jax(plane):
    """30% outliers, the last 10 points invalid: with JAX's hypothesis
    indices, the port's pose within 1e-5 (rotation) and 1e-3 mm, the same
    inliers and ok; on the truth within 0.2 mm at 500 mm."""
    s = _sets()
    X, x = (s["Xp"], _project(s["Xp"])) if plane else (s["X"], s["noisy"].copy())
    if plane:
        x[s["noisy"] != s["x"]] = s["noisy"][s["noisy"] != s["x"]]
    valid = np.ones(P, bool)
    valid[-10:] = False
    key = jax.random.PRNGKey(3)
    want = jpnp.solve_pnp_ransac_jax(jnp.asarray(X), jnp.asarray(x), jnp.asarray(K),
                                     jnp.asarray(valid), key)
    idx = torch.from_numpy(_jax_indices(valid, key)).long()
    got = pnp.ransac_from_indices(*(torch.from_numpy(a)[None] for a in (X, x, K, valid)),
                                  idx[None])
    np.testing.assert_allclose(got.rotation[0].numpy(), np.asarray(want.rotation), atol=1e-5)
    np.testing.assert_allclose(got.translation[0].numpy(), np.asarray(want.translation),
                               atol=1e-3)
    np.testing.assert_array_equal(got.inliers[0].numpy(), np.asarray(want.inliers))
    assert bool(got.ok[0]) and bool(want.ok)
    assert np.abs(got.translation[0].numpy() - T_GT).max() < 0.2


def test_sample_hypotheses_draws_valid_points_without_replacement():
    valid = torch.zeros(2, 50, dtype=torch.bool)
    valid[0, ::3] = True
    valid[1, :6] = True
    idx = pnp.sample_hypotheses(valid, 16, 6, torch.Generator().manual_seed(0))
    assert idx.shape == (2, 16, 6)
    assert bool(valid.gather(1, idx.reshape(2, -1)).all())
    assert all(len(set(h.tolist())) == 6 for h in idx.reshape(-1, 6))
    assert torch.equal(idx[1].sort(-1).values, torch.arange(6).expand(16, 6))


def test_solve_pnp_ransac_device_recovers_the_pose_unbatched():
    """The port's own draw (one set, no batch dimension): the truth within
    1e-4 / 0.05 mm despite 30% outliers."""
    s = _sets()
    res = pnp.solve_pnp_ransac_device(*map(torch.from_numpy, (s["X"], s["noisy"], K)))
    assert res.rotation.shape == (3, 3) and res.inliers.shape == (P,) and bool(res.ok)
    assert _rot_err(res.rotation.numpy()) < 1e-4
    assert np.abs(res.translation.numpy() - T_GT).max() < 0.05
