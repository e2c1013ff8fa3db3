"""The host PnP without cv2 (scflow_tpu_torch/cv_pnp.py) against cv2 5.0.0
and the JAX package's scflow_tpu.geometry.host.solve_pnp_ransac: cv2's
RANSAC-EPnP rebuilt in numpy, bit for bit where it runs cv2's EPnP (5
points and more), within a stated bound on the 4-point P3P route."""

import re
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from scflow_tpu.geometry import host as jax_host
from scflow_tpu_torch import cv_pnp, pnp

from torch_port_helpers import keep_torch_rng  # noqa: F401

K = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899], [0.0, 0.0, 1.0]])


def _scene(rng, n, noise=0.5, outliers=0.0, planar=False):
    """n object points (mm) seen at a random pose, their projections with
    pixel noise, a share of them moved by up to 80 px."""
    X = rng.normal(size=(n, 3)) * 50
    if planar:
        X[:, 2] = 0.0
    rvec = rng.normal(size=3) * 0.5
    tvec = np.array([rng.normal() * 10, rng.normal() * 10, 500 + rng.normal() * 50])
    x = cv2.projectPoints(X, rvec, tvec, K, None)[0].reshape(-1, 2)
    x = x + rng.normal(size=(n, 2)) * noise
    bad = rng.random(n) < outliers
    x[bad] += rng.uniform(-80, 80, size=(int(bad.sum()), 2))
    return X, x


def _cv2_ransac(X, x, thr, iters):
    ok, rvec, tvec, inliers = cv2.solvePnPRansac(X, x, K, None, flags=cv2.SOLVEPNP_EPNP,
                                                 reprojectionError=thr, iterationsCount=iters)
    return ok, rvec.ravel(), tvec.ravel(), None if inliers is None else inliers.ravel()


def test_rng_matches_cv2_draws():
    """cv::RNG's sequence: cv2.setRNGSeed seeds the global generator, whose
    uniform integers cv2.randu draws by the same recurrence."""
    cv2.setRNGSeed(12345)
    got = np.empty((1, 64), np.int32)
    cv2.randu(got, 0, 1000)
    rng = cv_pnp.CvRNG(12345)
    assert [rng.uniform(0, 1000) for _ in range(64)] == got.ravel().tolist()


@pytest.mark.parametrize("scale", [1e-3, 0.5, 2.0, 3.1])
def test_rodrigues_matches_cv2(scale):
    """Both directions bit for bit: vector -> matrix, and matrix -> vector
    on matrices 1e-9 off a rotation (cv2 orthogonalises through its SVD),
    and at rotations of pi."""
    rng = np.random.default_rng(int(scale * 1000))
    for _ in range(40):
        r = rng.normal(size=3) * scale
        R = cv2.Rodrigues(r)[0]
        assert np.array_equal(cv_pnp.rodrigues_to_matrix(r), R)
        Rn = R + rng.normal(size=(3, 3)) * 1e-9
        assert np.array_equal(cv_pnp.rodrigues_to_vector(Rn), cv2.Rodrigues(Rn)[0].ravel())
    for r in ([np.pi, 0, 0], [0, np.pi, 0], [np.pi / np.sqrt(2)] * 2 + [0], [0, 0, 0]):
        R = cv2.Rodrigues(np.array(r, np.float64))[0]
        assert np.array_equal(cv_pnp.rodrigues_to_vector(R), cv2.Rodrigues(R)[0].ravel())
    assert np.array_equal(cv_pnp.rodrigues_to_vector(np.full((3, 3), np.nan)), np.zeros(3))


def test_project_and_undistort_match_cv2():
    """projectPoints (float32 out) and undistortPoints without distortion,
    bit for bit."""
    rng = np.random.default_rng(1)
    for _ in range(30):
        X = (rng.normal(size=(50, 3)) * 50).astype(np.float32)
        r = rng.normal(size=3)
        t = np.array([rng.normal() * 10, rng.normal() * 10, 500 + rng.normal() * 50])
        P = cv2.projectPoints(X, r, t, K, None)[0].reshape(-1, 2)
        assert np.array_equal(cv_pnp.project_points(X, r, t, K), P)
        for pts in (P, P.astype(np.float64)):
            want = cv2.undistortPoints(pts.reshape(-1, 1, 2), K, None).reshape(-1, 2)
            assert np.array_equal(cv_pnp.undistort_points(pts, K), want)


@pytest.mark.parametrize("shape", [(3, 3), (12, 12), (6, 4), (6, 3), (6, 5)])
def test_svd_solve_and_invert_match_cv2(shape):
    """The Jacobi SVD (w, u, vt), cv::solve(DECOMP_SVD), cv::invert
    (DECOMP_SVD) and mulTransposed, bit for bit (12 x 12: a rank-10 M^T M,
    as EPnP's at 5 points)."""
    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    for _ in range(10):
        A = rng.normal(size=shape)
        if shape == (12, 12):
            M = rng.normal(size=(10, 12))
            A = cv2.mulTransposed(M, True)
            assert np.array_equal(cv_pnp.mul_transposed(M[None])[0], A)
        w, u, vt = cv2.SVDecomp(A)
        W, U, VT = cv_pnp.svd(A[None])
        assert np.array_equal(W[0], w.ravel()) and np.array_equal(U[0], u)
        assert np.array_equal(VT[0], vt)
        if shape[0] == shape[1]:
            want = cv2.invert(A, flags=cv2.DECOMP_SVD)[1]
            assert np.array_equal(cv_pnp.invert_svd(A[None])[0], want)
        else:
            b = rng.normal(size=(shape[0], 1))
            want = cv2.solve(A, b, flags=cv2.DECOMP_SVD)[1].ravel()
            assert np.array_equal(cv_pnp.solve_svd(A[None], b.T)[0], want)


@pytest.mark.parametrize("n", [6, 8, 20, 100, 1000])
@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_epnp_matches_cv2_solvepnp(n, planar, dtype):
    """epnp (with cv2's rvec round trip) against cv2.solvePnP(SOLVEPNP_EPNP)
    bit for bit, on float32 and float64 points, planar sets included."""
    rng = np.random.default_rng(n + 7 * planar)
    for _ in range(3):
        X, x = _scene(rng, n, planar=planar)
        X, x = X.astype(dtype), x.astype(dtype)
        _, rvec, tvec = cv2.solvePnP(X, x, K, None, flags=cv2.SOLVEPNP_EPNP)
        R, t = cv_pnp.epnp(X[None], cv_pnp.undistort_points(x, K)[None], K)
        assert np.array_equal(cv_pnp.rodrigues_to_vector(R[0]), rvec.ravel())
        assert np.array_equal(t[0], tvec.ravel())


def _ransac_cases():
    rng = np.random.default_rng(2024)
    for case in range(50):
        yield (case, int(rng.integers(6, 1001)), float(rng.uniform(0.0, 0.7)),
               float(rng.uniform(1.0, 8.0)), int(rng.integers(10, 201)))


@pytest.mark.parametrize("case,n,outliers,thr,iters", list(_ransac_cases()))
def test_solve_pnp_ransac_matches_jax_host(case, n, outliers, thr, iters, monkeypatch):
    """The RANSAC against cv2.solvePnPRansac (the same inlier indices and
    rvec, tvec bit for bit) and pnp.solve_pnp_ransac against the JAX
    package's cv2 solve (R and t bit for bit), on 50 seeded cases: 6-1000
    points, 0-70% outliers, thresholds 1-8 px, 10-200 iterations."""
    rng = np.random.default_rng(case)
    X, x = _scene(rng, n, outliers=outliers)
    ok, rvec, tvec, inliers = _cv2_ransac(X, x, thr, iters)
    seen = []

    def solve(*args):  # the one solve pnp.solve_pnp_ransac makes, kept
        seen.append(solve_cv(*args))
        return seen[-1]

    solve_cv = cv_pnp.solve_pnp_ransac_cv
    monkeypatch.setattr(cv_pnp, "solve_pnp_ransac_cv", solve)
    R, t, ret = pnp.solve_pnp_ransac(X, x, K, reprojection_error=thr, iterations=iters)
    (got,) = seen
    assert got[0] == ok
    if ok:  # on a failure cv2 hands back uninitialised vectors
        assert np.array_equal(got[3], inliers)
        assert np.array_equal(got[1], rvec) and np.array_equal(got[2], tvec)
    want = jax_host.solve_pnp_ransac(X, x, K, reprojection_error=thr, iterations=iters)
    assert ret == want[2]
    if ret:
        assert R.dtype == np.float32 and np.array_equal(R, want[0])
        assert np.array_equal(t, want[1])


def test_four_points_take_p3p_within_bound():
    """4 points: cv2 solves P3P on the first three and picks by the fourth;
    cv_pnp's own P3P is held within 1e-8 on R and 1e-8 |t| on t (cv2 5.0's
    P3P solver is not rebuilt bit for bit; seen: 1e-13 and 2e-11 mm)."""
    rng = np.random.default_rng(4)
    for _ in range(20):
        X, x = _scene(rng, 4, noise=0.3)
        ok, rvec, tvec, inliers = _cv2_ransac(X, x, 3.0, 100)
        got = cv_pnp.solve_pnp_ransac_cv(X, x, K, 3.0, 100)
        assert ok and got[0] and np.array_equal(got[3], inliers)
        dR = np.abs(cv_pnp.rodrigues_to_matrix(got[1]) - cv2.Rodrigues(rvec)[0]).max()
        assert dR <= 1e-8
        assert np.abs(got[2] - tvec).max() <= 1e-8 * np.abs(tvec).max()


def test_five_points_solve_directly_bit_for_bit():
    rng = np.random.default_rng(5)
    for _ in range(10):
        X, x = _scene(rng, 5, outliers=0.2)
        ok, rvec, tvec, inliers = _cv2_ransac(X, x, 3.0, 100)
        got = cv_pnp.solve_pnp_ransac_cv(X, x, K, 3.0, 100)
        assert ok and got[0] and np.array_equal(got[3], inliers)
        assert np.array_equal(got[1], rvec) and np.array_equal(got[2], tvec)


def test_failure_cases_match_cv2_and_jax():
    """Fewer than 4 points (the JAX helper returns before cv2, which would
    assert), all outliers (no model keeps 5 inliers), collinear points, NaN
    points: the same retval, poses and inliers as cv2 and the JAX helper."""
    rng = np.random.default_rng(6)
    X, x = _scene(rng, 3)
    assert pnp.solve_pnp_ransac(X, x, K) == (None, None, False)
    with pytest.raises(ValueError):
        cv_pnp.solve_pnp_ransac_cv(X, x, K)
    X, x = _scene(rng, 50)
    x = rng.uniform(0, 640, size=x.shape)
    cases = {"all outliers": (X, x)}
    Xc = np.outer(np.linspace(-50, 50, 30), [1.0, 0.5, 0.2])
    xc = cv2.projectPoints(Xc, np.array([0.1, 0.2, 0.3]), np.array([0, 0, 500.0]), K, None)[0]
    cases["collinear"] = (Xc, xc.reshape(-1, 2))
    X, x = _scene(rng, 60)
    x[3] = np.nan
    X[7, 1] = np.nan
    cases["some NaN"] = (X, x)
    X, x = _scene(rng, 60)
    cases["all NaN"] = (X, np.full_like(x, np.nan))
    for name, (X, x) in cases.items():
        ok, rvec, tvec, inliers = _cv2_ransac(X, x, 3.0, 100)
        got = cv_pnp.solve_pnp_ransac_cv(X, x, K, 3.0, 100)
        assert got[0] == ok, name
        if ok:
            assert np.array_equal(got[3], inliers), name
            assert np.array_equal(got[1], rvec) and np.array_equal(got[2], tvec), name
        want = jax_host.solve_pnp_ransac(X, x, K)
        R, t, ret = pnp.solve_pnp_ransac(X, x, K)
        assert ret == want[2], name
        if ret:
            assert np.array_equal(R, want[0]) and np.array_equal(t, want[1]), name


def test_ransac_update_num_iters():
    """cv::RANSACUpdateNumIters' rule: all inliers stop the loop, a
    confidence it cannot reach keeps the count."""
    assert cv_pnp.ransac_update_num_iters(0.99, 0.0, 5, 100) == 0
    assert cv_pnp.ransac_update_num_iters(0.99, 0.3, 5, 100) == round(
        np.log(0.01) / np.log(1 - 0.7 ** 5))
    assert cv_pnp.ransac_update_num_iters(0.99, 0.95, 5, 100) == 100


def test_solves_with_cv2_blocked():
    """With cv2 unimportable (sys.modules['cv2'] = None), cv_pnp imports
    and solves; and no module of the package imports cv2."""
    code = (
        "import sys; sys.modules['cv2'] = None\n"
        "import numpy as np\n"
        "from scflow_tpu_torch import cv_pnp\n"
        "rng = np.random.default_rng(0)\n"
        "X = rng.normal(size=(40, 3)) * 50\n"
        "K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])\n"
        "c = X + np.array([0, 0, 500.0])\n"
        "x = (c[:, :2] / c[:, 2:]) * 500.0 + np.array([320, 240])\n"
        "R, t, ok = cv_pnp.solve_pnp_ransac(X, x, K)\n"
        "assert ok and np.abs(R - np.eye(3)).max() < 1e-4, R\n"
        "assert np.abs(t - [0, 0, 500]).max() < 1e-2, t\n"
        "print('solved')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0 and "solved" in out.stdout, out.stderr
    package = Path(cv_pnp.__file__).parent
    for path in package.rglob("*.py"):
        assert not re.search(r"^\s*(import cv2|from cv2)", path.read_text(), re.M), path
