"""cv2's RANSAC-EPnP on the host, in numpy: the port's copy of what
scflow_tpu/geometry/host.py::solve_pnp_ransac asks of cv2, so that RAFT's
default host PnP runs where cv2 is not installed (the card's machine).

    cv2.solvePnPRansac(points_3d, points_2d, K, None, flags=SOLVEPNP_EPNP,
                       reprojectionError=..., iterationsCount=...)
    cv2.Rodrigues(rvec)

rebuilt step by step from cv2 5.0.0's results (each piece is held to cv2
in tests/test_torch_host_pnp.py), in float64 as cv2 computes, with cv2's
orders of summation, so that the same inputs give the same bits:

- `CvRNG`: cv::RNG (a multiply-with-carry generator, state 2^64 - 1 for
  the RANSAC), whose draws pick each 5-point subset;
- `svd`: cv::SVD::compute's one-sided Jacobi SVD (JacobiSVDImpl_), with
  `invert_svd` (cv::invert(DECOMP_SVD)) and `solve_svd`
  (cv::solve(DECOMP_SVD)) on its back substitution, and `mul_transposed`
  (cv::mulTransposed), all batched over a leading axis;
- `rodrigues_to_matrix`, `rodrigues_to_vector(s)`: cv2.Rodrigues both
  ways (the matrix-to-vector direction orthogonalises through `svd`);
- `project_points`: cv::projectPoints without distortion, rounded to
  float32 as the RANSAC's error takes it;
- `epnp`: SOLVEPNP_EPNP (Lepetit, Moreno-Noguer and Fua's EPnP as OpenCV
  carries it: control points from the points' PCA, the 12 x 12 MtM's null
  space, betas by three approximations each refined by 5 Gauss-Newton
  steps on a Householder QR, R and t by a 3 x 3 SVD), batched over
  problems of one point count;
- `p3p`: the 4-point route (P3P on the first three points, the fourth
  choosing among its solutions), held to cv2 within a bound, not bit for
  bit: cv2 5.0's own P3P solver is not reproduced;
- `solve_pnp_ransac_cv`: the RANSAC loop.  Its subsets do not depend on
  the results, so the minimal solves and their error maps are computed in
  batches (the first 8 subsets, then all the iteration count still asks
  for), and the keep / iteration-count logic is replayed in order (the
  count only shrinks).

Host numpy only: no torch, no cv2.
"""

import math
from typing import Optional, Tuple

import numpy as np

DBL_EPSILON = np.finfo(np.float64).eps
DBL_MIN = np.finfo(np.float64).tiny


class CvRNG:
    """cv::RNG: state <- (state & 0xffffffff) * 4164903690 + (state >> 32)
    (mod 2^64); next() is the new state's low 32 bits, uniform(a, b) is
    a + next() % (b - a)."""

    COEFF = 4164903690

    def __init__(self, state: int = 2**64 - 1):
        self.state = state & (2**64 - 1)

    def next(self) -> int:
        self.state = ((self.state & 0xffffffff) * self.COEFF + (self.state >> 32)) & (2**64 - 1)
        return self.state & 0xffffffff

    def uniform(self, a: int, b: int) -> int:
        return a if a == b else a + self.next() % (b - a)


def _seqsum(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """sum(x) along axis in order, from 0 (a C loop `s += x[k]`)."""
    if x.shape[axis] == 0:
        return np.zeros(np.delete(x.shape, axis % x.ndim), x.dtype)
    return np.take(np.cumsum(x, axis=axis), -1, axis=axis)


def _hypot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """lapack.cpp's own hypot: max * sqrt(1 + (min / max)^2), 0 for 0."""
    a, b = np.abs(a), np.abs(b)
    with np.errstate(all="ignore"):
        ra = a * np.sqrt(1 + (b / a) * (b / a))
        rb = b * np.sqrt(1 + (a / b) * (a / b))
    return np.where(a > b, ra, np.where(b > 0, rb, 0.0))


def _jacobi(At: np.ndarray, n1: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """JacobiSVDImpl_<double> on a batch of At (B, n, m), m >= n, its rows
    the columns of A: returns (W (B, n), the first n1 rows of At normalised
    (B, n1, m): the left singular vectors, Vt (B, n, n)), singular values
    descending, as cv2 computes them (minval DBL_MIN, eps 10 DBL_EPSILON)."""
    with np.errstate(all="ignore"):  # NaN and inf propagate as in cv2
        return _jacobi_loop(np.array(At, np.float64), n1)


def _pair_levels(n: int):
    """JacobiSVDImpl_'s sweep order, (0, 1), (0, 2), ..., (n-2, n-1), cut
    into levels of pairs on disjoint rows, each pair after every earlier
    pair that shares a row with it: applying a level's rotations at once
    gives the bits of the sweep in its order (a rotation reads and writes
    only its own two rows and their norms)."""
    last, levels = [0] * n, []
    for i in range(n - 1):
        for j in range(i + 1, n):
            lv = max(last[i], last[j])
            last[i] = last[j] = lv + 1
            if lv == len(levels):
                levels.append([])
            levels[lv].append((i, j))
    # a level of one pair indexes with ints: views, not gathers
    return [(lv[0][0], lv[0][1]) if len(lv) == 1 else
            (np.array([p[0] for p in lv]), np.array([p[1] for p in lv])) for lv in levels]


def _jacobi_loop(At: np.ndarray, n1: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    B, n, m = At.shape
    eps = DBL_EPSILON * 10
    W = _seqsum(At * At)
    Vt = np.broadcast_to(np.eye(n), (B, n, n)).copy()
    levels = _pair_levels(n)
    for _ in range(max(m, 30)):
        changed = np.zeros(B, bool)
        for I, J in levels:
            Ai, Aj = At[:, I], At[:, J]  # (B, P, m)
            a, b = W[:, I], W[:, J]
            p = _seqsum(Ai * Aj)
            on = ~(np.abs(p) <= eps * np.sqrt(a * b))
            if not on.any():
                continue
            p = p * 2
            beta = a - b
            gamma = _hypot(p, beta)
            s_neg = np.sqrt((gamma - beta) * 0.5 / gamma)
            c_pos = np.sqrt((gamma + beta) / (gamma * 2))
            # a pair that is not rotated gets (c, s) = (1, 0): its rows and
            # norms come out as they were (finite there: p is finite)
            c = np.where(on, np.where(beta < 0, p / (gamma * s_neg * 2), c_pos), 1.0)[..., None]
            s = np.where(on, np.where(beta < 0, s_neg, p / (gamma * c_pos * 2)), 0.0)[..., None]
            if on.ndim == 1:  # one pair: on is (B,)
                on = on[:, None]
            t0 = c * Ai + s * Aj
            t1 = -s * Ai + c * Aj
            At[:, I] = t0
            At[:, J] = t1
            W[:, I] = _seqsum(t0 * t0)
            W[:, J] = _seqsum(t1 * t1)
            Vi, Vj = Vt[:, I], Vt[:, J]
            v0, v1 = c * Vi + s * Vj, -s * Vi + c * Vj
            Vt[:, I] = v0
            Vt[:, J] = v1
            changed |= on.any(axis=1)
        if not changed.any():
            break
    W = np.sqrt(_seqsum(At * At))
    rows = np.arange(B)
    for i in range(n - 1):
        j = np.full(B, i)
        for k in range(i + 1, n):
            j = np.where(W[rows, j] < W[:, k], k, j)
        swap = j != i
        if swap.any():
            wi, wj = W[rows, i].copy(), W[rows, j].copy()
            W[rows, i], W[rows, j] = wj, wi
            for arr in (At, Vt):
                ri, rj = arr[rows, i].copy(), arr[rows, j].copy()
                arr[rows, i], arr[rows, j] = rj, ri
    null = (W[:, :n1] <= DBL_MIN).any(axis=1) | (n1 > n)
    with np.errstate(all="ignore"):
        At[~null, :n1] *= (1 / W[~null, :n1])[..., None]
    for b in np.flatnonzero(null):
        _fill_null_rows(At[b], W[b], n1)
    return W, At[:, :n1], Vt


def _fill_null_rows(At: np.ndarray, W: np.ndarray, n1: int) -> None:
    """The last loop of JacobiSVDImpl_ on one matrix, in place: each row
    i < n1 scaled by 1 / W[i]; a row whose singular value is 0 (<= DBL_MIN)
    becomes a random unit vector orthogonal to the rows before it, from
    cv::RNG(0x12345678), as cv2 makes it."""
    n, m = len(W), At.shape[1]
    rng = CvRNG(0x12345678)
    eps = DBL_EPSILON * 10
    for i in range(n1):
        sd = W[i] if i < n else 0.0
        ii = 0
        while ii < 100 and sd <= DBL_MIN:
            val0 = 1.0 / m
            for k in range(m):
                At[i, k] = val0 if (rng.next() & 256) != 0 else -val0
            for _ in range(2):
                for j in range(i):
                    sd = 0.0
                    for k in range(m):
                        sd += At[i, k] * At[j, k]
                    asum = 0.0
                    for k in range(m):
                        t = At[i, k] - sd * At[j, k]
                        At[i, k] = t
                        asum += abs(t)
                    asum = 1 / asum if asum > eps * 100 else 0.0
                    for k in range(m):
                        At[i, k] *= asum
            sd = 0.0
            for k in range(m):
                sd += At[i, k] * At[i, k]
            sd = math.sqrt(sd)
            ii += 1
        s = 1 / sd if sd > DBL_MIN else 0.0
        At[i] *= s


def svd(A: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv::SVD::compute of a batch of A (B, m, n), m >= n: (w (B, n), u (B,
    m, n), vt (B, n, n))."""
    W, Ut, Vt = _jacobi(np.swapaxes(A, 1, 2), A.shape[2])
    return W, np.swapaxes(Ut, 1, 2), Vt


def _back_subst(w, ut, vt, b: Optional[np.ndarray]) -> np.ndarray:
    """SVBkSbImpl_ (threshold 2 DBL_EPSILON sum(w)): x = V diag(1/w) U^T b,
    or V diag(1/w) U^T where b is None; ut (B, n, m): the left singular
    vectors as rows, vt (B, n, n).  Returns (B, n) or (B, n, m)."""
    B, n, m = ut.shape
    threshold = _seqsum(w) * (DBL_EPSILON * 2)
    x = np.zeros((B, n) if b is not None else (B, n, m))
    for i in range(n):
        wi = w[:, i]
        on = ~(np.abs(wi) <= threshold)
        with np.errstate(all="ignore"):
            inv = 1 / wi
            if b is not None:
                s = _seqsum(ut[:, i] * b) * inv
                upd = x + s[:, None] * vt[:, i]
            else:
                buf = ut[:, i] * inv[:, None]  # (B, m)
                upd = x + vt[:, i, :, None] * buf[:, None, :]
        x = np.where(on.reshape((B,) + (1,) * (x.ndim - 1)), upd, x)
    return x


def invert_svd(A: np.ndarray) -> np.ndarray:
    """cv::invert(A, DECOMP_SVD) of a batch of square matrices (B, n, n)."""
    w, u, vt = svd(A)
    return _back_subst(w, np.swapaxes(u, 1, 2), vt, None)


def solve_svd(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """cv::solve(A, b, DECOMP_SVD) of a batch (B, m, n), m >= n, b (B, m):
    the least-squares x (B, n)."""
    W, Ut, Vt = _jacobi(np.swapaxes(A, 1, 2), A.shape[2])
    return _back_subst(W, Ut, Vt, b)


def mul_transposed(M: np.ndarray) -> np.ndarray:
    """cv::mulTransposed(M, dst, aTa=true) of a batch (B, r, c): M^T M
    summed over the rows in order."""
    return _seqsum(M[:, :, :, None] * M[:, :, None, :], axis=1)


def _matmul3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matx33d * Matx33d (each element summed over k in order), batched."""
    return _seqsum(a[:, :, :, None] * b[:, None, :, :], axis=2)


def rodrigues_to_matrix(rvec) -> np.ndarray:
    """cv2.Rodrigues(rvec) for one rotation vector: (3, 3) float64."""
    r = np.asarray(rvec, np.float64).reshape(3)
    x, y, z = float(r[0]), float(r[1]), float(r[2])
    theta = math.sqrt(x * x + y * y + z * z)
    if theta < DBL_EPSILON:
        return np.eye(3)
    c, s = math.cos(theta), math.sin(theta)
    c1 = 1.0 - c
    itheta = 1.0 / theta if theta else 0.0
    x, y, z = x * itheta, y * itheta, z * itheta
    rrt = np.array([[x * x, x * y, x * z], [x * y, y * y, y * z], [x * z, y * z, z * z]])
    r_x = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return (c * np.eye(3) + c1 * rrt) + s * r_x


def rodrigues_to_vector(R) -> np.ndarray:
    """cv2.Rodrigues(R) for one rotation matrix: the rotation vector (3,)
    of U Vt (R's nearest rotation by cv2's SVD); zeros where R has an
    element outside [-100, 100) or a NaN, as cv2 returns."""
    return rodrigues_to_vectors(np.asarray(R, np.float64).reshape(1, 3, 3))[0]


def _vector_of(R: np.ndarray) -> np.ndarray:
    """The rotation vector of U Vt (cvRodrigues2's matrix branch after its
    SVD)."""
    rx, ry, rz = R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]
    s = math.sqrt((rx * rx + ry * ry + rz * rz) * 0.25)
    c = (R[0, 0] + R[1, 1] + R[2, 2] - 1) * 0.5
    c = 1.0 if c > 1.0 else (-1.0 if c < -1.0 else c)
    theta = math.acos(c)
    if s < 1e-5:
        if c > 0:
            return np.zeros(3)
        t = (R[0, 0] + 1) * 0.5
        rx = math.sqrt(max(t, 0.0))
        t = (R[1, 1] + 1) * 0.5
        ry = math.sqrt(max(t, 0.0)) * (-1.0 if R[0, 1] < 0 else 1.0)
        t = (R[2, 2] + 1) * 0.5
        rz = math.sqrt(max(t, 0.0)) * (-1.0 if R[0, 2] < 0 else 1.0)
        if abs(rx) < abs(ry) and abs(rx) < abs(rz) and (R[1, 2] > 0) != (ry * rz > 0):
            rz = -rz
        theta /= math.sqrt(rx * rx + ry * ry + rz * rz)
        return np.array([rx * theta, ry * theta, rz * theta])
    vth = 1 / (2 * s)
    vth *= theta
    return np.array([rx * vth, ry * vth, rz * vth])


def rodrigues_to_vectors(R: np.ndarray) -> np.ndarray:
    """rodrigues_to_vector of a batch (B, 3, 3): (B, 3), with one batched
    SVD."""
    R = np.asarray(R, np.float64)
    finite = np.all((R >= -100) & (R < 100), axis=(1, 2))
    _, u, vt = svd(np.where(finite[:, None, None], R, 0.0))
    return np.stack([_vector_of(r) if f else np.zeros(3)
                     for r, f in zip(_matmul3(u, vt), finite)])


def project_points(points_3d, rvec, tvec, K) -> np.ndarray:
    """cv2.projectPoints(points_3d, rvec, tvec, K, None) for float32
    points: (n, 2) float32, computed in float64 and rounded once."""
    X = np.asarray(points_3d, np.float32).astype(np.float64)
    R = rodrigues_to_matrix(rvec)
    t = np.asarray(tvec, np.float64).reshape(3)
    return _project(X, R, t, np.asarray(K, np.float64))


def _project(X: np.ndarray, R: np.ndarray, t: np.ndarray, K: np.ndarray) -> np.ndarray:
    """projectPoints' loop without distortion: X (..., n, 3) float64, R (...,
    3, 3), t (..., 3) -> (..., n, 2) float32."""
    P = [((R[..., r, 0, None] * X[..., 0] + R[..., r, 1, None] * X[..., 1])
          + R[..., r, 2, None] * X[..., 2]) + t[..., r, None] for r in range(3)]
    z = P[2]
    with np.errstate(all="ignore"):
        iz = np.where(z != 0, 1.0 / z, 1.0)
    x, y = P[0] * iz, P[1] * iz
    u = x * K[0, 0] + K[0, 2]
    v = y * K[1, 1] + K[1, 2]
    return np.stack([u, v], -1).astype(np.float32)


def undistort_points(points_2d: np.ndarray, K: np.ndarray) -> np.ndarray:
    """cv2.undistortPoints(points_2d, K, None) without distortion: (x - cx)
    * (1 / fx), likewise y, in float64, returned in the points' dtype."""
    p = np.asarray(points_2d)
    x = (p[..., 0].astype(np.float64) - K[0, 2]) * (1.0 / K[0, 0])
    y = (p[..., 1].astype(np.float64) - K[1, 2]) * (1.0 / K[1, 1])
    return np.stack([x, y], -1).astype(p.dtype if p.dtype == np.float32 else np.float64)


# ---------------------------------------------------------------------------
# EPnP (OpenCV's epnp class), batched over B problems of n points each


def _dot3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a[0] b[0] + a[1] b[1] + a[2] b[2] over the last axis."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _qr_solve(A: np.ndarray, b: np.ndarray, x: np.ndarray) -> np.ndarray:
    """epnp::qr_solve of a batch (B, nr, nc), b (B, nr): Householder QR then
    back substitution, as OpenCV's (its column maximum skips the last row);
    where a column is all zero the problem keeps its previous x."""
    A, b, x = A.copy(), b.copy(), x.copy()
    B, nr, nc = A.shape
    A1, A2 = np.zeros((B, nc)), np.zeros((B, nc))
    live = np.ones(B, bool)
    with np.errstate(all="ignore"):
        for k in range(nc):
            eta = np.abs(A[:, k, k])
            for i in range(k + 1, nr):
                elt = np.abs(A[:, i - 1, k])
                eta = np.where(eta < elt, elt, eta)
            live &= ~(eta == 0)
            inv_eta = 1.0 / eta
            sum2 = np.zeros(B)
            for i in range(k, nr):
                A[:, i, k] = A[:, i, k] * inv_eta
                sum2 = sum2 + A[:, i, k] * A[:, i, k]
            sigma = np.sqrt(sum2)
            sigma = np.where(A[:, k, k] < 0, -sigma, sigma)
            A[:, k, k] = A[:, k, k] + sigma
            A1[:, k] = sigma * A[:, k, k]
            A2[:, k] = -eta * sigma
            for j in range(k + 1, nc):
                s = np.zeros(B)
                for i in range(k, nr):
                    s = s + A[:, i, k] * A[:, i, j]
                tau = s / A1[:, k]
                for i in range(k, nr):
                    A[:, i, j] = A[:, i, j] - tau * A[:, i, k]
        for j in range(nc):
            tau = np.zeros(B)
            for i in range(j, nr):
                tau = tau + A[:, i, j] * b[:, i]
            tau = tau / A1[:, j]
            for i in range(j, nr):
                b[:, i] = b[:, i] - tau * A[:, i, j]
        out = np.zeros((B, nc))
        out[:, nc - 1] = b[:, nc - 1] / A2[:, nc - 1]
        for i in range(nc - 2, -1, -1):
            s = np.zeros(B)
            for j in range(i + 1, nc):
                s = s + A[:, i, j] * out[:, j]
            out[:, i] = (b[:, i] - s) / A2[:, i]
    return np.where(live[:, None], out, x)


_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _betas_from(L: np.ndarray, rho: np.ndarray, approx: int) -> np.ndarray:
    """find_betas_approx_1/2/3: betas (B, 4) from an SVD solve of columns
    of L_6x10."""
    cols = {1: [0, 1, 3, 6], 2: [0, 1, 2], 3: [0, 1, 2, 3, 4]}[approx]
    x = solve_svd(L[:, :, cols], rho)
    betas = np.zeros((L.shape[0], 4))
    neg = x[:, 0] < 0
    with np.errstate(all="ignore"):
        if approx == 1:
            b0 = np.where(neg, np.sqrt(-x[:, 0]), np.sqrt(x[:, 0]))
            betas[:, 0] = b0
            for i in (1, 2, 3):
                betas[:, i] = np.where(neg, -x[:, i] / b0, x[:, i] / b0)
            return betas
        b0 = np.where(neg, np.sqrt(-x[:, 0]), np.sqrt(x[:, 0]))
        b1 = np.where(neg, np.where(x[:, 2] < 0, np.sqrt(-x[:, 2]), 0.0),
                      np.where(x[:, 2] > 0, np.sqrt(x[:, 2]), 0.0))
        b0 = np.where(x[:, 1] < 0, -b0, b0)
        betas[:, 0], betas[:, 1] = b0, b1
        if approx == 3:
            betas[:, 2] = x[:, 3] / b0
    return betas


def _gauss_newton(L: np.ndarray, rho: np.ndarray, betas: np.ndarray) -> np.ndarray:
    """epnp::gauss_newton: 5 steps of qr_solve on the 6 x 4 Jacobian."""
    x = np.zeros_like(betas)
    r = [L[:, :, i] for i in range(10)]
    for _ in range(5):
        b0, b1, b2, b3 = (betas[:, i, None] for i in range(4))
        A = np.stack([
            ((2 * r[0] * b0 + r[1] * b1) + r[3] * b2) + r[6] * b3,
            ((r[1] * b0 + 2 * r[2] * b1) + r[4] * b2) + r[7] * b3,
            ((r[3] * b0 + r[4] * b1) + 2 * r[5] * b2) + r[8] * b3,
            ((r[6] * b0 + r[7] * b1) + r[8] * b2) + 2 * r[9] * b3], -1)
        quad = r[0] * b0 * b0
        for term in (r[1] * b0 * b1, r[2] * b1 * b1, r[3] * b0 * b2, r[4] * b1 * b2,
                     r[5] * b2 * b2, r[6] * b0 * b3, r[7] * b1 * b3, r[8] * b2 * b3,
                     r[9] * b3 * b3):
            quad = quad + term
        x = _qr_solve(A, rho - quad, x)
        betas = betas + x
    return betas


def _r_and_t(ut: np.ndarray, betas: np.ndarray, alphas: np.ndarray, pws: np.ndarray,
             us: np.ndarray, cam) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """epnp::compute_R_and_t: (R (B, 3, 3), t (B, 3), the mean reprojection
    error (B,))."""
    fu, fv, uc, vc = cam
    B, n, _ = pws.shape
    ccs = np.zeros((B, 4, 3))
    for i in range(4):
        ccs = ccs + betas[:, i, None, None] * ut[:, 11 - i].reshape(B, 4, 3)
    pcs = ((alphas[:, :, 0, None] * ccs[:, None, 0] + alphas[:, :, 1, None] * ccs[:, None, 1])
           + alphas[:, :, 2, None] * ccs[:, None, 2]) + alphas[:, :, 3, None] * ccs[:, None, 3]
    flip = pcs[:, 0, 2] < 0
    pcs = np.where(flip[:, None, None], -pcs, pcs)
    pc0 = _seqsum(pcs, axis=1) / n
    pw0 = _seqsum(pws, axis=1) / n
    dc, dw = pcs - pc0[:, None], pws - pw0[:, None]
    abt = _seqsum(dc[:, :, :, None] * dw[:, :, None, :], axis=1)
    _, u, vt = svd(abt)
    v = np.swapaxes(vt, 1, 2)
    R = _dot3(u[:, :, None, :], v[:, None, :, :])
    det = (((((R[:, 0, 0] * R[:, 1, 1] * R[:, 2, 2] + R[:, 0, 1] * R[:, 1, 2] * R[:, 2, 0])
              + R[:, 0, 2] * R[:, 1, 0] * R[:, 2, 1]) - R[:, 0, 2] * R[:, 1, 1] * R[:, 2, 0])
            - R[:, 0, 1] * R[:, 1, 0] * R[:, 2, 2]) - R[:, 0, 0] * R[:, 1, 2] * R[:, 2, 1])
    R[:, 2] = np.where((det < 0)[:, None], -R[:, 2], R[:, 2])
    t = pc0 - _dot3(R, pw0[:, None, :])
    Xc = _dot3(R[:, None, 0], pws) + t[:, None, 0]
    Yc = _dot3(R[:, None, 1], pws) + t[:, None, 1]
    with np.errstate(all="ignore"):
        inv_z = 1.0 / (_dot3(R[:, None, 2], pws) + t[:, None, 2])
    ue = uc + fu * Xc * inv_z
    ve = vc + fv * Yc * inv_z
    du, dv = us[:, :, 0] - ue, us[:, :, 1] - ve
    err = _seqsum(np.sqrt(du * du + dv * dv), axis=1) / n
    return R, t, err


def epnp(points_3d: np.ndarray, normalized_2d: np.ndarray, K: np.ndarray
         ) -> Tuple[np.ndarray, np.ndarray]:
    """epnp::compute_pose on a batch: points_3d (B, n, 3), normalized_2d (B,
    n, 2) (undistortPoints' output: float32 for float32 image points), K
    (3, 3) -> (R (B, 3, 3), t (B, 3)) float64.  The image points are
    x * fu + uc, y * fv + vc again, as the epnp class takes them."""
    K = np.asarray(K, np.float64)
    fu, fv, uc, vc = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    pws = np.asarray(points_3d).astype(np.float64)
    nz = np.asarray(normalized_2d).astype(np.float64)
    us = np.stack([nz[..., 0] * fu + uc, nz[..., 1] * fv + vc], -1)
    B, n, _ = pws.shape
    # control points: the centroid and the PCA axes scaled by sqrt(sigma / n)
    c0 = _seqsum(pws, axis=1) / n
    pw0 = pws - c0[:, None]
    dcw, ucw, _ = svd(mul_transposed(pw0))
    cws = [c0] + [c0 + np.sqrt(dcw[:, i - 1] / n)[:, None] * ucw[:, :, i - 1]
                  for i in range(1, 4)]
    # barycentric coordinates
    cc = np.stack([cws[j] - cws[0] for j in range(1, 4)], -1)  # cc[i][j-1]
    ci = invert_svd(cc)
    d = pws - cws[0][:, None]
    a123 = _dot3(ci[:, None, :, :], d[:, :, None, :])  # (B, n, 3)
    alphas = np.concatenate([((1.0 - a123[..., 0:1]) - a123[..., 1:2]) - a123[..., 2:3], a123],
                            -1)
    # M (2n x 12) and its null space
    M = np.zeros((B, 2 * n, 12))
    for i in range(4):
        M[:, 0::2, 3 * i] = alphas[:, :, i] * fu
        M[:, 0::2, 3 * i + 2] = alphas[:, :, i] * (uc - us[:, :, 0])
        M[:, 1::2, 3 * i + 1] = alphas[:, :, i] * fv
        M[:, 1::2, 3 * i + 2] = alphas[:, :, i] * (vc - us[:, :, 1])
    _, u, _ = svd(mul_transposed(M))
    ut = np.swapaxes(u, 1, 2)
    # L_6x10 and rho
    v = [ut[:, 11 - i].reshape(B, 4, 3) for i in range(4)]
    dv = [np.stack([vi[:, a] - vi[:, b] for a, b in _PAIRS], 1) for vi in v]  # (B, 6, 3)
    L = np.stack([_dot3(dv[0], dv[0]), 2.0 * _dot3(dv[0], dv[1]), _dot3(dv[1], dv[1]),
                  2.0 * _dot3(dv[0], dv[2]), 2.0 * _dot3(dv[1], dv[2]), _dot3(dv[2], dv[2]),
                  2.0 * _dot3(dv[0], dv[3]), 2.0 * _dot3(dv[1], dv[3]),
                  2.0 * _dot3(dv[2], dv[3]), _dot3(dv[3], dv[3])], -1)
    rho = np.stack([_dot3(cws[a] - cws[b], cws[a] - cws[b]) for a, b in _PAIRS], -1)
    # the three approximations' Gauss-Newton and R, t as one batch of 3B
    # (each problem's arithmetic is its own)
    three = lambda a: np.concatenate([a] * 3)  # noqa: E731
    betas = np.concatenate([_betas_from(L, rho, k) for k in (1, 2, 3)])
    betas = _gauss_newton(three(L), three(rho), betas)
    R, t, err = (a.reshape((3, B) + a.shape[1:]) for a in _r_and_t(
        three(ut), betas, three(alphas), three(pws), three(us), (fu, fv, uc, vc)))
    rows = np.arange(B)
    best = np.where(err[1] < err[0], 1, 0)
    best = np.where(err[2] < err[best, rows], 2, best)
    return R[best, rows], t[best, rows]


# ---------------------------------------------------------------------------
# P3P: the 4-point route


def _kabsch(P: np.ndarray, Q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """R, t with R P_i + t = Q_i for 3 (or more) point pairs, R a rotation."""
    pc, qc = P.mean(0), Q.mean(0)
    U, _, Vt = np.linalg.svd((Q - qc).T @ (P - pc))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    return R, qc - R @ pc


def p3p(points_3d: np.ndarray, normalized_2d: np.ndarray, K: np.ndarray
        ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The pose of 4 points by P3P on the first three (Grunert's distances:
    the quartic is the resultant of two quadratics in the distance ratios,
    its roots polished by Newton steps on the three distance equations),
    the fourth choosing the solution that reprojects it best in pixels;
    None where no solution is real and in front of the camera.
    normalized_2d: the image points normalised by K.  (R (3, 3), t (3,))."""
    X = np.asarray(points_3d, np.float64).reshape(4, 3)
    xn = np.asarray(normalized_2d, np.float64).reshape(4, 2)
    K = np.asarray(K, np.float64)
    x = xn * K[[0, 1], [0, 1]] + K[[0, 1], [2, 2]]  # pixels, for the choice
    rays = np.concatenate([xn, np.ones((4, 1))], -1)
    j = rays / np.linalg.norm(rays, axis=1, keepdims=True)
    a2 = float(np.sum((X[1] - X[2]) ** 2))
    b2 = float(np.sum((X[0] - X[2]) ** 2))
    c2 = float(np.sum((X[0] - X[1]) ** 2))
    ca, cb, cg = float(j[1] @ j[2]), float(j[0] @ j[2]), float(j[0] @ j[1])
    P = np.polynomial.polynomial
    q = P.polyadd([1.0], [0.0, -2 * cb, 1.0])  # 1 + v^2 - 2 v cos(beta)
    f2, f1, f0 = [b2], [-2 * b2 * cg], P.polysub([b2], P.polymul([c2], q))
    g2, g1, g0 = [-b2], [0.0, 2 * b2 * ca], P.polysub(P.polymul([a2], q), [0.0, 0.0, b2])
    m = P.polysub(P.polymul(f2, g0), P.polymul(f0, g2))
    res = P.polysub(P.polymul(m, m), P.polymul(P.polysub(P.polymul(f2, g1), P.polymul(f1, g2)),
                                                P.polysub(P.polymul(f1, g0), P.polymul(f0, g1))))
    best, best_err = None, np.inf
    for v in P.polyroots(res):
        if abs(v.imag) > 1e-6 * max(1.0, abs(v.real)) or v.real <= 0:
            continue
        v = v.real
        den = P.polyval(v, P.polysub(P.polymul(g2, f1), P.polymul(f2, g1)))
        if den == 0:
            continue
        u = -P.polyval(v, P.polysub(P.polymul(g2, f0), P.polymul(f2, g0))) / den
        d = 1 + v * v - 2 * v * cb
        if u <= 0 or d <= 0:
            continue
        s = np.sqrt(b2 / d) * np.array([1.0, u, v])
        for _ in range(5):  # Newton on |s_i j_i - s_k j_k|^2 = |X_i - X_k|^2
            r = np.array([s[0] ** 2 + s[1] ** 2 - 2 * s[0] * s[1] * cg - c2,
                          s[0] ** 2 + s[2] ** 2 - 2 * s[0] * s[2] * cb - b2,
                          s[1] ** 2 + s[2] ** 2 - 2 * s[1] * s[2] * ca - a2])
            Jm = np.array([[2 * s[0] - 2 * s[1] * cg, 2 * s[1] - 2 * s[0] * cg, 0.0],
                           [2 * s[0] - 2 * s[2] * cb, 0.0, 2 * s[2] - 2 * s[0] * cb],
                           [0.0, 2 * s[1] - 2 * s[2] * ca, 2 * s[2] - 2 * s[1] * ca]])
            try:
                s = s - np.linalg.solve(Jm, r)
            except np.linalg.LinAlgError:
                break
        R, t = _kabsch(X[:3], s[:, None] * j[:3])
        c4 = R @ X[3] + t
        if c4[2] <= 0:
            continue
        e = (K[0, 0] * c4[0] / c4[2] + K[0, 2] - x[3, 0]) ** 2 + (
            K[1, 1] * c4[1] / c4[2] + K[1, 2] - x[3, 1]) ** 2
        if e < best_err:
            best, best_err = (R, t), e
    return best


# ---------------------------------------------------------------------------
# solvePnPRansac(flags=SOLVEPNP_EPNP)

MODEL_POINTS = 5  # the EPnP RANSAC's subset size


def ransac_update_num_iters(p: float, ep: float, model_points: int, max_iters: int) -> int:
    """cv::RANSACUpdateNumIters."""
    p = min(max(p, 0.0), 1.0)
    ep = min(max(ep, 0.0), 1.0)
    num = max(1.0 - p, DBL_MIN)
    denom = 1.0 - math.pow(1.0 - ep, model_points)
    if denom < DBL_MIN:
        return 0
    num, denom = math.log(num), math.log(denom)
    return max_iters if denom >= 0 or -num >= max_iters * (-denom) else round(num / denom)


def _epnp_pose(X: np.ndarray, x: np.ndarray, K: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """solvePnP(X, x, K, None, SOLVEPNP_EPNP) of one point set: (rvec (3,),
    tvec (3,)), with undistortPoints in the image points' dtype."""
    R, t = epnp(X[None], undistort_points(x, K)[None], K)
    return rodrigues_to_vector(R[0]), t[0]


def _subsets(count: int, iters: int) -> np.ndarray:
    """The RANSAC's subsets: MODEL_POINTS distinct indices each, drawn by
    cv::RNG(2^64 - 1) (a repeated index is drawn again)."""
    rng = CvRNG()
    out = np.empty((iters, MODEL_POINTS), np.int64)
    for it in range(iters):
        for i in range(MODEL_POINTS):
            idx = rng.uniform(0, count)
            while idx in out[it, :i]:
                idx = rng.uniform(0, count)
            out[it, i] = idx
    return out


def _inlier_maps(X: np.ndarray, x: np.ndarray, K: np.ndarray, rvecs, tvecs,
                 threshold: float) -> np.ndarray:
    """findInliers of each model: the float32 projections of the float32
    points, err = float32(dx^2 + dy^2) summed in float64 from the float32
    differences, inlier where err <= float32(threshold^2)."""
    R = np.stack([rodrigues_to_matrix(r) for r in rvecs])
    proj = _project(X.astype(np.float64)[None], R, np.asarray(tvecs), K)
    d = (x[None] - proj).astype(np.float64)
    err = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]).astype(np.float32)
    return err <= np.float32(threshold * threshold)


def solve_pnp_ransac_cv(points_3d, points_2d, K, reprojection_error: float = 8.0,
                        iterations: int = 100, confidence: float = 0.99
                        ) -> Tuple[bool, np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """cv2.solvePnPRansac(points_3d, points_2d, K, None,
    iterationsCount=iterations, reprojectionError=reprojection_error,
    confidence=confidence, flags=cv2.SOLVEPNP_EPNP): (retval, rvec (3,),
    tvec (3,), inlier indices or None).  The points are rounded to float32
    first, as cv2 does; 4 points take the P3P route, 5 one EPnP solve, more
    the RANSAC (5-point EPnP subsets, then EPnP on the best model's
    inliers).  Raises ValueError for fewer than 4 points (cv2 asserts)."""
    X = np.asarray(points_3d, np.float64).astype(np.float32).reshape(-1, 3)
    x = np.asarray(points_2d, np.float64).astype(np.float32).reshape(-1, 2)
    K = np.asarray(K, np.float64)
    n = len(X)
    if n < 4 or len(x) != n:
        raise ValueError(f"solvePnPRansac needs at least 4 point pairs, got {n}, {len(x)}")
    zeros = np.zeros(3)
    if n == 4:  # P3P on the points normalised by K in float32, as cv2 takes them
        pose = p3p(X, undistort_points(x, K), K)
        if pose is None:
            return False, zeros, zeros, None
        return True, rodrigues_to_vector(pose[0]), pose[1], np.arange(n)
    if n == MODEL_POINTS:
        rvec, tvec = _epnp_pose(X, x, K)
        return True, rvec, tvec, np.arange(n)
    niters = max(iterations, 1)
    subsets = _subsets(n, niters)
    nz = undistort_points(x, K)
    threshold = float(np.float32(reprojection_error))
    best, best_count, it, good = None, 0, 0, None
    while it < niters:
        # the next subsets' models and inlier maps in one batch: the first 8
        # (the count shrinks as soon as a model is kept: to 1 on exact
        # correspondences), then all that the count still asks for
        chunk = subsets[it:niters] if it else subsets[:8]
        R, t = epnp(X[chunk], nz[chunk], K)
        good = _inlier_maps(X, x, K, rodrigues_to_vectors(R), t, threshold)
        for g in good:
            if it >= niters:
                break
            count = int(g.sum())
            if count > max(best_count, MODEL_POINTS - 1):
                best, best_count = g, count
                niters = ransac_update_num_iters(confidence, (n - count) / n, MODEL_POINTS,
                                                 niters)
            it += 1
    if best is None:
        return False, zeros, zeros, None
    inliers = np.flatnonzero(best)
    rvec, tvec = _epnp_pose(X[inliers].astype(np.float64), x[inliers].astype(np.float64), K)
    return True, rvec, tvec, inliers


def solve_pnp_ransac(points_3d, points_2d, K, reprojection_error: float = 3.0,
                     iterations: int = 100):
    """scflow_tpu/geometry/host.py::solve_pnp_ransac without cv2: (R (3, 3),
    t (3,), True) as float32, R through cv2's rvec round trip
    (`rodrigues_to_matrix`), or (None, None, False) on fewer than 4 points,
    a failed solve or a NaN pose."""
    if len(points_2d) < 4:
        return None, None, False
    ok, rvec, tvec, _ = solve_pnp_ransac_cv(points_3d, points_2d, K, reprojection_error,
                                            iterations)
    if not ok:
        return None, None, False
    R = rodrigues_to_matrix(rvec).astype(np.float32)
    t = np.asarray(tvec).reshape(-1).astype(np.float32)
    if np.isnan(R.sum()) or np.isnan(t.sum()):
        return None, None, False
    return R, t, True
