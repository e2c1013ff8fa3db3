"""The port's data-layer image and pose helpers against cv2, which the JAX
package's data layer calls and the card's machine lacks: imread against
cv2.imread on PNGs that cv2 wrote (8-bit BGR, BGRA and grey, 16-bit BGR
and grey, compression levels 0-9, under each flag), each of the five PNG row filters, imwrite
read back by cv2; imresize against cv2.resize(INTER_LINEAR) on uint8
images, bit for bit, over scales that include exact 2x downscales (which
cv2 runs as INTER_AREA); BitmapMasks' nearest resize against
cv2.INTER_NEAREST; remap_pose and remap_pose_to_origin_resolution
(host_geometry.py) against cv2's EPnP in the JAX package (geometry/host.py)
in the keep and target modes, bit for bit, and its failure branch."""

import struct
import sys
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # run as a script (the timing below): the packages
    sys.path.insert(0, str(ROOT))

import cv2  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from scflow_tpu.geometry import host as jhost  # noqa: E402
from scflow_tpu_torch.datasets.mask import BitmapMasks  # noqa: E402
from scflow_tpu_torch.datasets.pipelines.imops import (imread, imrescale, imresize,  # noqa: E402
                                                       imwrite, png_decode)
from scflow_tpu_torch.host_geometry import (project_3d_point, remap_pose,  # noqa: E402
                                            remap_pose_to_origin_resolution)

from torch_port_helpers import keep_torch_rng  # noqa: E402,F401

YCBV_K = np.array([[1066.778, 0, 312.9869], [0, 1067.487, 241.3109], [0, 0, 1]], np.float32)


def _image(h, w, c, dtype, seed=0):
    """Smooth gradients plus noise: rows where every PNG filter has work."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = (np.sin(x / 7.0)[..., None] * 90 + np.cos(y / 5.0)[..., None] * 70
           + rng.normal(0, 10, (h, w, c)) + 128)
    if dtype == np.uint16:
        img = img * 250
    img = np.clip(img, 0, np.iinfo(dtype).max).astype(dtype)
    return img[..., 0] if c == 1 else img


@pytest.mark.parametrize("level", [0, 1, 3, 9])
@pytest.mark.parametrize("c,dtype", [(3, np.uint8), (4, np.uint8), (1, np.uint8),
                                     (3, np.uint16), (1, np.uint16)])
def test_imread_matches_cv2(tmp_path, c, dtype, level):
    img = _image(37, 61, c, dtype, seed=level)
    path = str(tmp_path / "a.png")
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    flags = [("unchanged", cv2.IMREAD_UNCHANGED), ("color", cv2.IMREAD_COLOR),
             ("grayscale", cv2.IMREAD_GRAYSCALE)]  # colour to grey: libpng's weights
    for flag, cv_flag in flags:
        want, got = cv2.imread(path, cv_flag), imread(path, flag)
        assert got.dtype == want.dtype and got.shape == want.shape, flag
        np.testing.assert_array_equal(got, want, err_msg=flag)
    imwrite(str(tmp_path / "b.png"), img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "b.png"), cv2.IMREAD_UNCHANGED), img)


def _png_with_filter(img: np.ndarray, ftype: int) -> bytes:
    """An 8-bit RGB PNG whose every row carries filter `ftype`, filtered
    here by the PNG specification's formulas (independent of imops)."""
    h, w, _ = img.shape
    x = img.reshape(h, w * 3).astype(np.int32)
    out = np.zeros_like(x)
    for r in range(h):
        for i in range(w * 3):
            a = x[r, i - 3] if i >= 3 else 0
            b = x[r - 1, i] if r else 0
            c = x[r - 1, i - 3] if r and i >= 3 else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            pred = [0, a, b, (a + b) // 2, paeth][ftype]
            out[r, i] = (x[r, i] - pred) % 256
    raw = b"".join(bytes([ftype]) + out[r].astype(np.uint8).tobytes() for r in range(h))

    def chunk(kind, body):
        crc = struct.pack(">I", zlib.crc32(kind + body))
        return struct.pack(">I", len(body)) + kind + body + crc

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", range(5), ids=["none", "sub", "up", "average", "paeth"])
def test_png_row_filters(ftype):
    img = _image(9, 13, 3, np.uint8, seed=ftype)
    data = _png_with_filter(img, ftype)
    np.testing.assert_array_equal(png_decode(data), img)
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(data, np.uint8),
                                               cv2.IMREAD_UNCHANGED), img[..., ::-1])


def test_imresize_matches_cv2_bit_for_bit():
    """Random sizes and scales, 1, 3 and 4 channels, up and down, and exact
    2x downscales (cv2's switch to INTER_AREA); then imrescale as the
    pipeline's Resize calls it (keep ratio, to 256)."""
    rng = np.random.default_rng(0)
    for trial in range(150):
        h, w = (int(v) for v in rng.integers(4, 260, 2))
        c = (1, 3, 4)[trial % 3]
        if trial % 5 == 0:
            oh, ow = h // 2, w // 2
            h, w = 2 * oh, 2 * ow
        else:
            oh, ow = (int(v) for v in rng.integers(2, 300, 2))
        img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
        img = img[..., 0] if c == 1 else img
        want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
        got, sx, sy = imresize(img, (oh, ow))
        np.testing.assert_array_equal(got, want, err_msg=f"{(h, w, c)} -> {(oh, ow)}")
        assert (sx, sy) == (ow / w, oh / h)
    patch = rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)  # an exact 2x
    for shape in ((512, 512), (300, 217), (97, 143)):
        p = np.ascontiguousarray(patch[:shape[0], :shape[1]])
        got, f = imrescale(p, 256)
        want = cv2.resize(p, (int(shape[1] * f + 0.5), int(shape[0] * f + 0.5)),
                          interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(got, want)


def test_mask_resize_matches_cv2_nearest():
    rng = np.random.default_rng(1)
    for trial in range(40):
        h, w = (int(v) for v in rng.integers(3, 200, 2))
        oh, ow = (int(v) for v in rng.integers(2, 300, 2))
        m = (rng.uniform(size=(2, h, w)) > 0.5).astype(np.uint8)
        got = BitmapMasks(m, h, w).resize((oh, ow)).masks
        want = np.stack([cv2.resize(x, (ow, oh), interpolation=cv2.INTER_NEAREST) for x in m])
        np.testing.assert_array_equal(got, want)


def _box_keypoints():
    return np.array([[x, y, z] for x in (-40, 50) for y in (-30, 35) for z in (-60, 45)],
                    np.float32)


def _pose(i, rng):
    from scipy.spatial.transform import Rotation

    R = Rotation.random(random_state=i).as_matrix().astype(np.float32)
    t = np.array([rng.normal() * 50, rng.normal() * 50, 700 + rng.normal() * 100], np.float32)
    return R, t


def test_remap_pose_recovers_a_camera_motion_as_cv2_does():
    """Where an exact pose exists (dst K = M src K: the 2D transform is the
    change of intrinsics), both solves return the source pose."""
    rng = np.random.default_rng(2)
    kp = _box_keypoints()
    for i in range(20):
        R, t = _pose(i, rng)
        f = rng.uniform(0.5, 2.0)
        M = np.array([[f, 0, -f * 200], [0, f, -f * 120], [0, 0, 1]], np.float32)
        dstK = M @ YCBV_K
        for solve in (remap_pose, jhost.remap_pose):
            nr, nt, err = solve(YCBV_K, R, t, kp, dstK, M)
            np.testing.assert_allclose(nr, R, atol=1e-4)
            np.testing.assert_allclose(nt, t, atol=2e-2)
            assert err < 1e-2


@pytest.mark.parametrize("mode", ["keep", "target"])
def test_remap_pose_against_cv2_epnp(mode):
    """A crop scaled by f under the same K (keep: dst K = src K; target: a
    256^2 patch's K) is not a camera motion, so no pose fits the 8
    keypoints exactly and the answer is the solver's own: the port's
    (cv_pnp's EPnP, then cv2.Rodrigues rebuilt) equals the JAX package's
    cv2.solvePnP(SOLVEPNP_EPNP) bit for bit, error included, on 50 draws;
    and remap_pose_to_origin_resolution too."""
    rng = np.random.default_rng(3)
    kp = _box_keypoints()
    dstK = YCBV_K if mode == "keep" else np.array(
        [[1066.778, 0, 128], [0, 1067.487, 128], [0, 0, 1]], np.float32)
    Rs, ts, Ms = [], [], []
    for i in range(50):
        R, t = _pose(i, rng)
        f = rng.uniform(0.8, 2.0)
        M = np.array([[f, 0, -f * rng.uniform(100, 400)], [0, f, -f * rng.uniform(100, 300)],
                      [0, 0, 1]], np.float32)
        got = remap_pose(YCBV_K, R, t, kp, dstK, M)
        want = jhost.remap_pose(YCBV_K, R, t, kp, dstK, M)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=str(i))
        Rs.append(R)
        ts.append(t)
        Ms.append(M)
    meta = dict(geometry_transform_mode=f"{mode}_intrinsic", keypoints_3d=np.stack([kp] * 50),
                transform_matrix=np.linalg.inv(np.stack(Ms)), ori_k=dstK)
    ks = np.stack([YCBV_K] * 50)
    got = remap_pose_to_origin_resolution(np.stack(Rs), np.stack(ts), ks, meta)
    want = jhost.remap_pose_to_origin_resolution(np.stack(Rs), np.stack(ts), ks, meta)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_remap_pose_failure_keeps_the_source_pose(monkeypatch):
    """Where the solve fails (cv2.solvePnP's retval False in the JAX
    package, solve_pnp_epnp's in the port) both warn and return the source
    pose with an error of -1.0; a degenerate keypoint set (all at one
    point), which cv2's EPnP does not call a failure, gives both the same
    NaN translation."""
    from scflow_tpu_torch import host_geometry

    kp = _box_keypoints()
    R, t = _pose(0, np.random.default_rng(0))
    M = np.eye(3, dtype=np.float32)
    monkeypatch.setattr(jhost.cv2, "solvePnP", lambda *a, **k: (False, None, None))
    monkeypatch.setattr(host_geometry, "solve_pnp_epnp", lambda *a: (False, None, None))
    for solve in (remap_pose, jhost.remap_pose):
        with pytest.warns(UserWarning, match="keeping source pose"):
            nr, nt, err = solve(YCBV_K, R, t, kp, YCBV_K, M)
        assert nr is R and nt is t and err == -1.0
    monkeypatch.undo()
    flat = np.zeros_like(kp)
    with np.errstate(all="ignore"):
        got = remap_pose(YCBV_K, R, t, flat, YCBV_K, M)
        want = jhost.remap_pose(YCBV_K, R, t, flat, YCBV_K, M)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


if __name__ == "__main__":
    # python3 tests/test_torch_workflow_imops.py: imread's time on a 640x480
    # 8-bit BGR PNG that cv2 wrote (libpng's adaptive row filters), beside
    # cv2.imread's, median of 20 reads each
    import statistics
    import tempfile
    import time

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/frame.png"
        cv2.imwrite(path, _image(480, 640, 3, np.uint8))
        for name, read in (("imread", lambda: imread(path, "unchanged")),
                           ("cv2.imread", lambda: cv2.imread(path, cv2.IMREAD_UNCHANGED))):
            times = []
            for _ in range(20):
                t0 = time.perf_counter()
                read()
                times.append(1e3 * (time.perf_counter() - t0))
            print(f"{name}: {statistics.median(times):.2f} ms")
