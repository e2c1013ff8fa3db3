"""imops' replacements of cv2's affine warp and its helpers against cv2 5.0:
warp_affine with each interpolation on uint8 images of 1 and 3 channels,
random and adversarial matrices (half-pixel shifts, shears, right-angle
rotations, whose coordinates land on rounding ties) and a constant border
(bit for bit, but bicubic, within the bound below), get_rotation_matrix_2d,
normalize_minmax on float32 and float64, bgr2gray over every BGR triple
and gray2bgr."""

import cv2
import numpy as np
import pytest

from scflow_tpu_torch.datasets.pipelines import imops

from torch_port_helpers import keep_torch_rng  # noqa: F401
from torch_train_helpers import keep_global_rngs, seed_all  # noqa: F401

FLAGS = {"nearest": cv2.INTER_NEAREST, "bilinear": cv2.INTER_LINEAR,
         "bicubic": cv2.INTER_CUBIC, "area": cv2.INTER_AREA, "lanczos": cv2.INTER_LANCZOS4}
# cv2 5's bicubic warp computes its weights in a way this port does not
# reproduce exactly: at most this share of the values differ, by one level
BICUBIC_SHARE, BICUBIC_LEVELS = 1e-3, 1


@pytest.fixture(autouse=True)
def seeded():
    seed_all(0)


def _cases(seed: int, n: int = 25):
    """(image, matrix, (w, h), border) with images of noise or of a 0/255
    mask, and matrices of five kinds."""
    rng = np.random.default_rng(seed)
    for trial in range(n):
        h, w = (int(v) for v in rng.integers(10, 70, 2))
        img = (rng.integers(0, 256, (h, w)) if trial % 3 == 0
               else (rng.random((h, w)) > 0.5) * 255).astype(np.uint8)
        kind = trial % 5
        if kind == 0:
            m = np.float32([[1, 0, rng.choice([0.5, -0.5, 1.5, 2.25, -3.75, 0.1])],
                            [0, 1, rng.choice([0.5, 0.25, -1.5, 0.3])]])
        elif kind == 1:
            m = np.float32([[1, rng.choice([0.5, 0.3, -0.2, 0.1, 0.7]), 0], [0, 1, 0]])
        elif kind == 2:
            m = np.float32([[1, 0, 0], [rng.choice([0.5, 0.3, -0.2, 0.9]), 1, 0]])
        elif kind == 3:
            m = cv2.getRotationMatrix2D(((w - 1) * 0.5, (h - 1) * 0.5),
                                        float(rng.choice([-30, 45, 90, 60, 180, 15])),
                                        float(rng.choice([1.0, 0.5, 2.0, 1.5, 0.7])))
        else:
            m = cv2.getRotationMatrix2D((float(rng.integers(0, w)), float(rng.integers(0, h))),
                                        float(rng.uniform(-180, 180)), float(rng.uniform(0.5, 2)))
            m[:, 2] += rng.uniform(-10, 10, 2)
        size = (w, h) if trial % 3 else (int(rng.integers(10, 70)), int(rng.integers(10, 70)))
        yield img, m, size, (0 if trial % 4 else 77)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("interpolation", list(FLAGS))
def test_warp_affine_matches_cv2(interpolation, channels):
    differ = total = worst = 0
    for img, m, size, border in _cases(10 * channels + list(FLAGS).index(interpolation)):
        if channels == 3:
            img = np.ascontiguousarray(np.stack([img, img[::-1], img[:, ::-1]], axis=-1))
        cv_border = (border,) * 3 if channels == 3 else border
        want = cv2.warpAffine(img, m, size, flags=FLAGS[interpolation], borderValue=cv_border)
        got = imops.warp_affine(img, m, size, interpolation, border)
        assert got.shape == want.shape and got.dtype == np.uint8
        d = np.abs(got.astype(np.int64) - want)
        differ += int((d > 0).sum())
        total += d.size
        worst = max(worst, int(d.max()))
    if interpolation == "bicubic":
        assert worst <= BICUBIC_LEVELS and differ <= BICUBIC_SHARE * total, (worst, differ, total)
    else:
        assert differ == 0, (differ, total, worst)


def test_get_rotation_matrix_2d_matches_cv2():
    rng = np.random.default_rng(1)
    for _ in range(500):
        c = (float(rng.uniform(-100, 300)), float(rng.uniform(-100, 300)))
        a, s = float(rng.uniform(-360, 360)), float(rng.uniform(0.1, 3))
        np.testing.assert_array_equal(imops.get_rotation_matrix_2d(c, a, s),
                                      cv2.getRotationMatrix2D(c, a, s))
    np.testing.assert_array_equal(imops.get_rotation_matrix_2d((np.float32(3.3), 7.1), 90, 1),
                                  cv2.getRotationMatrix2D((np.float32(3.3), 7.1), 90, 1))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_normalize_minmax_matches_cv2(dtype):
    """The values, and the uint8 truncation RandomSharpness takes of them."""
    rng = np.random.default_rng(2)
    for _ in range(100):
        shape = (int(rng.integers(1, 40)), int(rng.integers(1, 40)), 3)
        x = (rng.normal(0, rng.uniform(0.1, 100), shape) + rng.uniform(-50, 50)).astype(dtype)
        want = cv2.normalize(x, None, alpha=0, beta=255, norm_type=cv2.NORM_MINMAX)
        got = imops.normalize_minmax(x)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got.astype(np.uint8), want.astype(np.uint8))
    flat = np.full((4, 5, 3), 7.0, dtype)
    np.testing.assert_array_equal(imops.normalize_minmax(flat),
                                  cv2.normalize(flat, None, 0, 255, cv2.NORM_MINMAX))


def test_bgr2gray_over_every_triple():
    v = np.arange(1 << 24, dtype=np.uint32)
    img = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8)
    img = img.reshape(4096, 4096, 3)
    np.testing.assert_array_equal(imops.bgr2gray(img), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    g = img[:64, :64, 1]
    np.testing.assert_array_equal(imops.gray2bgr(g), cv2.cvtColor(g, cv2.COLOR_GRAY2BGR))
