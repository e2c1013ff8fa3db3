"""The BitmapMasks methods and colour transforms that the PBR and occlusion
recipes reach, against the JAX package's (cv2-backed) on the same inputs
and seeds, bit for bit: each of the 11 mask methods added with them
(warpaffine, flip, expand, translate, shear, rotate, crop_and_resize,
cal_iof, get_bboxes, get_background_mask, merge_background_mask) and
rescale/resize with their interpolation argument; RandomSharpness,
RandomGray, RandomBackground (over a background directory of JPEG and PNG
files of other sizes, one with an EXIF orientation, and an unreadable
one), RandomOcclusion and RandomOcclusionV2."""

import struct
import warnings

import cv2
import numpy as np
import pytest

from scflow_tpu.datasets.mask import BitmapMasks as JMasks
from scflow_tpu.datasets.pipelines import color as jcolor
from scflow_tpu_torch.datasets.mask import BitmapMasks
from scflow_tpu_torch.datasets.pipelines import color

from torch_port_helpers import keep_torch_rng  # noqa: F401
from torch_train_helpers import assert_same, keep_global_rngs, seed_all  # noqa: F401

H, W = 40, 52


def _masks(n: int = 3, h: int = H, w: int = W, seed: int = 0) -> np.ndarray:
    """n uint8 masks of ellipses at random places (one of them empty)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, h, w), np.uint8)
    for i in range(n - 1):
        cv2.ellipse(out[i], (int(rng.integers(5, w - 5)), int(rng.integers(5, h - 5))),
                    (int(rng.integers(3, 15)), int(rng.integers(3, 12))),
                    float(rng.uniform(0, 180)), 0, 360, 1, -1)
    return out


def _pair(arr):
    return BitmapMasks(arr, arr.shape[1], arr.shape[2]), JMasks(arr, arr.shape[1], arr.shape[2])


ROT = cv2.getRotationMatrix2D((20.5, 17.0), 33.0, 1.2)
METHODS = {
    "warpaffine": lambda m: m.warpaffine(ROT, 60, 45),
    "flip_horizontal": lambda m: m.flip("horizontal"),
    "flip_vertical": lambda m: m.flip("vertical"),
    "flip_diagonal": lambda m: m.flip("diagonal"),
    "expand": lambda m: m.expand(60, 70, 7, 11),
    "translate_h": lambda m: m.translate((H, W), 5.5),
    "translate_v_nearest": lambda m: m.translate((H, W), -3.25, "vertical", 0, "nearest"),
    "translate_lanczos": lambda m: m.translate((H, W), 2.5, "horizontal", 0, "lanczos"),
    "shear_h": lambda m: m.shear((H, W), 0.3),
    "shear_v_area": lambda m: m.shear((H + 5, W), -0.2, "vertical", 0, "area"),
    "rotate": lambda m: m.rotate((H, W), 30.0),
    "rotate_center_scale": lambda m: m.rotate((50, 50), -75.0, (10.0, 12.5), 1.5, fill_val=1),
    "crop_and_resize": lambda m: m.crop_and_resize(
        np.array([[3.2, 4.5, 30.0, 33.1], [-5.0, 2.0, 20.5, 45.0]]), (14, 18), [0, 1]),
    "cal_iof": lambda m: m.cal_iof(_masks(2, seed=5)[0]),
    "cal_iof_empty": lambda m: m.cal_iof(np.zeros((H, W), np.uint8)),
    "get_bboxes": lambda m: m.get_bboxes(),
    "get_background_mask": lambda m: m.get_background_mask(),
    "merge_background_mask": lambda m: m.merge_background_mask(_masks(2, seed=6)[0]),
    "rescale_nearest": lambda m: m.rescale((30, 80)),
    "rescale_linear": lambda m: m.rescale(37, 1),
    "resize_nearest": lambda m: m.resize((23, 61), 0),
    "resize_linear": lambda m: m.resize((23, 61), cv2.INTER_LINEAR),
    "resize_empty": lambda m: m[[]].resize((10, 12), 1),
}


@pytest.fixture(autouse=True)
def seeded():
    seed_all(0)


@pytest.mark.parametrize("method", list(METHODS))
def test_mask_method_matches_jax(method):
    arr = _masks() * (255 if method.endswith("linear") else 1)
    got, want = (METHODS[method](m) for m in _pair(arr))
    assert_same(got, want, method)


def test_mask_resize_names_its_unported_interpolations():
    with pytest.raises(NotImplementedError, match="nearest and bilinear"):
        BitmapMasks(_masks(), H, W).resize((10, 10), cv2.INTER_CUBIC)


def _patches(n: int = 3, seed: int = 0):
    """n uint8 BGR patches of noise over colour ramps and their one-mask
    BitmapMasks, for the port and for JAX."""
    rng = np.random.default_rng(seed)
    imgs, port, jax_ = [], [], []
    for i in range(n):
        h, w = 30 + 5 * i, 40 - 3 * i
        y, x = np.mgrid[:h, :w]
        img = np.stack([x * 6, y * 8, (x + y) * 3], -1) + rng.normal(0, 12, (h, w, 3))
        imgs.append(np.clip(img, 0, 255).astype(np.uint8))
        m = _masks(2, h, w, seed=seed + i)[:1]
        port.append(BitmapMasks(m, h, w))
        jax_.append(JMasks(m, h, w))
    return imgs, port, jax_


def _run(port_t, jax_t, results_port, results_jax, seeds=range(4)):
    for s in seeds:
        seed_all(s)
        want = jax_t(dict(results_jax))
        seed_all(s)
        got = port_t(dict(results_port))
        assert_same(got, want, f"seed {s}")


@pytest.mark.parametrize("kernel_sizes", [(5, 7, 9, 11), (3,)])
def test_random_sharpness_matches_jax(kernel_sizes):
    imgs, _, _ = _patches()
    for p in (1.0, 0.5):
        _run(color.RandomSharpness(kernel_sizes, p=p), jcolor.RandomSharpness(kernel_sizes, p=p),
             {"img": imgs}, {"img": imgs}, seeds=range(8))


def test_random_gray_matches_jax():
    imgs, _, _ = _patches()
    _run(color.RandomGray(p=0.5), jcolor.RandomGray(p=0.5), {"img": imgs}, {"img": imgs})
    whole = imgs[0]
    _run(color.RandomGray(patch_level=False), jcolor.RandomGray(patch_level=False),
         {"img": whole}, {"img": whole})


def _exif_jpeg(img: np.ndarray, orientation: int) -> bytes:
    ok, buf = cv2.imencode(".jpg", img)
    tiff = (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIH", 0x0112, 3, 1, orientation) + b"\x00\x00"
            + struct.pack("<I", 0))
    body = b"Exif\x00\x00" + tiff
    return buf.tobytes()[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body \
        + buf.tobytes()[2:]


@pytest.fixture
def background_dir(tmp_path):
    """JPEGs and PNGs of other sizes than the patches (one JPEG with EXIF
    orientation 6, one 'JPEG' that is not an image), and a text file the
    glob skips."""
    rng = np.random.default_rng(3)
    d = tmp_path / "coco"
    d.mkdir()
    for i, (h, w) in enumerate([(48, 64), (25, 33), (60, 45)]):
        cv2.imwrite(str(d / f"bg_{i}.jpg"), rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        cv2.imwrite(str(d / f"bg_{i}.png"), rng.integers(0, 256, (w, h, 3)).astype(np.uint8))
    (d / "rotated.jpg").write_bytes(_exif_jpeg(rng.integers(0, 256, (20, 50, 3)).astype(
        np.uint8), 6))
    (d / "zz_broken.jpg").write_bytes(b"\x00" * 64)
    (d / "notes.txt").write_text("not a background")
    return d


def test_random_background_matches_jax(background_dir):
    imgs, port_masks, jax_masks = _patches()
    port_t = color.RandomBackground(str(background_dir), p=0.7)
    jax_t = jcolor.RandomBackground(str(background_dir), p=0.7)
    assert port_t.backgrounds == jax_t.backgrounds
    swapped = warned = 0
    for s in range(12):
        seed_all(s)
        want, jw = _recording_warnings(jax_t, {"img": imgs, "gt_masks": jax_masks})
        seed_all(s)
        got, pw = _recording_warnings(port_t, {"img": imgs, "gt_masks": port_masks})
        assert_same(got["img"], want["img"], f"seed {s}")
        assert pw == jw, f"seed {s}: the same warnings"
        swapped += sum(not np.array_equal(a, b) for a, b in zip(got["img"], imgs))
        warned += len(pw)
    assert swapped > 0 and warned > 0


def _recording_warnings(transform, results):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = transform(results)
    return out, [str(w.message) for w in caught]


def test_random_background_raises_on_a_file_cv2_reads_and_the_port_cannot(tmp_path):
    d = tmp_path / "bg"
    d.mkdir()
    ok, buf = cv2.imencode(".jpg", np.zeros((20, 20, 3), np.uint8),
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    (d / "progressive.jpg").write_bytes(buf.tobytes())
    imgs, port_masks, _ = _patches(1)
    with pytest.raises(NotImplementedError, match="progressive"):
        color.RandomBackground(str(d), p=1.0)({"img": imgs, "gt_masks": port_masks})


def test_random_occlusion_matches_jax():
    imgs, port_masks, jax_masks = _patches()
    bboxes = np.array([[2.0, 3.0, 30.0, 25.0], [5.0, 1.0, 9.0, 4.0], [0.0, 0.0, 34.0, 40.0]],
                      np.float32)
    for p in (1.0, 0.6):
        _run(color.RandomOcclusion(p=p), jcolor.RandomOcclusion(p=p),
             {"img": imgs, "gt_bboxes": bboxes, "gt_masks": port_masks},
             {"img": imgs, "gt_bboxes": bboxes, "gt_masks": jax_masks}, seeds=range(6))


def test_random_occlusion_v2_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    for i, (h, w) in enumerate([(60, 80), (48, 64)]):
        occ = np.zeros((h, w, 3), np.uint8)
        cv2.circle(occ, (w // 2, h // 2), min(h, w) // 3, tuple(int(v) for v in
                   rng.integers(30, 256, 3)), -1)
        cv2.imwrite(str(tmp_path / f"occ_{i}.png"), occ)
    (tmp_path / "list.txt").write_text("occ_0.png\nocc_1.png\n")
    img = np.clip(rng.normal(120, 40, (48, 64, 3)), 0, 255).astype(np.uint8)
    obj = _masks(2, 48, 64, seed=8)[:1]
    args = dict(augment_mask_field="gt_masks", data_root=str(tmp_path),
                image_list=str(tmp_path / "list.txt"))
    _run(color.RandomOcclusionV2(**args), jcolor.RandomOcclusionV2(**args),
         {"img": img, "gt_masks": BitmapMasks(obj, 48, 64)},
         {"img": img, "gt_masks": JMasks(obj, 48, 64)}, seeds=range(8))


def test_registered_under_the_jax_names():
    from scflow_tpu_torch.registry import PIPELINES

    for name in ("RandomSharpness", "RandomGray", "RandomBackground", "RandomOcclusion",
                 "RandomOcclusionV2"):
        assert PIPELINES.get(name) is getattr(color, name)
