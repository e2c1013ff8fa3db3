"""The image readers behind imops.imread that a user's data reaches beyond
baseline JPEG and plain PNG, against cv2.imread (cv2 5.0.0, libjpeg-turbo
3.1.2, libpng) bit for bit under 'unchanged', 'color' and 'grayscale':

- progressive JPEGs (4:2:0, 4:2:2 and 4:4:4, with and without restart
  intervals, Huffman tables redefined between scans, grey), a progressive
  file cut in its last scan (a refinement scan; inside an interval and at
  an RST marker), and cut earlier, where libjpeg runs its block smoothing
  and the port raises; a baseline file cut inside an RST marker;
  multi-scan sequential files;
- CMYK and YCCK JPEGs (PIL's, its Adobe transform byte set to 2 for YCCK,
  and one without the marker), baseline and progressive;
- palette PNGs of 2, 16 and 256 colours at 1, 2, 4 and 8 bits, with and
  without tRNS; 1-, 2- and 4-bit grey with and without tRNS; RGB with
  tRNS; Adam7-interlaced PNGs of each kind; 'grayscale' of colour PNGs
  (libpng's rgb_to_gray, not cvtColor's rounding), 8- and 16-bit;
- 1-, 4- and 8-bit palette BMPs (colour and grey palettes), 24-bit,
  32-bit BI_RGB and cv2's BI_BITFIELDS, bottom-up and top-down, odd widths;
  RLE and 16-bit BMPs raise NotImplementedError naming the file;
- RandomBackground and LoadImages over files of these kinds against the
  JAX package's (cv2-backed) transforms;
- tests/data/torch_decode's fixtures (chip_smoke.py's backgrounds):
  digests.json against cv2, and the port's imread against the digests.
The inputs come from a numpy seed, written by cv2, PIL or
tests/torch_image_writers.py."""

import hashlib
import io
import json
import re
import struct
import warnings
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from scflow_tpu.datasets.mask import BitmapMasks as JMasks
from scflow_tpu.datasets.pipelines import color as jcolor
from scflow_tpu.datasets.pipelines import loading as jloading
from scflow_tpu_torch.datasets.mask import BitmapMasks
from scflow_tpu_torch.datasets.pipelines import color, imops, jpeg, loading

from torch_image_writers import write_bmp, write_png
from torch_port_helpers import keep_torch_rng  # noqa: F401
from torch_train_helpers import assert_same, keep_global_rngs, seed_all  # noqa: F401

FLAGS = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "grayscale": cv2.IMREAD_GRAYSCALE}
SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
FIXTURES = Path(__file__).resolve().parent / "data" / "torch_decode"


def _image(h: int, w: int, seed: int = 0, noise: float = 20.0) -> np.ndarray:
    """Colour ramps with a diagonal pattern and Gaussian noise, uint8 BGR."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), ((x + y) * 3) % 256],
                    axis=-1).astype(np.float64)
    return np.clip(base + rng.normal(0, noise, base.shape), 0, 255).astype(np.uint8)


def _same_as_cv2(tmp_path, data: bytes, name: str = "x.jpg") -> None:
    path = tmp_path / name
    path.write_bytes(data)
    for flag, code in FLAGS.items():
        want = cv2.imread(str(path), code)
        assert want is not None, flag
        got = imops.imread(str(path), flag)
        assert got.dtype == want.dtype and got.shape == want.shape, (flag, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=flag)


def _encode(img, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def _progressive(img, *params) -> bytes:
    return _encode(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1, *params)


# --- progressive JPEG ------------------------------------------------------

@pytest.mark.parametrize("interval", [0, 2])
@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("hw", [(61, 97), (5, 3)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_progressive_matches_cv2(tmp_path, hw, sampling, interval):
    data = _progressive(_image(*hw), cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                        cv2.IMWRITE_JPEG_RST_INTERVAL, interval)
    assert data[2:].count(b"\xff\xda") == 10  # libjpeg's progression: 10 scans
    _same_as_cv2(tmp_path, data)


def test_progressive_grey_and_pil_files_match_cv2(tmp_path):
    """A grey progressive file (six scans), and PIL's optimized progressive
    file, whose Huffman tables change between its scans."""
    grey = cv2.cvtColor(_image(61, 97), cv2.COLOR_BGR2GRAY)
    _same_as_cv2(tmp_path, _progressive(grey, cv2.IMWRITE_JPEG_QUALITY, 80))
    b = io.BytesIO()
    Image.fromarray(_image(70, 130, seed=2)[..., ::-1].copy()).save(
        b, "JPEG", quality=90, progressive=True, optimize=True)
    data = b.getvalue()
    assert data.count(b"\xff\xc4") > 2
    _same_as_cv2(tmp_path, data)


def _scan_starts(data: bytes):
    return [m.start() for m in re.finditer(b"\xff\xda", data)]


@pytest.mark.parametrize("interval", [0, 1])
def test_progressive_cut_in_its_last_scan_matches_cv2(tmp_path, interval):
    """The last scan (the luma's final refinement): zero bits for the MCU
    that ran out, the rest as the earlier scans left it; with one MCU per
    interval, a cut inside an RST marker leaves the next MCU to read zero
    bits from an empty interval."""
    data = _progressive(_image(64, 96, seed=1), cv2.IMWRITE_JPEG_RST_INTERVAL, interval)
    last = _scan_starts(data)[-1]
    cuts = [last + 40, (last + len(data)) // 2, len(data) - 40]
    if interval:
        rst = [m.start() for m in re.finditer(b"\xff[\xd0-\xd7]", data[last:])]
        cuts.append(last + rst[len(rst) // 2] + 1)  # between the marker's two bytes
    for cut in cuts:
        path = tmp_path / "cut.jpg"
        path.write_bytes(data[:cut])
        for flag, code in FLAGS.items():
            want = cv2.imread(str(path), code)
            np.testing.assert_array_equal(imops.imread(str(path), flag), want,
                                          err_msg=f"cut {cut} {flag}")


@pytest.mark.parametrize("interval", [1, 3])
def test_sequential_cut_inside_an_rst_marker_matches_cv2(tmp_path, interval):
    """A baseline file cut between an RST marker's two bytes: libjpeg finds
    no marker, decodes the next interval's first MCU from an empty segment
    (zero bits) and leaves the rest grey."""
    data = _encode(_image(64, 96, seed=1), cv2.IMWRITE_JPEG_RST_INTERVAL, interval)
    start = _scan_starts(data)[0]
    rst = [m.start() for m in re.finditer(b"\xff[\xd0-\xd7]", data[start:])]
    for at in (rst[len(rst) // 3], rst[2 * len(rst) // 3]):
        path = tmp_path / "cut.jpg"
        path.write_bytes(data[:start + at + 1])
        for flag, code in FLAGS.items():
            np.testing.assert_array_equal(imops.imread(str(path), flag),
                                          cv2.imread(str(path), code), err_msg=f"{at} {flag}")


@pytest.mark.parametrize("scan", [0, 5], ids=["first_scan", "refine_scan"])
def test_progressive_cut_earlier_raises_where_libjpeg_smooths(tmp_path, scan):
    """A cut in the DC scan or in the luma's first AC refinement leaves low
    coefficients short of their last bit: libjpeg smooths those blocks'
    DC and low AC from their neighbours (cv2 reads the file), which the
    port does not do, so it raises NotImplementedError naming the file."""
    data = _progressive(_image(64, 96, seed=1))
    start = _scan_starts(data)[scan]
    path = tmp_path / "cut.jpg"
    path.write_bytes(data[:start + 60])
    assert cv2.imread(str(path), cv2.IMREAD_COLOR) is not None
    with pytest.raises(NotImplementedError, match="smoothing") as info:
        imops.imread(str(path), "color")
    assert str(path) in str(info.value)


def _multiscan_jpeg(seed: int, h: int = 37, w: int = 40, split_chroma: bool = False) -> bytes:
    """A sequential 4:2:0 JPEG in several scans: Y alone (non-interleaved,
    over its own block grid, narrower than the MCU-padded one at w=40), then
    Cb and Cr interleaved (or each alone), from random quantized
    coefficients under a table of ones; the Annex K Huffman tables, packed
    by the port's encoder (jpeg._huffman_stream).  cv2 decodes it as the
    oracle."""
    rng = np.random.default_rng(seed)

    def coefs(n):
        zz = np.where(rng.random((n, 64)) < 0.15, rng.integers(-20, 21, (n, 64)), 0)
        zz[:, 0] = rng.integers(-60, 61, n)
        return zz

    my, mx = -(-h // 16), -(-w // 16)
    y_rows, y_cols = -(-h // 8), -(-w // 8)
    dc_tabs = [jpeg._encode_table(*jpeg.STD_HUFFMAN[(0, t)]) for t in range(2)]
    ac_tabs = [jpeg._encode_table(*jpeg.STD_HUFFMAN[(1, t)]) for t in range(2)]

    def seg(marker, body):
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    def scan(comp_ids, zz, comp_of_block):
        tables = np.array([0] + [1] * 3)
        data = jpeg._huffman_stream(zz, comp_of_block, tables, dc_tabs, ac_tabs)
        sos = bytes([len(comp_ids)]) + b"".join(
            bytes([c, 0x00 if c == 1 else 0x11]) for c in comp_ids) + b"\x00\x3f\x00"
        return seg(0xDA, sos) + data

    out = [b"\xff\xd8", seg(0xDB, bytes([0]) + bytes([1] * 64)),
           seg(0xC0, struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 0,
                                                               3, 0x11, 0]))]
    for (tc, th), (counts, syms) in sorted(jpeg.STD_HUFFMAN.items()):
        out.append(seg(0xC4, bytes([(tc << 4) | th]) + bytes(counts) + syms))
    n_y = y_rows * y_cols
    out.append(scan([1], coefs(n_y), np.zeros(n_y, np.int64)))
    if split_chroma:
        for c in (2, 3):
            out.append(scan([c], coefs(my * mx), np.full(my * mx, c - 1)))
    else:
        out.append(scan([2, 3], coefs(2 * my * mx), np.tile([1, 2], my * mx)))
    return b"".join(out + [b"\xff\xd9"])


@pytest.mark.parametrize("split_chroma", [False, True], ids=["chroma_interleaved", "3_scans"])
def test_multiscan_sequential_matches_cv2(tmp_path, split_chroma):
    _same_as_cv2(tmp_path, _multiscan_jpeg(3, split_chroma=split_chroma))


# --- four-component JPEG -----------------------------------------------------

def _pil_cmyk(img: np.ndarray, quality: int, progressive: bool = False) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img[..., ::-1].copy()).convert("CMYK").save(
        b, "JPEG", quality=quality, progressive=progressive)
    return b.getvalue()


def _adobe_transform(data: bytes, transform) -> bytes:
    """The file with its Adobe APP14 marker's transform byte set, or the
    marker removed (transform None)."""
    at = data.index(b"\xff\xee")
    (length,) = struct.unpack(">H", data[at + 2:at + 4])
    if transform is None:
        return data[:at] + data[at + 2 + length:]
    out = bytearray(data)
    out[at + 4 + 11] = transform
    return bytes(out)


@pytest.mark.parametrize("kind", ["cmyk", "ycck", "no_adobe", "progressive"])
@pytest.mark.parametrize("quality", [50, 95])
def test_cmyk_and_ycck_match_cv2(tmp_path, kind, quality):
    """libjpeg takes a four-component file with Adobe transform 0 (or no
    marker) as CMYK and with transform 2 as YCCK (PIL cannot write YCCK:
    the byte is set on its CMYK file, a valid input all the same); cv2 asks
    for CMYK and converts it (IMREAD_UNCHANGED too gives 3 channels)."""
    data = _pil_cmyk(_image(45, 67, seed=quality), quality, progressive=kind == "progressive")
    if kind == "ycck":
        data = _adobe_transform(data, 2)
    elif kind == "no_adobe":
        data = _adobe_transform(data, None)
    _same_as_cv2(tmp_path, data)


# --- PNG -----------------------------------------------------------------------

PALETTES = [(1, 2), (2, 4), (4, 16), (8, 2), (8, 256)]


@pytest.mark.parametrize("trns", [False, True], ids=["opaque", "trns"])
@pytest.mark.parametrize("depth,colours", PALETTES, ids=[f"{d}bit_{n}" for d, n in PALETTES])
def test_png_palette_matches_cv2(tmp_path, depth, colours, trns):
    """'unchanged' gives BGR, or BGRA with the tRNS alphas (255 past
    them); 'grayscale' is libpng's rgb_to_gray of the palette colours."""
    rng = np.random.default_rng(depth * 1000 + colours)
    palette = rng.integers(0, 256, (colours, 3), dtype=np.uint8)
    idx = rng.integers(0, colours, (23, 37))
    alphas = rng.integers(0, 256, max(colours // 2, 1), dtype=np.uint8).tobytes() if trns else None
    _same_as_cv2(tmp_path, write_png(idx, 3, depth, palette=palette, trns=alphas), "x.png")


def test_pil_palette_png_matches_cv2(tmp_path):
    b = io.BytesIO()
    Image.fromarray(_image(40, 50, noise=4)[..., ::-1].copy()).quantize(colors=16).save(
        b, "PNG", transparency=3)
    _same_as_cv2(tmp_path, b.getvalue(), "x.png")


@pytest.mark.parametrize("trns", [False, True], ids=["opaque", "trns"])
@pytest.mark.parametrize("depth", [1, 2, 4, 16])
def test_png_grey_depths_match_cv2(tmp_path, depth, trns):
    """1-, 2- and 4-bit grey expanded to 8 bits as libpng does; a grey
    file's tRNS chunk changes nothing in cv2's reads."""
    rng = np.random.default_rng(depth)
    grey = rng.integers(0, 1 << depth, (19, 29))
    key = np.array([grey[0, 0]], ">u2").tobytes() if trns else None
    _same_as_cv2(tmp_path, write_png(grey, 0, depth, trns=key, seed=depth), "x.png")


@pytest.mark.parametrize("depth", [8, 16])
def test_png_rgb_with_trns_matches_cv2(tmp_path, depth):
    """'unchanged' reads an RGB file with tRNS as BGRA, alpha 0 on the key
    colour."""
    rng = np.random.default_rng(depth)
    rgb = rng.integers(0, 1 << depth, (17, 23, 3))
    rgb[3, :9] = rgb[0, 0]
    key = np.array(rgb[0, 0], ">u2").tobytes()
    _same_as_cv2(tmp_path, write_png(rgb, 2, depth, trns=key), "x.png")


ADAM7 = {"grey1": (0, 1), "grey8": (0, 8), "grey16": (0, 16), "rgb8": (2, 8),
         "rgba16": (6, 16), "grey_alpha8": (4, 8), "palette4": (3, 4)}


@pytest.mark.parametrize("kind", list(ADAM7))
def test_png_adam7_matches_cv2(tmp_path, kind):
    """Neither cv2 nor PIL writes Adam7: the test's writer does (each
    pass's rows filtered on their own), at a size where every pass has
    pixels and at sizes where some passes are empty."""
    ctype, depth = ADAM7[kind]
    rng = np.random.default_rng(ctype * 100 + depth)
    palette = rng.integers(0, 256, (16, 3), dtype=np.uint8) if ctype == 3 else None
    trns = bytes(range(0, 160, 20)) if ctype == 3 else None
    for h, w in [(29, 43), (1, 1), (3, 2), (1, 9), (9, 1)]:
        top = 16 if ctype == 3 else 1 << depth
        samples = rng.integers(0, top, (h, w, {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]))
        _same_as_cv2(tmp_path, write_png(samples, ctype, depth, palette=palette, trns=trns,
                                         interlace=True, seed=h), "x.png")


@pytest.mark.parametrize("channels,dtype", [(3, np.uint8), (4, np.uint8), (3, np.uint16),
                                            (4, np.uint16)])
def test_png_grey_read_of_colour_is_libpngs(tmp_path, channels, dtype):
    """cv2's 'grayscale' of a colour PNG is libpng's rgb_to_gray with
    OpenCV's weights (9797, 19234, 3737 over 2^15: truncated at 8 bits,
    rounded at 16, then the high byte), not cvtColor's: the two differ on
    these random pixels."""
    rng = np.random.default_rng(channels)
    img = rng.integers(0, np.iinfo(dtype).max + 1, (40, 60, channels)).astype(dtype)
    path = tmp_path / "x.png"
    cv2.imwrite(str(path), img)
    _same_as_cv2(tmp_path, path.read_bytes(), "x.png")
    if dtype == np.uint8 and channels == 3:
        assert (cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
                != cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)).any()


# --- BMP -----------------------------------------------------------------------

BMP_PALETTES = [(1, 2), (4, 16), (4, 5), (8, 256), (8, 37)]


@pytest.mark.parametrize("top_down", [False, True], ids=["bottom_up", "top_down"])
@pytest.mark.parametrize("grey", [False, True], ids=["colour", "grey_palette"])
@pytest.mark.parametrize("bpp,colours", BMP_PALETTES, ids=[f"{b}bit_{n}" for b, n in BMP_PALETTES])
def test_bmp_palette_matches_cv2(tmp_path, bpp, colours, grey, top_down):
    """A grey palette reads as one channel under 'unchanged'; indices past
    a short palette read black; rows padded to 4 bytes (odd widths)."""
    rng = np.random.default_rng(bpp * 100 + colours)
    palette = rng.integers(0, 256, (colours, 3), dtype=np.uint8)
    if grey:
        palette[:, 1:] = palette[:, :1]
    idx = rng.integers(0, min(1 << bpp, colours + 2), (13, 21))
    _same_as_cv2(tmp_path, write_bmp(idx, bpp, palette=palette, top_down=top_down), "x.bmp")


MASKS = {"bi_rgb": None, "bgra": (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
         "rgba": (0xFF, 0xFF00, 0xFF0000, 0xFF000000), "no_alpha": (0xFF0000, 0xFF00, 0xFF, 0)}


@pytest.mark.parametrize("top_down", [False, True], ids=["bottom_up", "top_down"])
@pytest.mark.parametrize("kind", ["24"] + [f"32_{m}" for m in MASKS])
def test_bmp_direct_colour_matches_cv2(tmp_path, kind, top_down):
    """24-bit; 32-bit BI_RGB (three channels under 'unchanged'); 32-bit
    BI_BITFIELDS with byte masks (four; its grey is OpenCV's float32 sum)."""
    rng = np.random.default_rng(len(kind))
    if kind == "24":
        data = write_bmp(rng.integers(0, 256, (11, 17, 3)), 24, top_down=top_down)
    else:
        data = write_bmp(rng.integers(0, 256, (11, 17, 4)), 32, top_down=top_down,
                         masks=MASKS[kind[3:]])
    _same_as_cv2(tmp_path, data, "x.bmp")


def test_cv2_and_pil_bmps_match_cv2(tmp_path):
    """The files cv2 (8-bit grey, 24-bit, 32-bit BI_BITFIELDS) and PIL (1,
    L, P, RGB, RGBA) write."""
    img = _image(19, 29, seed=4)
    bgra = np.concatenate([img, _image(19, 29, seed=5)[..., :1]], axis=-1)
    for a in (img[..., 0], img, bgra):
        ok, buf = cv2.imencode(".bmp", a)
        _same_as_cv2(tmp_path, buf.tobytes(), "x.bmp")
    for mode in ("1", "L", "P", "RGB", "RGBA"):
        b = io.BytesIO()
        Image.fromarray(img[..., ::-1].copy()).convert(mode).save(b, "BMP")
        _same_as_cv2(tmp_path, b.getvalue(), "x.bmp")


def _bmp_rle8() -> bytes:
    """A 4x4 BI_RLE8 BMP: each row one run of a colour, end of line, end of
    bitmap."""
    body = b"".join(bytes([4, i, 0, 0]) for i in range(4)) + b"\x00\x01"
    palette = bytes(np.arange(4, dtype=np.uint8).repeat(4) * 60)
    info = struct.pack("<IiiHHIIiiII", 40, 4, 4, 1, 8, 1, len(body), 2835, 2835, 4, 0)
    offset = 14 + 40 + 16
    return b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + info \
        + palette + body


def _bmp16() -> bytes:
    rows = np.arange(4 * 8, dtype="<u2").reshape(4, 8).tobytes()
    info = struct.pack("<IiiHHIIiiII", 40, 8, 4, 1, 16, 0, len(rows), 2835, 2835, 0, 0)
    return b"BM" + struct.pack("<IHHI", 54 + len(rows), 0, 0, 54) + info + rows


@pytest.mark.parametrize("kind", ["rle8", "16bit"])
def test_bmp_kinds_not_read_raise(tmp_path, kind):
    data, words = (_bmp_rle8(), "RLE8") if kind == "rle8" else (_bmp16(), "16-bit")
    path = tmp_path / "x.bmp"
    path.write_bytes(data)
    assert cv2.imread(str(path), cv2.IMREAD_COLOR) is not None
    with pytest.raises(NotImplementedError, match=words) as info:
        imops.imread(str(path), "color")
    assert str(path) in str(info.value)


# --- the pipeline's readers against the JAX package's ---------------------------

@pytest.fixture
def new_kinds(tmp_path):
    """A background folder of the new kinds at patch-like sizes: progressive
    and CMYK JPEGs, palette, 4-bit grey and Adam7 PNGs, a BMP named .png."""
    d = tmp_path / "coco"
    d.mkdir()
    rng = np.random.default_rng(7)
    (d / "prog.jpg").write_bytes(_progressive(_image(48, 64, seed=1), cv2.IMWRITE_JPEG_QUALITY,
                                              85))
    (d / "cmyk.jpg").write_bytes(_pil_cmyk(_image(40, 30, seed=2), 90))
    (d / "pal.png").write_bytes(write_png(rng.integers(0, 16, (35, 44)), 3, 4,
                                          palette=rng.integers(0, 256, (16, 3), dtype=np.uint8),
                                          trns=bytes(range(0, 256, 40))))
    (d / "grey4.png").write_bytes(write_png(rng.integers(0, 16, (31, 27)), 0, 4))
    (d / "adam7.png").write_bytes(write_png(rng.integers(0, 256, (33, 41, 3)), 2, 8,
                                            interlace=True))
    ok, buf = cv2.imencode(".bmp", _image(26, 39, seed=3))
    (d / "bmp.png").write_bytes(buf.tobytes())
    return d


def _patches(n: int = 3):
    rng = np.random.default_rng(0)
    imgs, port, jax_ = [], [], []
    for i in range(n):
        h, w = 30 + 5 * i, 40 - 3 * i
        imgs.append(_image(h, w, seed=10 + i))
        m = np.zeros((1, h, w), np.uint8)
        m[0, 5:h - 6, 4 + i:w - 5] = rng.integers(0, 2, (h - 11, w - 9 - i))
        port.append(BitmapMasks(m, h, w))
        jax_.append(JMasks(m, h, w))
    return imgs, port, jax_


def test_random_background_matches_jax_on_the_new_kinds(new_kinds, monkeypatch):
    """RandomBackground at p=1 swaps every patch for a file of the folder,
    as the JAX package's does with cv2; over these seeds it draws every
    file, and none falls back to "failed to load"."""
    imgs, port_masks, jax_masks = _patches()
    port_t = color.RandomBackground(str(new_kinds), p=1.0)
    jax_t = jcolor.RandomBackground(str(new_kinds), p=1.0)
    assert port_t.backgrounds == jax_t.backgrounds and len(port_t.backgrounds) == 6
    drawn = set()

    def recording(path, flag):
        drawn.add(Path(path).name)
        return imops.imread(path, flag)

    monkeypatch.setattr(color, "imread", recording)
    for s in range(8):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            seed_all(s)
            want = jax_t({"img": list(imgs), "gt_masks": jax_masks})
            seed_all(s)
            got = port_t({"img": list(imgs), "gt_masks": port_masks})
        assert_same(got["img"], want["img"], f"seed {s}")
    assert len(drawn) == 6, drawn


@pytest.mark.parametrize("color_type", list(FLAGS))
def test_load_images_matches_jax_on_the_new_kinds(new_kinds, color_type):
    for path in sorted(new_kinds.iterdir()):
        want = jloading.LoadImages(color_type=color_type)({"img_path": str(path)})
        got = loading.LoadImages(color_type=color_type)({"img_path": str(path)})
        assert got["img_shape"] == want["img_shape"], path.name
        np.testing.assert_array_equal(got["img"], want["img"], err_msg=path.name)


# --- the card's fixtures --------------------------------------------------------

def _digest(img: np.ndarray) -> dict:
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
            "shape": list(img.shape), "dtype": str(img.dtype)}


def test_fixture_digests_match_cv2_and_the_port():
    """digests.json holds cv2's decodes of the committed fixtures (so the
    files and the digests cannot drift apart), and the port's imread gives
    the same bytes; the folder stays under 1 MB."""
    digests = json.loads((FIXTURES / "digests.json").read_text())
    names = sorted(p.name for p in FIXTURES.iterdir() if p.suffix in (".jpg", ".png"))
    assert names == sorted(digests) and len(names) == 6
    assert sum(p.stat().st_size for p in FIXTURES.iterdir() if p.is_file()) < 1 << 20
    for name in names:
        for flag, code in FLAGS.items():
            assert _digest(cv2.imread(str(FIXTURES / name), code)) == digests[name][flag], \
                (name, flag)
            assert _digest(imops.imread(str(FIXTURES / name), flag)) == digests[name][flag], \
                (name, flag)
