"""The port's JPEG codec (scflow_tpu_torch/datasets/pipelines/jpeg.py, behind
imops.imread and imops.imwrite) against cv2 5.0 (libjpeg-turbo 3.1.2 here):
imread equals cv2.imread bit for bit on baseline files of every sampling
factor cv2 writes, two qualities, grey, restart intervals, odd sizes and
EXIF orientations 1-8 under each flag; a truncated file gives cv2's partial
image; the features the port does not read raise NotImplementedError
naming them; a corrupt entropy stream, which cv2 decodes past with a
warning, raises; a file cv2 returns None for raises DecodeError.  The
encoder's files decode in cv2 within a stated bound of cv2's own
quality-95 encoding of the same image."""

import struct

import cv2
import numpy as np
import pytest

from scflow_tpu_torch.datasets.pipelines import imops, jpeg

from torch_port_helpers import keep_torch_rng  # noqa: F401
from torch_train_helpers import keep_global_rngs, seed_all  # noqa: F401

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
FLAGS = {"color": cv2.IMREAD_COLOR, "grayscale": cv2.IMREAD_GRAYSCALE,
         "unchanged": cv2.IMREAD_UNCHANGED}


@pytest.fixture(autouse=True)
def seeded():
    seed_all(0)


def _image(h: int, w: int, seed: int = 0, noise: float = 20.0) -> np.ndarray:
    """Colour ramps with a sharp diagonal pattern and Gaussian noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), ((x + y) * 3) % 256],
                    axis=-1).astype(np.float64)
    return np.clip(base + rng.normal(0, noise, base.shape), 0, 255).astype(np.uint8)


def _encode(img, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def _both(tmp_path, data: bytes, flag: str = "color", name: str = "x.jpg"):
    path = tmp_path / name
    path.write_bytes(data)
    return imops.imread(str(path), flag), cv2.imread(str(path), FLAGS[flag])


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("hw", [(61, 97), (70, 130), (5, 3)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_colour_matches_cv2(tmp_path, hw, sampling, quality):
    data = _encode(_image(*hw), cv2.IMWRITE_JPEG_QUALITY, quality,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling])
    for flag in FLAGS:
        got, want = _both(tmp_path, data, flag)
        assert got.dtype == want.dtype and got.shape == want.shape, flag
        np.testing.assert_array_equal(got, want, err_msg=flag)


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("hw", [(61, 97), (70, 130)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_grey_matches_cv2(tmp_path, hw, quality):
    grey = cv2.cvtColor(_image(*hw), cv2.COLOR_BGR2GRAY)
    data = _encode(grey, cv2.IMWRITE_JPEG_QUALITY, quality)
    for flag in FLAGS:
        got, want = _both(tmp_path, data, flag)
        assert got.shape == want.shape, flag  # 'unchanged' stays (H, W)
        np.testing.assert_array_equal(got, want, err_msg=flag)


@pytest.mark.parametrize("interval", [1, 3])
def test_restart_interval_matches_cv2(tmp_path, interval):
    data = _encode(_image(61, 97), cv2.IMWRITE_JPEG_RST_INTERVAL, interval)
    assert b"\xff\xdd" in data  # a DRI segment
    got, want = _both(tmp_path, data)
    np.testing.assert_array_equal(got, want)


def _exif(orientation: int, order: str) -> bytes:
    """An APP1 Exif segment holding only IFD0's Orientation tag."""
    bo = b"II" if order == "<" else b"MM"
    tiff = (bo + struct.pack(order + "HI", 42, 8) + struct.pack(order + "H", 1)
            + struct.pack(order + "HHI", 0x0112, 3, 1) + struct.pack(order + "H", orientation)
            + b"\x00\x00" + struct.pack(order + "I", 0))
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_cv2(tmp_path, orientation):
    """'color' and 'grayscale' apply the tag, 'unchanged' ignores it; in a
    file that starts with it (APP1 before JFIF's APP0) and in one that
    carries it after APP0, little- and big-endian."""
    data = _encode(_image(21, 34))
    for order, at in (("<", 2), (">", 20)):
        tagged = data[:at] + _exif(orientation, order) + data[at:]
        for flag in FLAGS:
            got, want = _both(tmp_path, tagged, flag)
            assert got.shape == want.shape, (flag, order)
            np.testing.assert_array_equal(got, want, err_msg=f"{flag} {order}")


def _sof(data: bytes):
    """(offset, body) of the file's SOF0 segment."""
    at = data.index(b"\xff\xc0")
    (length,) = struct.unpack(">H", data[at + 2:at + 4])
    return at, data[at + 4:at + 2 + length]


def _with_sof(data: bytes, marker: int = 0xC0, precision: int = 8, components=None) -> bytes:
    at, body = _sof(data)
    h, w = struct.unpack(">HH", body[1:5])
    comps = body[6:] if components is None else b"".join(
        bytes([i + 1, 0x11, 0]) for i in range(components))
    new = struct.pack(">BHHB", precision, h, w, len(comps) // 3) + comps
    return (data[:at] + bytes([0xFF, marker]) + struct.pack(">H", len(new) + 2) + new
            + data[at + 2 + 2 + len(body):])


UNSUPPORTED = {
    "progressive": (lambda d: _encode(_image(30, 40), cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
                    "progressive"),
    "arithmetic": (lambda d: _with_sof(d, 0xC9), "arithmetic"),
    "lossless": (lambda d: _with_sof(d, 0xC3), "lossless"),
    "12-bit": (lambda d: _with_sof(d, precision=12), "12-bit"),
    "cmyk": (lambda d: _with_sof(d, components=4), "4 components"),
}


@pytest.mark.parametrize("case", list(UNSUPPORTED))
def test_unsupported_features_raise(tmp_path, case):
    make, words = UNSUPPORTED[case]
    data = make(_encode(_image(30, 40)))
    if case == "progressive":
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is not None
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    with pytest.raises(NotImplementedError, match=words) as info:
        imops.imread(str(path), "color")
    assert str(path) in str(info.value)


@pytest.mark.parametrize("interval", [0, 2])
@pytest.mark.parametrize("keep", [0.5, 0.34, 0.998])
def test_truncated_file_gives_cv2s_partial_image(tmp_path, keep, interval):
    """libjpeg-turbo reads zero bits past the end for the MCU that ran out,
    then leaves grey; cv2.imread returns that image (cv2.imdecode returns
    None here)."""
    data = _encode(_image(64, 96, seed=1), cv2.IMWRITE_JPEG_RST_INTERVAL, interval)
    got, want = _both(tmp_path, data[:int(len(data) * keep)])
    assert want is not None
    np.testing.assert_array_equal(got, want)


def test_truncated_header_raises_decode_error(tmp_path):
    data = _encode(_image(64, 96))
    got_path = tmp_path / "x.jpg"
    got_path.write_bytes(data[:300])
    assert cv2.imread(str(got_path)) is None
    with pytest.raises(jpeg.DecodeError):
        imops.imread(str(got_path), "color")


def test_corrupt_stream_raises_where_cv2_decodes_past_it(tmp_path):
    """Bytes flipped in the entropy-coded data: cv2 warns and returns an
    image; the port does not reproduce libjpeg's recovery and raises
    CorruptData, which is not the DecodeError of a file cv2 cannot read."""
    data = bytearray(_encode(_image(64, 96, seed=1)))
    mid = len(data) // 2
    for i in range(mid, mid + 20):
        data[i] ^= 0x5A
    path = tmp_path / "x.jpg"
    path.write_bytes(bytes(data))
    assert cv2.imread(str(path), cv2.IMREAD_COLOR) is not None
    with pytest.raises(jpeg.CorruptData, match="corrupt JPEG data"):
        imops.imread(str(path), "color")
    assert not issubclass(jpeg.CorruptData, jpeg.DecodeError)


def test_signature_picks_the_codec(tmp_path):
    """A PNG named .jpg and a JPEG named .png read as cv2 reads them; a file
    of no image format raises DecodeError (cv2: None); a BMP, which cv2
    reads and the port does not, raises NotImplementedError."""
    img = _image(20, 30)
    ok, png = cv2.imencode(".png", img)
    got, want = _both(tmp_path, png.tobytes(), name="png.jpg")
    np.testing.assert_array_equal(got, want)
    got, want = _both(tmp_path, _encode(img), name="jpeg.png")
    np.testing.assert_array_equal(got, want)
    (tmp_path / "junk.jpg").write_bytes(b"not an image at all")
    assert cv2.imread(str(tmp_path / "junk.jpg")) is None
    with pytest.raises(jpeg.DecodeError):
        imops.imread(str(tmp_path / "junk.jpg"))
    cv2.imwrite(str(tmp_path / "x.bmp"), img)
    assert cv2.imread(str(tmp_path / "x.bmp")) is not None
    with pytest.raises(NotImplementedError, match="BMP"):
        imops.imread(str(tmp_path / "x.bmp"))


# the encoder against cv2's own quality-95 encoding of the same image: the
# two decoded images differ by at most this many levels, this much on mean
ENCODER_MAX_LEVELS, ENCODER_MEAN_LEVELS = 16, 1.5


@pytest.mark.parametrize("grey", [False, True], ids=["colour", "grey"])
@pytest.mark.parametrize("hw", [(120, 160), (61, 97)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_encoder_within_bound_of_cv2(tmp_path, hw, grey):
    img = _image(*hw, noise=8.0)
    if grey:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    path = tmp_path / "port.jpg"
    imops.imwrite(str(path), img)
    ours = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    theirs = cv2.imdecode(np.frombuffer(_encode(img), np.uint8), cv2.IMREAD_UNCHANGED)
    assert ours.shape == theirs.shape == img.shape
    d = np.abs(ours.astype(np.int64) - theirs)
    assert d.max() <= ENCODER_MAX_LEVELS and d.mean() <= ENCODER_MEAN_LEVELS, (d.max(), d.mean())
    np.testing.assert_array_equal(imops.imread(str(path), "unchanged"), ours)
