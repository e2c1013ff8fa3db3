"""Image helpers of the data pipeline without cv2 (the card's machine has
none): a PNG codec on zlib and numpy (imread, imwrite), cv2's INTER_LINEAR
resize on uint8 images (imresize, imrescale), the crop and pad helpers,
and for the colour transforms cv2's uint8 BGR<->HSV conversions (bgr2hsv,
hsv2bgr) and box filter (blur).
The port's copy of scflow_tpu/datasets/pipelines/imops.py, whose resize and
reads are cv2's.

imread returns what cv2.imread does for 8- and 16-bit grey, grey+alpha,
RGB and RGBA PNGs (non-interlaced, every row filter): the channels in BGR
(BGRA) order.  imresize follows cv2.resize's fixed-point arithmetic for
uint8 (11-bit coefficients, its 2x downscale switched to INTER_AREA), see
_resize_linear_u8."""

import struct
import zlib
from typing import Tuple

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples per pixel
_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS
_ZLIB_LEVEL = 3  # zlib's speed/size trade for imwrite


def _chunks(data: bytes):
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        pos += 12 + length


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """(H, W, bpp) filtered bytes and (H,) filter types -> the image bytes.
    Sub, Average and Paeth read the byte bpp to the left, so a row is
    sequential; the rows are decoded together along anti-diagonals
    (x + y = d), where every neighbour a (left), b (up) and c (up-left) of a
    pixel lies on an earlier diagonal: H + W - 1 vector steps."""
    h, w, bpp = raw.shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    skew = np.zeros((h + w - 1, h, bpp), np.int16)
    skew[xs + ys, ys] = raw
    # out[d + 2, y + 1] is pixel (y, d - y); two zero diagonals before the
    # first and a zero row above the first keep the neighbours in range
    out = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    ft = ftype.astype(np.int64)
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h - 1, d) + 1
        a = out[d + 1, lo + 1:hi + 1]
        b = out[d + 1, lo:hi]
        c = out[d, lo:hi]
        cand = np.stack([np.zeros_like(a), a, b, (a + b) >> 1, _paeth(a, b, c)])
        pred = cand[ft[lo:hi], np.arange(hi - lo)]
        out[d + 2, lo + 1:hi + 1] = (skew[d, lo:hi] + pred) & 0xFF
    return out[xs + ys + 2, ys + 1].astype(np.uint8)


def png_decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) uint8/uint16 in the file's channel
    order (grey, grey+alpha, RGB, RGBA)."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"unsupported PNG: colour type {ctype}, bit depth {depth}, "
                         f"interlace {interlace} (8/16-bit grey, grey+alpha, RGB, RGBA, "
                         "not interlaced)")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + w * bpp)
    if rows[:, 0].max(initial=0) > 4:
        raise ValueError("PNG row with an unknown filter type")
    img = _unfilter(rows[:, 1:].reshape(h, w, bpp), rows[:, 0])
    if depth == 16:
        img = img.reshape(h, w, ch, 2).astype(np.uint16)
        img = (img[..., 0] << 8) | img[..., 1]
    else:
        img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def _filter_rows(img_bytes: np.ndarray, bpp: int) -> np.ndarray:
    """(H, W*bpp) bytes -> (H, 1 + W*bpp) filtered rows, each row with the
    filter whose output has the least sum of absolute signed bytes (libpng's
    heuristic)."""
    x = img_bytes.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    preds = [0, a, b, (a + b) >> 1, _paeth(a, b, c)]
    filt = np.stack([(x - p) & 0xFF for p in preds]).astype(np.uint8)
    cost = np.abs(filt.astype(np.int8).astype(np.int32)).sum(axis=2)
    choice = cost.argmin(axis=0)
    rows = filt[choice, np.arange(x.shape[0])]
    return np.concatenate([choice.astype(np.uint8)[:, None], rows], axis=1)


def png_encode(img: np.ndarray) -> bytes:
    """(H, W) grey or (H, W, C) array (C 2, 3, 4, in the file's order) of
    uint8 or uint16 -> PNG bytes."""
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG holds uint8 or uint16, not {img.dtype}")
    img = img[..., None] if img.ndim == 2 else img
    h, w, ch = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    depth = 16 if img.dtype == np.uint16 else 8
    data = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    bpp = ch * depth // 8
    rows = _filter_rows(data.view(np.uint8).reshape(h, w * bpp), bpp)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (_PNG_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), _ZLIB_LEVEL)) + chunk(b"IEND", b""))


def _to_bgr_order(img: np.ndarray) -> np.ndarray:
    if img.ndim == 3 and img.shape[2] in (3, 4):
        order = [2, 1, 0] + ([3] if img.shape[2] == 4 else [])
        return np.ascontiguousarray(img[..., order])
    if img.ndim == 3 and img.shape[2] == 2:  # grey+alpha reads as BGRA
        g, a = img[..., 0], img[..., 1]
        return np.stack([g, g, g, a], axis=-1)
    return img


def imread(path: str, flag: str = "color") -> np.ndarray:
    """cv2.imread for PNG files: flag 'unchanged' (cv2.IMREAD_UNCHANGED)
    keeps the depth and the channels, in BGR(A) order; 'color'
    (cv2.IMREAD_COLOR) gives (H, W, 3) uint8 BGR (16-bit samples keep their
    high byte, alpha is dropped); 'grayscale' reads grey files only.
    Raises FileNotFoundError for a missing file."""
    with open(path, "rb") as f:
        img = _to_bgr_order(png_decode(f.read()))
    if flag == "unchanged":
        return img
    if flag == "grayscale":
        if img.ndim != 2:
            raise ValueError(f"{path}: 'grayscale' reads grey PNGs only, this one has "
                             f"{img.shape[2]} channels")
        return (img >> 8).astype(np.uint8) if img.dtype == np.uint16 else img
    if flag != "color":
        raise ValueError(f"unknown imread flag {flag!r}")
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def imwrite(path: str, img: np.ndarray) -> None:
    """cv2.imwrite for PNG files: (H, W) grey, (H, W, 3) BGR or (H, W, 4)
    BGRA, uint8 or uint16."""
    if img.ndim == 3 and img.shape[2] in (3, 4):
        order = [2, 1, 0] + ([3] if img.shape[2] == 4 else [])
        img = img[..., order]
    with open(path, "wb") as f:
        f.write(png_encode(img))


def imcrop_pad(img: np.ndarray, bbox, pad_val=0) -> np.ndarray:
    """Crop [x1, y1, x2, y2) (int, exclusive) allowing out-of-image regions,
    filled with pad_val (mmcv.imcrop(pad_fill=...) semantics)."""
    x1, y1, x2, y2 = [int(v) for v in bbox]
    h, w = img.shape[:2]
    ch, cw = max(y2 - y1, 1), max(x2 - x1, 1)
    shape = (ch, cw) + img.shape[2:]
    out = np.full(shape, pad_val, img.dtype)
    sx1, sy1 = max(x1, 0), max(y1, 0)
    sx2, sy2 = min(x2, w), min(y2, h)
    if sx2 > sx1 and sy2 > sy1:
        out[sy1 - y1 : sy2 - y1, sx1 - x1 : sx2 - x1] = img[sy1:sy2, sx1:sx2]
    return out


def rescale_factor(shape_hw: Tuple[int, int], scale) -> float:
    """mmcv.imrescale scale factor: fit the long edge to max(scale) and the
    short edge to min(scale)."""
    h, w = shape_hw
    if isinstance(scale, (tuple, list)):
        max_long, max_short = max(scale), min(scale)
    else:
        max_long = max_short = scale
    return min(max_long / max(h, w), max_short / min(h, w))


def _linear_taps(src: int, dst: int, clamp_weights: bool):
    """cv2's INTER_LINEAR source indices and 11-bit weights along one axis:
    f = (d + 0.5) * src/dst - 0.5 in float32, each weight rounded to
    nearest (ties to even) after scaling by 2048, the indices clamped to the
    image.  Along x (clamp_weights) an index outside takes the edge pixel
    with weight 1; along y cv2 keeps the weights and blends the edge row
    with itself."""
    scale = src / dst
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp_weights:
        low, high = s < 0, s >= src - 1
        f[low | high] = 0.0
        s[low] = 0
        s[high] = src - 1
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(np.int64)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def _resize_linear_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize(INTER_LINEAR) of a uint8 (H, W, C) image: a horizontal
    pass in integers (source x 11-bit weights), then cv2's vector blend of
    two such rows, which drops 4 bits of each row and 16 of each product
    before its final rounding shift by 2 (VResizeLinearVec_32s8u)."""
    h, w, c = img.shape
    sx0, sx1, ax0, ax1 = _linear_taps(w, out_w, True)
    sy0, sy1, by0, by1 = _linear_taps(h, out_h, False)
    src = img.astype(np.int64)
    rows = src[:, sx0] * ax0[None, :, None] + src[:, sx1] * ax1[None, :, None]  # (H, W', C)
    b0, b1 = by0[:, None, None], by1[:, None, None]
    out = ((((rows[sy0] >> 4) * b0) >> 16) + (((rows[sy1] >> 4) * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _resize_area2_u8(img: np.ndarray) -> np.ndarray:
    """cv2's INTER_AREA at an exact 2x downscale: the rounded mean of each
    2x2 block."""
    h, w = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
    s = img[:h, :w].astype(np.int32)
    q = s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2]
    return ((q + 2) >> 2).astype(np.uint8)


def resize_u8(img: np.ndarray, size_hw) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR) for a uint8
    (H, W) or (H, W, C) image, including cv2's switch to INTER_AREA when the
    scale is exactly 2 on both axes."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_u8 takes uint8 images, not {img.dtype}")
    out_h, out_w = int(size_hw[0]), int(size_hw[1])
    grey = img.ndim == 2
    x = img[..., None] if grey else img
    h, w = x.shape[:2]
    if (out_h, out_w) == (h, w):
        out = x.copy()
    elif w / out_w == 2.0 and h / out_h == 2.0:
        out = _resize_area2_u8(x)
    else:
        out = _resize_linear_u8(x, out_h, out_w)
    return out[..., 0] if grey else out


def imrescale(img: np.ndarray, scale):
    """mmcv.imrescale with cv2's INTER_LINEAR: (image, factor)."""
    f = rescale_factor(img.shape[:2], scale)
    h, w = img.shape[:2]
    new_w, new_h = int(w * f + 0.5), int(h * f + 0.5)
    return resize_u8(img, (new_h, new_w)), f


def imresize(img: np.ndarray, size_hw):
    """mmcv.imresize with cv2's INTER_LINEAR: (image, w scale, h scale)."""
    h, w = img.shape[:2]
    return resize_u8(img, size_hw), size_hw[1] / w, size_hw[0] / h


def impad(img: np.ndarray, padding: Tuple[int, int, int, int], pad_val=0):
    """padding = (left, top, right, bottom)."""
    left, top, right, bottom = [int(p) for p in padding]
    if img.ndim == 2:
        return np.pad(img, ((top, bottom), (left, right)), constant_values=pad_val)
    if isinstance(pad_val, (tuple, list)):
        h, w = img.shape[:2]
        out = np.empty((h + top + bottom, w + left + right, img.shape[2]), img.dtype)
        out[...] = np.asarray(pad_val, img.dtype)
        out[top : top + h, left : left + w] = img
        return out
    return np.pad(
        img, ((top, bottom), (left, right), (0, 0)), constant_values=pad_val
    )


# cv2's uint8 BGR <-> HSV (COLOR_BGR2HSV / COLOR_HSV2BGR, hue in [0, 180)):
# the forward conversion in cv2's 12-bit fixed point with the division
# tables it builds once (RGB2HSV_b); the inverse in float32 with the fused
# multiply-adds of cv2's code, where cv2 truncates the result to uint8 for
# the pixels its vector loop takes (each row's first 32 x floor(W / 32))
# and rounds it to nearest for the rest of the row.  Both equal cv2 5.0's
# on every one of the 2^24 inputs, in both kinds of column
# (tests/test_torch_train_pipelines.py).
_HSV_BLOCK = 32  # pixels per step of cv2's vector loop
_HSV_SHIFT = 12
_HSV_HALF = 1 << (_HSV_SHIFT - 1)
_DIV = np.arange(1, 256, dtype=np.float64)
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / _DIV)]).astype(np.int64)
_HDIV = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * _DIV))]).astype(np.int64)
del _DIV


def bgr2hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_BGR2HSV) for a uint8 (..., 3) image."""
    if img.dtype != np.uint8 or img.shape[-1] != 3:
        raise ValueError(f"bgr2hsv takes uint8 (..., 3) images, got {img.dtype} {img.shape}")
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * _SDIV[v] + _HSV_HALF) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + _HSV_HALF) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


# (b, g, r) rows of cv2's sector table, indices into (v, p, q, t)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _fma32(a: np.ndarray, b: np.ndarray, c) -> np.ndarray:
    """float32 a * b + c rounded once: the product of two float32 values is
    exact in float64, and the sum's float64 rounding never decides the
    float32 result on this function's inputs (checked on all of them)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def hsv2bgr(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_HSV2BGR) for a uint8 (..., W, 3) image (rows
    of W pixels; a (3,) pixel is a row of one)."""
    if img.dtype != np.uint8 or img.shape[-1] != 3:
        raise ValueError(f"hsv2bgr takes uint8 (..., 3) images, got {img.dtype} {img.shape}")
    f32 = np.float32
    h = img[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = img[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = img[..., 2].astype(f32) * f32(1.0 / 255.0)
    pre = np.trunc(h)
    h = h - pre
    sector = (pre - np.trunc(pre * f32(1.0 / 6.0)) * f32(6.0)).astype(np.int64)
    one = f32(1.0)
    tab = np.stack([v, v * (one - s), v * _fma32(-s, h, 1.0), v * _fma32(-s, one - h, 1.0)],
                   axis=-1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], axis=-1) * f32(255.0)
    width = img.shape[-2] if img.ndim > 1 else 1
    vector = np.arange(width) < width - width % _HSV_BLOCK
    out = np.where(vector[:, None], np.trunc(bgr), np.rint(bgr))
    return np.clip(out, 0, 255).astype(np.uint8)


def blur(img: np.ndarray, k: int) -> np.ndarray:
    """cv2.blur(img, (k, k)) for a uint8 image (H, W[, C]) and an odd k: the
    mean over each k x k window, the border reflected without repeating
    the edge (cv2's BORDER_REFLECT_101, numpy's 'reflect'), rounded to
    nearest.  cv2 rounds the float32 product sum * (1/k^2); for odd k that
    equals the integer (sum + k^2 // 2) // k^2 at every possible sum."""
    if img.dtype != np.uint8 or k < 1 or k % 2 == 0:
        raise ValueError(f"blur takes a uint8 image and an odd k, got {img.dtype}, {k}")
    if k == 1:
        return img.copy()
    r = k // 2
    tail = [(0, 0)] * (img.ndim - 2)
    x = np.pad(img.astype(np.int64), [(r, r), (r, r)] + tail, mode="reflect")
    c = np.pad(np.cumsum(np.cumsum(x, axis=0), axis=1), [(1, 0), (1, 0)] + tail)
    s = c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]
    d = k * k
    return ((s + d // 2) // d).astype(np.uint8)
