"""Image helpers of the data pipeline without cv2 (the card's machine has
none): a PNG codec on zlib and numpy, a JPEG codec (jpeg.py) and a BMP
reader behind imread and imwrite, cv2's INTER_LINEAR resize on uint8
images (imresize, imrescale), the crop and pad helpers, and for the colour
transforms cv2's uint8 BGR<->HSV and BGR<->grey conversions (bgr2hsv,
hsv2bgr, bgr2gray, gray2bgr), box filter (blur), min-max normalize
(normalize_minmax) and affine warp (warp_affine, get_rotation_matrix_2d),
and its filled circle (fill_circle).
The port's copy of scflow_tpu/datasets/pipelines/imops.py, whose resize and
reads are cv2's.

imread returns what cv2.imread does under its three flags for every PNG
(each colour type and bit depth, palettes and tRNS, Adam7 interlace, every
row filter), for the JPEGs that jpeg.py reads and for uncompressed 1-, 4-,
8-, 24- and 32-bit BMPs: the channels in BGR (BGRA) order.  Each codec's
grey read is cv2's own: libpng's rgb_to_gray for PNG, OpenCV's 14-bit
weights for BMP, the luma (or OpenCV's CMYK weights) for JPEG, none of
them cvtColor's (bgr2gray).  imresize follows cv2.resize's fixed-point
arithmetic for uint8 (11-bit coefficients, its 2x downscale switched to
INTER_AREA), see _resize_linear_u8."""

import math
import struct
import zlib
from typing import Tuple

import numpy as np

from scflow_tpu_torch.datasets.pipelines.jpeg import (DecodeError, cv_bgr_to_grey, jpeg_decode,
                                                      jpeg_encode, orient)

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples per pixel
_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS
_ZLIB_LEVEL = 3  # zlib's speed/size trade for imwrite


def _chunks(data: bytes):
    if data[:8] != _PNG_SIG:
        raise DecodeError("not a PNG file")
    pos = 8
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise DecodeError(f"PNG chunk {kind!r}: bad CRC")
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


# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _png_samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """(H, row bytes) unfiltered rows -> (H, W, ch) samples at the file's
    depth (uint8 for 1-8 bits, uint16 for 16)."""
    h = len(rows)
    if depth == 16:
        b = rows[:, :2 * w * ch].reshape(h, w, ch, 2).astype(np.uint16)
        return (b[..., 0] << 8) | b[..., 1]
    if depth == 8:
        return rows[:, :w * ch].reshape(h, w, ch)
    bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[..., None]


def _png_parse(data: bytes):
    """The file's (H, W, ch) samples at its depth (palette indices for a
    palette file, grey at 1-16 bits), with its colour type, bit depth,
    palette ((n, 3) uint8 or None) and tRNS body (bytes or None)."""
    header, idat, palette, trns = None, [], None, None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise DecodeError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth not in _DEPTHS.get(ctype, ()) or interlace > 1:
        raise DecodeError(f"invalid PNG: colour type {ctype}, bit depth {depth}, "
                          f"interlace {interlace}")
    if ctype == 3 and palette is None:
        raise DecodeError("palette PNG without PLTE")
    ch = 1 if ctype == 3 else _CHANNELS[ctype]
    bits_pp = ch * depth
    bpp = max(bits_pp // 8, 1)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    img = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue  # an empty pass holds no rows, not even filter bytes
        nbytes = -(-(pw * bits_pp) // 8)
        rows = raw[pos:pos + ph * (1 + nbytes)]
        if len(rows) != ph * (1 + nbytes):
            raise DecodeError("PNG image data ends early")
        rows = rows.reshape(ph, 1 + nbytes)
        pos += ph * (1 + nbytes)
        if rows[:, 0].max(initial=0) > 4:
            raise DecodeError("PNG row with an unknown filter type")
        body = _unfilter(rows[:, 1:].reshape(ph, nbytes // bpp, bpp), rows[:, 0])
        img[y0::dy, x0::dx] = _png_samples(body.reshape(ph, nbytes), pw, ch, depth)
    return img, ctype, depth, palette, trns


def _expand_grey(v: np.ndarray, depth: int) -> np.ndarray:
    """libpng's png_set_expand_gray_1_2_4_to_8: each sample's bits repeated
    to fill 8."""
    return v if depth >= 8 else (v.astype(np.uint16) * (255 // ((1 << depth) - 1))).astype(np.uint8)


def _palette_rgba(idx: np.ndarray, palette: np.ndarray, trns, alpha: bool) -> np.ndarray:
    """Palette indices (H, W) -> (H, W, 3) RGB, or (H, W, 4) RGBA with the
    tRNS alphas (255 past them) where alpha; an index past the palette
    reads black, as libpng's png_set_PLTE pads the palette to 256."""
    full = np.zeros((256, 4), np.uint8)
    full[:len(palette), :3] = palette
    full[:, 3] = 255
    if trns:
        full[:len(trns), 3] = np.frombuffer(trns[:256], np.uint8)
    return full[idx][..., :4 if alpha else 3]


def _png_unchanged(img, ctype, depth, palette, trns) -> np.ndarray:
    """_png_parse's samples as cv2's IMREAD_UNCHANGED keeps them, in the
    file's channel order: low-bit grey expanded to 8 bits, a palette as RGB,
    or RGBA where the file has tRNS, an RGB file with tRNS as RGBA (alpha 0
    on its key colour); a grey file's tRNS is dropped."""
    if ctype == 3:
        return _palette_rgba(img[..., 0], palette, trns, alpha=bool(trns))
    if ctype == 0:
        return _expand_grey(img[..., 0], depth)
    if ctype == 2 and trns is not None and len(trns) >= 6:
        key = np.array(struct.unpack(">HHH", trns[:6]), np.uint16).astype(img.dtype)
        a = np.where((img == key).all(axis=2), 0, np.iinfo(img.dtype).max).astype(img.dtype)
        return np.concatenate([img, a[..., None]], axis=2)
    return img


def png_decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) uint8/uint16 in the file's channel
    order (grey, grey+alpha, RGB, RGBA) as cv2's IMREAD_UNCHANGED reads it
    (_png_unchanged), for every colour type, bit depth and interlace."""
    return _png_unchanged(*_png_parse(data))


# libpng's png_set_rgb_to_gray(png_ptr, 1, 0.299, 0.587) as cv2 sets it:
# 15-bit weights red 29900 * 32768 // 100000, green 58700 * 32768 // 100000,
# blue the rest, truncated at 8 bits and rounded at 16
_PNG_GREY_R, _PNG_GREY_G = 9797, 19234
_PNG_GREY_B = 32768 - _PNG_GREY_R - _PNG_GREY_G


def _png_rgb_to_grey(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3+) RGB(A) uint8 or uint16 -> (H, W) grey of the same depth."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    acc = _PNG_GREY_R * r + _PNG_GREY_G * g + _PNG_GREY_B * b
    if rgb.dtype == np.uint16:
        acc = acc + 16384
    return (acc >> 15).astype(rgb.dtype)


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


# signatures of the other formats cv2.imread decodes, which the port does not
_OTHER_FORMATS = ((b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"RIFF", "WebP"),
                  (b"\x00\x00\x00\x0cjP", "JPEG 2000"), (b"\xffO\xffQ", "JPEG 2000"),
                  (b"#?RADIANCE", "Radiance HDR"), (b"v/1\x01", "OpenEXR"), (b"GIF8", "GIF"))


def _bmp_decode(data: bytes, flag: str, path: str) -> np.ndarray:
    """cv2.imread of a BMP (OpenCV's own reader, grfmt_bmp.cpp): 1-, 4- and
    8-bit palette files, 24-bit and 32-bit BI_RGB ones, and 32-bit
    BI_BITFIELDS ones with byte-wide masks (cv2.imwrite's BGRA files), rows
    bottom-up or top-down, each padded to 4 bytes, after a header of 40
    bytes or more.  'unchanged' gives one channel for a grey palette, four
    for BI_BITFIELDS (alpha 255 where its mask is 0), else three;
    'grayscale' takes OpenCV's 14-bit weights on the palette or the pixels,
    and for BI_BITFIELDS its float32 sum floor(0.299 R + 0.587 G + 0.114 B).  RLE, 16-bit, other masks and
    OS/2's 12-byte header raise NotImplementedError."""
    if len(data) < 26:
        raise DecodeError(f"{path}: truncated BMP header")
    offset, size = struct.unpack("<I", data[10:14])[0], struct.unpack("<I", data[14:18])[0]
    masks = None
    if size >= 36:
        if len(data) < 14 + 36:
            raise DecodeError(f"{path}: truncated BMP header")
        w, h, _, bpp, comp = struct.unpack("<iiHHI", data[18:34])
        clrused = struct.unpack("<i", data[46:50])[0]
        if bpp == 32 and comp == 3 and size >= 56:
            masks = struct.unpack("<4I", data[54:70])
    elif size == 12:
        raise NotImplementedError(f"{path}: OS/2 BMP (a 12-byte header) is not read")
    else:
        raise DecodeError(f"{path}: BMP header of {size} bytes")
    if comp in (1, 2):
        raise NotImplementedError(f"{path}: RLE-compressed BMP ({'RLE8' if comp == 1 else 'RLE4'})"
                                  " is not read (uncompressed BMP only)")
    if bpp == 16:
        raise NotImplementedError(f"{path}: 16-bit BMP is not read (1, 4, 8, 24 and 32-bit)")
    if comp == 3 and bpp == 32 and masks is None:
        raise NotImplementedError(f"{path}: BI_BITFIELDS BMP with its masks after a {size}-byte "
                                  "header is not read")
    if (bpp not in (1, 4, 8, 24, 32) or comp not in (0, 3) or (comp == 3 and bpp != 32)
            or w <= 0 or h == 0):
        raise DecodeError(f"{path}: not a BMP that cv2 reads ({bpp} bits, compression {comp})")
    shifts = None
    if masks is not None:
        shifts = []
        for m in masks:
            if m and m not in (0xFF, 0xFF00, 0xFF0000, 0xFF000000):
                raise NotImplementedError(f"{path}: BI_BITFIELDS BMP with the mask {m:#x} is not "
                                          "read (byte-wide masks only)")
            shifts.append(None if m == 0 else (m.bit_length() - 8))
    bottom_up, h = h > 0, abs(h)
    palette = None
    if bpp <= 8:
        n = clrused if clrused else 1 << bpp
        if not 0 <= clrused <= 256:
            raise DecodeError(f"{path}: BMP palette of {clrused} colours")
        start = 14 + size
        table = np.zeros((256, 4), np.uint8)
        raw = np.frombuffer(data[start:start + n * 4], np.uint8)
        if len(raw) != n * 4:
            raise DecodeError(f"{path}: truncated BMP palette")
        table[:n] = raw.reshape(n, 4)
        palette = table[:, :3]  # B, G, R
    pitch = ((w * bpp + 7) // 8 + 3) & -4
    pixels = np.frombuffer(data[offset:offset + pitch * h], np.uint8)
    if offset > len(data) or len(pixels) != pitch * h:
        raise DecodeError(f"{path}: truncated BMP pixel data")
    rows = pixels.reshape(h, pitch)
    if bottom_up:
        rows = rows[::-1]
    if palette is not None:
        if bpp == 8:
            idx = rows[:, :w]
        else:
            bits = np.unpackbits(rows, axis=1)[:, :w * bpp].reshape(h, w, bpp)
            idx = (bits * (1 << np.arange(bpp - 1, -1, -1)).astype(np.uint8)).sum(
                axis=2, dtype=np.uint8)
        grey_palette = palette[:1 << bpp]
        is_colour = bool((grey_palette[:, 0] != grey_palette[:, 1]).any()
                         or (grey_palette[:, 0] != grey_palette[:, 2]).any())
        if flag == "grayscale" or (flag == "unchanged" and not is_colour):
            return cv_bgr_to_grey(palette)[idx]
        return palette[idx]
    if bpp == 24:
        bgr = rows[:, :3 * w].reshape(h, w, 3)
        return cv_bgr_to_grey(bgr) if flag == "grayscale" else np.ascontiguousarray(bgr)
    px = rows[:, :4 * w].reshape(h, w, 4)
    if shifts is None:  # BI_RGB: the fourth byte is dropped
        return cv_bgr_to_grey(px) if flag == "grayscale" else np.ascontiguousarray(px[..., :3])
    word = px.view("<u4")[..., 0]
    r, g, b = ((word >> s).astype(np.uint8) if s is not None else np.zeros((h, w), np.uint8)
               for s in shifts[:3])
    if flag == "grayscale":
        f32 = np.float32
        acc = (f32(0.299) * r.astype(f32)) + (f32(0.587) * g.astype(f32))
        return np.floor(acc + f32(0.114) * b.astype(f32)).astype(np.uint8)
    a = (word >> shifts[3]).astype(np.uint8) if shifts[3] is not None else np.full((h, w), 255,
                                                                                   np.uint8)
    return np.stack([b, g, r, a] if flag == "unchanged" else [b, g, r], axis=-1)


def _png_read(data: bytes, flag: str) -> np.ndarray:
    """cv2.imread of a PNG under one flag, as OpenCV drives libpng."""
    img, ctype, depth, palette, trns = _png_parse(data)
    if ctype == 3:
        rgb = _palette_rgba(img[..., 0], palette, trns, alpha=flag == "unchanged" and bool(trns))
    elif ctype == 0:
        grey = _expand_grey(img[..., 0], depth)
        if flag == "unchanged":
            return grey
        grey = (grey >> 8).astype(np.uint8) if depth == 16 else grey
        return grey if flag == "grayscale" else np.repeat(grey[..., None], 3, axis=2)
    elif ctype == 4:
        if flag == "unchanged":
            return _to_bgr_order(img)
        grey = (img[..., 0] >> 8).astype(np.uint8) if depth == 16 else img[..., 0]
        return grey if flag == "grayscale" else np.repeat(grey[..., None], 3, axis=2)
    else:
        rgb = img
    if flag == "unchanged":
        return _to_bgr_order(_png_unchanged(img, ctype, depth, palette, trns))
    if flag == "grayscale":
        grey = _png_rgb_to_grey(rgb)
        return (grey >> 8).astype(np.uint8) if grey.dtype == np.uint16 else grey
    if rgb.dtype == np.uint16:
        rgb = (rgb >> 8).astype(np.uint8)
    return np.ascontiguousarray(rgb[..., 2::-1])


_FLAGS = ("unchanged", "color", "grayscale")


def imread(path: str, flag: str = "color") -> np.ndarray:
    """cv2.imread for PNG, JPEG and BMP files, the codec chosen by the file's
    signature: flag 'unchanged' (cv2.IMREAD_UNCHANGED) keeps the depth and
    the channels, in BGR(A) order, and ignores a JPEG's EXIF orientation;
    'color' (cv2.IMREAD_COLOR) gives (H, W, 3) uint8 BGR (16-bit samples keep
    their high byte, alpha is dropped); 'grayscale' (cv2.IMREAD_GRAYSCALE)
    gives (H, W) uint8, each codec with cv2's own conversion (a JPEG's luma,
    or its CMYK through OpenCV's weights; libpng's rgb_to_gray for a colour
    or palette PNG; OpenCV's 14-bit weights for a BMP); 'color' and
    'grayscale' apply a JPEG's EXIF Orientation as cv2 does.
    PNG: every colour type and bit depth (1-, 2-, 4-bit grey and palette
    expanded as libpng does), tRNS (BGRA under 'unchanged' for palette and
    RGB files), Adam7 interlace.  JPEG: what jpeg.py reads (baseline,
    extended sequential and progressive Huffman files; grey, YCbCr, CMYK
    and YCCK).  BMP: see _bmp_decode.
    Raises FileNotFoundError for a missing file, DecodeError where
    cv2.imread returns None (not an image, a truncated header, a bad PNG
    checksum) and NotImplementedError, naming the file and the feature,
    for a format or a feature that cv2 reads and the port does not."""
    if flag not in _FLAGS:
        raise ValueError(f"unknown imread flag {flag!r}")
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        img, orientation = jpeg_decode(data, grey=flag == "grayscale", path=path)
        if flag == "unchanged":
            return img
        img = orient(img, orientation)
        return np.repeat(img[..., None], 3, axis=2) if flag == "color" and img.ndim == 2 else img
    if data[:2] == b"BM":
        return _bmp_decode(data, flag, path)
    if data[:8] != _PNG_SIG:
        for sig, name in _OTHER_FORMATS:
            if data.startswith(sig):
                raise NotImplementedError(f"{path}: {name} files are not read "
                                          "(PNG, JPEG and BMP)")
        raise DecodeError(f"{path}: not an image file")
    try:
        return _png_read(data, flag)
    except DecodeError as e:
        raise DecodeError(f"{path}: {e}") from None


def imwrite(path: str, img: np.ndarray) -> None:
    """cv2.imwrite for PNG and JPEG files, by the path's extension ('.jpg'
    and '.jpeg' write a baseline JPEG at cv2's default quality 95, 4:2:0,
    from (H, W) grey or (H, W, 3) BGR uint8; any other writes a PNG from
    (H, W) grey, (H, W, 3) BGR or (H, W, 4) BGRA, uint8 or uint16)."""
    if str(path).lower().endswith((".jpg", ".jpeg")):
        data = jpeg_encode(img)
    else:
        if img.ndim == 3 and img.shape[2] in (3, 4):
            order = [2, 1, 0] + ([3] if img.shape[2] == 4 else [])
            img = img[..., order]
        data = png_encode(img)
    with open(path, "wb") as f:
        f.write(data)


def fill_circle(img: np.ndarray, center, radius: int, value) -> np.ndarray:
    """cv2.circle(img, center, radius, value, thickness=-1) in place, for
    integer center and radius (cv2's 8-connected midpoint circle: each step
    fills the rows cy +- dy over [cx - dx, cx + dx] and cy +- dx over
    [cx - dy, cx + dy], clipped to the image).  Returns img."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, int(radius), 0, 1, 2 * int(radius) - 1

    def hline(y, x1, x2):
        if 0 <= y < h and x1 < w and x2 >= 0:
            img[y, max(x1, 0):min(x2, w - 1) + 1] = value

    while dx >= dy:
        for y in (cy - dy, cy + dy):
            hline(y, cx - dx, cx + dx)
        for y in (cy - dx, cy + dx):
            hline(y, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0  # (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return img


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


def bgr2gray(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) for a uint8 (..., 3) image: the
    BT.601 weights in cv2 5's 15-bit fixed point (summing to 2^15), rounded;
    equal to cv2 on every one of the 2^24 inputs."""
    if img.dtype != np.uint8 or img.shape[-1] != 3:
        raise ValueError(f"bgr2gray takes uint8 (..., 3) images, got {img.dtype} {img.shape}")
    b, g, r = (img[..., i].astype(np.int32) for i in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(np.uint8)


def gray2bgr(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_GRAY2BGR): the grey plane in each channel."""
    return np.repeat(img[..., None], 3, axis=-1)


def normalize_minmax(x: np.ndarray, alpha: float = 0.0, beta: float = 255.0) -> np.ndarray:
    """cv2.normalize(x, None, alpha, beta, cv2.NORM_MINMAX) for a float32 or
    float64 array: x * scale + shift fused in x's dtype, where scale =
    (beta - alpha) * (1 / (max - min)) (0 for a flat array) and shift = min
    (alpha, beta) - min * scale; for float32 both are rounded to float32
    first, as cv2 does."""
    if x.dtype not in (np.float32, np.float64):
        raise TypeError(f"normalize_minmax takes float32 or float64, not {x.dtype}")
    lo, hi = float(x.min()), float(x.max())
    dmin, dmax = min(alpha, beta), max(alpha, beta)
    scale = (dmax - dmin) * (1.0 / (hi - lo) if hi - lo > np.finfo(np.float64).eps else 0.0)
    if x.dtype == np.float32:
        scale = float(np.float32(scale))
        shift = float(np.float32(dmin)) - float(np.float32(lo * scale))
        return _fma32(x, np.float32(scale), np.float32(shift))
    return _fma64(x, scale, dmin - lo * scale)


def _fma64(a: np.ndarray, b: float, c: float) -> np.ndarray:
    """float64 a * b + c rounded once (cv2's vector loop fuses it): the
    product split exactly into p + e (Veltkamp and Dekker), p + c into
    s + t (Knuth's two-sum), then s + (t + e)."""
    split = 134217729.0  # 2^27 + 1
    p = a * b
    ta = split * a
    ah = ta - (ta - a)
    al = a - ah
    tb = split * b
    bh = tb - (tb - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def get_rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: (2, 3) float64, a positive angle (degrees)
    counter-clockwise in the image; the centre is taken as float32 (cv2's
    Point2f)."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def invert_affine(m) -> np.ndarray:
    """cv2.invertAffineTransform of a (2, 3) matrix, as the six float64
    values (a11, a12, b1, a21, a22, b2)."""
    m = np.asarray(m, np.float64).reshape(6)
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[4] * d, m[0] * d, -m[1] * d, -m[3] * d
    return np.array([a11, a12, -a11 * m[2] - a12 * m[5], a21, a22, -a21 * m[2] - a22 * m[5]])


_WARP_BLOCK = 16  # pixels per step of cv2's vector warp loop


def _warp_coords(m, w: int, h: int):
    """cv2.warpAffine's float32 source coordinates of each destination pixel
    (the inverse map): in its vector loop (each row's first 16 x floor(W /
    16) pixels) x * m0 + (y * m1 + m2) with the first product fused, in its
    scalar tail (x * m0 + y * m1) + m2 with the first sum fused."""
    a = invert_affine(m).astype(np.float32)
    x = np.arange(w, dtype=np.float32)[None, :]
    y = np.arange(h, dtype=np.float32)[:, None]
    tail = np.arange(w) >= w - w % _WARP_BLOCK
    out = []
    for m0, m1, m2 in ((a[0], a[1], a[2]), (a[3], a[4], a[5])):
        vec = _fma32(x, m0, y * m1 + m2)
        scalar = _fma32(x, m0, y * m1) + m2
        out.append(np.where(tail, scalar, vec))
    return out


def _taps(src: np.ndarray, ys, xs, border):
    """src[ys, xs] (..., C) with border for indices outside the image."""
    h, w = src.shape[:2]
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    v = src[np.clip(ys, 0, h - 1), np.clip(xs, 0, w - 1)]
    return np.where(inside[..., None], v, border)


_WARP_MODES = ("nearest", "bilinear", "bicubic", "area", "lanczos")


def warp_affine(img: np.ndarray, m, dsize, interpolation: str = "bilinear",
                border_value=0) -> np.ndarray:
    """cv2.warpAffine(img, m, dsize=(w, h), flags=..., borderValue=...) with
    a constant border for a uint8 (H, W) or (H, W, C) image.  Nearest and
    bilinear ('area' is bilinear in a warp) follow cv2 5's float32 kernels:
    the coordinates of _warp_coords, the nearest tap by rounding half to
    even, bilinear as fused lerps along x then y, rounded to nearest.
    Bicubic takes the same coordinates and separable float32 weights
    (_warp_bicubic); how cv2 computes its weights is not known exactly, so
    a few values differ by one level (tests/test_torch_warp.py states the
    bound).  Lanczos-4 is cv2's fixed-point remap (_warp_lanczos)."""
    if img.dtype != np.uint8:
        raise TypeError(f"warp_affine takes uint8 images, not {img.dtype}")
    if interpolation not in _WARP_MODES:
        raise ValueError(f"unknown interpolation {interpolation!r}, expected one of "
                         f"{_WARP_MODES}")
    w, h = int(dsize[0]), int(dsize[1])
    grey = img.ndim == 2
    src = img[..., None] if grey else img
    c = src.shape[2]
    border = np.broadcast_to(
        np.clip(np.rint(np.asarray(border_value, np.float64).ravel()[:c]), 0, 255), (c,))
    if interpolation == "lanczos":
        out = _warp_lanczos(src, m, w, h, border)
    else:
        sx, sy = _warp_coords(m, w, h)
        if interpolation == "bicubic":
            out = _warp_bicubic(src, sx, sy, border)
        elif interpolation == "nearest":
            out = _taps(src, np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64), border)
        else:
            ix, iy = np.floor(sx), np.floor(sy)
            fx = (sx - ix)[..., None]
            fy = (sy - iy)[..., None]
            ix, iy = ix.astype(np.int64), iy.astype(np.int64)
            p = [_taps(src, iy + dy, ix + dx, border).astype(np.float32)
                 for dy in (0, 1) for dx in (0, 1)]
            top = _fma32(fx, p[1] - p[0], p[0])
            bottom = _fma32(fx, p[3] - p[2], p[2])
            out = np.rint(_fma32(fy, bottom - top, top))
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out[..., 0] if grey else out


def _cubic_weights(x: np.ndarray):
    """cv2's interpolateCubic (A = -0.75) in float32, per fraction x."""
    f = np.float32
    a, one = f(-0.75), f(1)
    c0 = ((a * (x + one) - f(5) * a) * (x + one) + f(8) * a) * (x + one) - f(4) * a
    c1 = ((a + f(2)) * x - (a + f(3))) * x * x + one
    c2 = ((a + f(2)) * (one - x) - (a + f(3))) * (one - x) * (one - x) + one
    return [c0, c1, c2, one - c0 - c1 - c2]


def _lanczos_weights(x: np.ndarray):
    """cv2's interpolateLanczos4 per fraction x: sinc windows from double
    trigonometry, normalized to sum 1 in float32."""
    s45 = 0.70710678118654752440084436210485
    cs = [(1, 0), (-s45, -s45), (0, 1), (s45, -s45), (-1, 0), (s45, s45), (0, -1), (-s45, s45)]
    y0 = -(x.astype(np.float64) + 3) * np.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    out = []
    for i in range(8):
        yy = (x + np.float32(3 - i)).astype(np.float32)
        y = -yy.astype(np.float64) * np.pi * 0.25
        with np.errstate(divide="ignore", invalid="ignore"):
            v = ((cs[i][0] * s0 + cs[i][1] * c0) / (y * y)).astype(np.float32)
        out.append(np.where(np.abs(yy) >= 1e-6, v, np.float32(1e30)))
    total = out[0]
    for v in out[1:]:
        total = total + v
    inv = np.float32(1) / total
    return [v * inv for v in out]


_AB_BITS, _INTER_BITS = 10, 5
_INTER_TAB = 1 << _INTER_BITS
_REMAP_BITS = 15
_LANCZOS_CENTRE = 4  # the first of the central two taps each way, which take the rounding
_LANCZOS_TABLE = []


def _lanczos_table() -> np.ndarray:
    """cv2's initInterTab2D for Lanczos-4: (32 * 32, 8, 8) int32 weights,
    each the rounded float32 product of two 1-D kernels at the fractions
    i / 32, the rounding error moved onto the largest (or smallest) of the
    central four so that each table sums to 2^15."""
    if not _LANCZOS_TABLE:
        frac = np.arange(_INTER_TAB, dtype=np.float32) * np.float32(1.0 / _INTER_TAB)
        tab1 = np.stack(_lanczos_weights(frac), axis=1)  # (32, 8)
        v = (tab1[:, None, :, None] * tab1[None, :, None, :]).astype(np.float32)
        it = np.rint(v * np.float32(1 << _REMAP_BITS)).astype(np.int32)  # (32, 32, 8, 8)
        for i in range(_INTER_TAB):
            for j in range(_INTER_TAB):
                t = it[i, j]
                diff = int(t.sum()) - (1 << _REMAP_BITS)
                if diff:
                    lo = hi = (_LANCZOS_CENTRE, _LANCZOS_CENTRE)
                    for k1 in range(_LANCZOS_CENTRE, _LANCZOS_CENTRE + 2):
                        for k2 in range(_LANCZOS_CENTRE, _LANCZOS_CENTRE + 2):
                            if t[k1, k2] < t[lo]:
                                lo = (k1, k2)
                            elif t[k1, k2] > t[hi]:
                                hi = (k1, k2)
                    t[hi if diff < 0 else lo] -= diff
        _LANCZOS_TABLE.append(it.reshape(_INTER_TAB * _INTER_TAB, 8, 8))
    return _LANCZOS_TABLE[0]


def _warp_lanczos(src, m, w, h, border):
    """cv2's fixed-point warpAffine + remap for Lanczos-4: source
    coordinates in 10-bit fixed point from the float64 inverse map (each
    row's start plus each column's offset, rounded half to even), 5
    fraction bits indexing the weight table, (sum + 2^14) >> 15."""
    tab = _lanczos_table()
    a = invert_affine(m)
    scale = 1 << _AB_BITS
    delta = scale // _INTER_TAB // 2
    x, y = np.arange(w), np.arange(h)
    adx = np.rint(a[0] * x * scale).astype(np.int64)
    ady = np.rint(a[3] * x * scale).astype(np.int64)
    x0 = np.rint((a[1] * y + a[2]) * scale).astype(np.int64) + delta
    y0 = np.rint((a[4] * y + a[5]) * scale).astype(np.int64) + delta
    X = (x0[:, None] + adx[None, :]) >> (_AB_BITS - _INTER_BITS)
    Y = (y0[:, None] + ady[None, :]) >> (_AB_BITS - _INTER_BITS)
    wts = tab[(Y & (_INTER_TAB - 1)) * _INTER_TAB + (X & (_INTER_TAB - 1))]
    X, Y = (X >> _INTER_BITS) - 3, (Y >> _INTER_BITS) - 3
    acc = np.zeros((h, w, src.shape[2]), np.int64)
    for dy in range(8):
        for dx in range(8):
            acc += (_taps(src, Y + dy, X + dx, border).astype(np.int64)
                    * wts[..., dy, dx][..., None])
    return (acc + (1 << (_REMAP_BITS - 1))) >> _REMAP_BITS


def _warp_bicubic(src, sx, sy, border):
    """Bicubic (4 x 4 taps) at float32 coordinates: per-pixel 1-D weights,
    each tap row summed along x with fused multiply-adds, then the rows
    along y."""
    ix, iy = np.floor(sx), np.floor(sy)
    wx = [w[..., None] for w in _cubic_weights((sx - ix).astype(np.float32))]
    wy = [w[..., None] for w in _cubic_weights((sy - iy).astype(np.float32))]
    ix, iy = ix.astype(np.int64) - 1, iy.astype(np.int64) - 1
    acc = None
    for dy in range(4):
        row = None
        for dx in range(4):
            p = _taps(src, iy + dy, ix + dx, border).astype(np.float32)
            row = p * wx[dx] if row is None else _fma32(p, wx[dx], row)
        acc = row * wy[dy] if acc is None else _fma32(row, wy[dy], acc)
    return np.rint(acc)
