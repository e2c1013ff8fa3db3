"""Writers of the PNG and BMP kinds that neither cv2 nor PIL writes
(1-, 2- and 4-bit grey, palettes of any size with tRNS, Adam7 interlace,
top-down and low-bit BMPs), so that cv2.imread can serve as the oracle of
the port's readers on them.  Plain numpy, zlib and struct; written from the
PNG specification (ISO/IEC 15948) and the BMP file layout."""

import struct
import zlib

import numpy as np

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(H, W, ch) samples -> (H, row bytes) uint8 at the bit depth."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    v = samples.reshape(h, -1).astype(np.uint8)
    bits = ((v[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, -1)
    return np.packbits(bits, axis=1)


def _filter(rows: np.ndarray, bpp: int, ftypes: np.ndarray) -> bytes:
    """Each row filtered with its type (0-4), row by row in Python."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for row, ft in zip(rows.astype(np.int64), ftypes):
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        b = prev
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = [np.zeros_like(row), a, b, (a + b) // 2, paeth][int(ft)]
        out.append(bytes([int(ft)]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def write_png(samples: np.ndarray, ctype: int, depth: int, palette=None, trns=None,
              interlace: bool = False, seed: int = 0) -> bytes:
    """(H, W) or (H, W, ch) samples in the file's channel order (palette
    indices for ctype 3) -> PNG bytes, each row with a filter type drawn
    from `seed`; palette (n, 3) uint8, trns the tRNS chunk's body."""
    s = samples.reshape(samples.shape[0], samples.shape[1], -1)
    h, w, ch = s.shape
    assert ch == CHANNELS[ctype]
    bpp = max(ch * depth // 8, 1)
    rng = np.random.default_rng(seed)
    raw = []
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = s[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack_rows(sub, depth)
        raw.append(_filter(rows, bpp, rng.integers(0, 5, len(rows))))
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                             int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", bytes(trns))
    return out + _chunk(b"IDAT", zlib.compress(b"".join(raw), 6)) + _chunk(b"IEND", b"")


def write_bmp(pixels: np.ndarray, bpp: int, palette=None, top_down: bool = False,
              masks=None) -> bytes:
    """A BMP with a 40-byte header (124 with masks, BI_BITFIELDS): pixels
    (H, W) palette indices for 1/4/8 bits with palette (n, 3) BGR, (H, W, 3)
    BGR for 24 bits, (H, W, 4) for 32 bits as BGRA bytes in each pixel's
    little-endian word (or the word's bytes as the masks say)."""
    h, w = pixels.shape[:2]
    pitch = ((w * bpp + 7) // 8 + 3) & -4
    if bpp <= 8:
        rows = _pack_rows(pixels[..., None], bpp) if bpp < 8 else pixels.astype(np.uint8)
    else:
        rows = pixels.astype(np.uint8).reshape(h, -1)
    body = np.zeros((h, pitch), np.uint8)
    body[:, :rows.shape[1]] = rows
    if not top_down:
        body = body[::-1]
    table = b""
    if palette is not None:
        pal = np.zeros((len(palette), 4), np.uint8)
        pal[:, :3] = palette
        table = pal.tobytes()
    size = 124 if masks is not None else 40
    n_colours = 0 if palette is None else len(palette)
    info = struct.pack("<IiiHHIIiiII", size, w, -h if top_down else h, 1, bpp,
                       3 if masks is not None else 0, pitch * h, 2835, 2835, n_colours, 0)
    if masks is not None:
        info += struct.pack("<4I", *masks)
    info += bytes(size - len(info))
    offset = 14 + size + len(table)
    header = b"BM" + struct.pack("<IHHI", offset + body.size, 0, 0, offset)
    return header + info + table + body.tobytes()
