"""Baseline JPEG without cv2 (the card's machine has none): a decoder that
gives what cv2.imread gives, and an encoder for cv2.imwrite's '.jpg' paths.

The decoder reads baseline and extended sequential DCT, Huffman-coded,
8-bit files with one (grey) or three (YCbCr) components in one scan, at any
sampling factors, with restart intervals, and reproduces libjpeg-turbo's
default decode (ITU-T T.81 Annex A/F):
- the entropy decode is the one sequential loop, over 16-bit windows of
  the bit stream with a lookahead table per Huffman table that holds the
  code and, where they fit, the value bits (libjpeg's fast path);
- the integer "islow" IDCT (13-bit constants, 2 pass-1 bits): each pass is
  a linear map in integers followed by one rounding shift, so it runs as an
  exact int64 matrix product over all blocks at once; the output is
  clamped to 8 bits as libjpeg-turbo's SIMD code does (its C table wraps
  only where |value| >= 512, which no valid file reaches);
- "fancy" triangular upsampling for h2v1, h2v2 and h1v2 chroma (weights
  3:1 with libjpeg's alternating rounding biases, edge samples replicated
  beyond the component's own width and height), plain replication for
  every other factor;
- the fixed-point YCbCr -> RGB tables (16 fraction bits), output in BGR.
A file that runs out of data decodes as libjpeg does: zero bits past the
end for the MCU that ran out, then grey (all-zero coefficients) for the
rest of its restart interval.

Progressive, arithmetic-coded, lossless, hierarchical and 12-bit files,
CMYK, Adobe YCCK or RGB colour, and files with more than one scan raise
NotImplementedError.  A file that cannot be a JPEG raises DecodeError (where
cv2.imread returns None); a bad Huffman code or a coefficient past the
block's end raises DecodeError too, where libjpeg warns and goes on.

The encoder writes baseline files with cv2's defaults: quality 95 with
libjpeg's quality scaling of the Annex K tables, 4:2:0 for colour, the
Annex K Huffman tables, a JFIF header."""

import functools
import struct
from typing import Dict, List, Tuple

import numpy as np


class DecodeError(ValueError):
    """The data is not a decodable image: where cv2.imread returns None."""


class CorruptData(ValueError):
    """Corrupt entropy-coded data, which libjpeg decodes past with a warning
    (so cv2.imread returns an image) and the port does not reproduce."""


# zigzag position -> natural (row-major) index, T.81 Figure A.6
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Annex K: the example quantization tables (natural order) and Huffman tables
_K_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_K_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)
_AC_LUMA_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a82838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
STD_HUFFMAN = {  # (class, id) -> (counts of codes of length 1..16, symbols)
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), _AC_LUMA_VALS),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), _AC_CHROMA_VALS),
}

_SOF_UNSUPPORTED = {
    0xC2: "progressive DCT", 0xC3: "lossless", 0xC5: "differential sequential DCT",
    0xC6: "differential progressive DCT", 0xC7: "differential lossless",
    0xC9: "arithmetic-coded sequential DCT", 0xCA: "arithmetic-coded progressive DCT",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded differential sequential",
    0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless"}


def _huffman_codes(counts, symbols) -> List[Tuple[int, int, int]]:
    """(code, length, symbol) of a table in canonical order (T.81 Annex C)."""
    out, code, k = [], 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out.append((code, length, symbols[k]))
            code += 1
            k += 1
        code <<= 1
    return out


@functools.lru_cache(maxsize=16)
def _lookahead(counts, symbols, ac: bool):
    """Per 16-bit window w (the next 16 bits of the stream, MSB first): a
    tuple (bits consumed, run, value) where the code and its value bits fit
    in 16 bits, else (0, code length, symbol), or (0, 0, 0) where no code
    matches.  An AC coefficient has value != 0 and run = the zeros before
    it; ZRL is (n, 16, 0) and EOB (n, 0, 0) (libjpeg ends the block on any
    symbol with size 0 other than 0xF0)."""
    length = np.zeros(1 << 16, np.int64)
    sym = np.zeros(1 << 16, np.int64)
    for code, n, s in _huffman_codes(counts, symbols):
        lo = code << (16 - n)
        length[lo:lo + (1 << (16 - n))] = n
        sym[lo:lo + (1 << (16 - n))] = s
    size = sym & 15 if ac else sym
    run = sym >> 4 if ac else np.zeros_like(sym)
    total = length + size
    fits = (length > 0) & (total <= 16)
    w = np.arange(1 << 16)
    raw = (w >> np.maximum(16 - total, 0)) & ((1 << size) - 1)
    value = np.where(size == 0, 0, np.where(raw < (1 << np.maximum(size - 1, 0)),
                                            raw - (1 << size) + 1, raw))
    if ac:
        run = np.where(size == 0, np.where(run == 15, 16, 0), run)
    return list(zip(np.where(fits, total, 0).tolist(), np.where(fits, run, length).tolist(),
                    np.where(fits, value, sym).tolist()))


def _extend(raw: int, size: int) -> int:
    return raw - (1 << size) + 1 if size and raw < (1 << (size - 1)) else raw


class _Bits:
    """An entropy-coded segment as 24-bit big-endian windows at each byte,
    zero-padded past its end."""

    def __init__(self, data: bytes, pad: int = 8):
        b = np.frombuffer(data + bytes(pad + 3), np.uint8).astype(np.int64)
        self.win = ((b[:-2] << 16) | (b[1:-1] << 8) | b[2:]).tolist()
        self.nbits = 8 * len(data)

    def get(self, p: int, n: int) -> int:
        """n (<= 16) bits at bit position p."""
        return (self.win[p >> 3] >> (24 - (p & 7) - n)) & ((1 << n) - 1) if n else 0


def _slow_symbol(bits: _Bits, p: int, entry, path: str):
    """A code longer than the window's lookahead allows for its value bits:
    (new position, symbol)."""
    _, n, s = entry
    if n == 0:
        raise CorruptData(f"{path}: corrupt JPEG data: bad Huffman code")
    return p + n, s


def _decode_block(bits, p, dc_tab, ac_tab, pred, out, base, path):
    """One block's coefficients from bit p: appends (base + zigzag index) *
    2^16 + value + 2^15 for each nonzero, returns (p, dc value)."""
    win = bits.win
    e = dc_tab[(win[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
    if e[0]:
        p += e[0]
        dc = pred + e[2]
    else:
        p, s = _slow_symbol(bits, p, e, path)
        if s > 15:
            raise CorruptData(f"{path}: corrupt JPEG data: DC size {s}")
        dc = pred + _extend(bits.get(p, s), s)
        p += s
    if not -32768 <= dc <= 32767:
        raise CorruptData(f"{path}: corrupt JPEG data: DC value {dc}")
    if dc:
        out.append(base + dc)
    k = 1
    while k < 64:
        e = ac_tab[(win[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
        n, r, v = e
        if n:
            p += n
            if v:
                k += r
                if k > 63:
                    raise CorruptData(f"{path}: corrupt JPEG data: coefficient past 63")
                out.append(base + (k << 16) + v)
                k += 1
            elif r:
                k += 16
            else:
                break
        else:
            p, s = _slow_symbol(bits, p, e, path)
            r, size = s >> 4, s & 15
            if size:
                k += r
                if k > 63:
                    raise CorruptData(f"{path}: corrupt JPEG data: coefficient past 63")
                out.append(base + (k << 16) + _extend(bits.get(p, size), size))
                p += size
                k += 1
            elif r == 15:
                k += 16
            else:
                break
    return p, dc


def _split_scan(data: bytes, start: int, path: str):
    """The entropy-coded data from `start`: (segments between RST markers,
    unstuffed; whether a marker ends the scan, False where the data does)."""
    arr = np.frombuffer(data, np.uint8)
    ff = np.flatnonzero(arr[start:-1] == 0xFF) + start
    nxt = arr[ff + 1]
    ends = ff[(nxt != 0) & (nxt != 0xFF) & ((nxt < 0xD0) | (nxt > 0xD7))]
    end = int(ends[0]) if len(ends) else len(data)
    rst = ff[(ff < end) & (nxt >= 0xD0) & (nxt <= 0xD7)]
    bounds = [start] + [b for r in rst.tolist() for b in (r, r + 2)] + [end]
    segments = []
    for a, b in zip(bounds[0::2], bounds[1::2]):
        # fill bytes before a marker, then the stuffed zero bytes
        segments.append(data[a:b].rstrip(b"\xff").replace(b"\xff\x00", b"\xff"))
    return segments, bool(len(ends))


def _exif_orientation(body: bytes) -> int:
    """The Orientation tag (0x0112) of an APP1 Exif body, 1 if absent."""
    if body[:6] != b"Exif\x00\x00" or len(body) < 14:
        return 1
    tiff = body[6:]
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None:
        return 1
    try:
        (ifd,) = struct.unpack(order + "I", tiff[4:8])
        (count,) = struct.unpack(order + "H", tiff[ifd:ifd + 2])
        for i in range(count):
            tag, kind, _, value = struct.unpack(order + "HHI4s",
                                                tiff[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
            if tag == 0x0112 and kind == 3:
                (o,) = struct.unpack(order + "H", value[:2])
                return o if 1 <= o <= 8 else 1
    except struct.error:
        return 1
    return 1


def _parse(data: bytes, path: str) -> Dict:
    """Markers up to the end of the (single) scan."""
    if data[:2] != b"\xff\xd8":
        raise DecodeError(f"{path}: not a JPEG file")
    qt: Dict[int, np.ndarray] = {}
    ht: Dict[Tuple[int, int], Tuple] = {}
    info = dict(restart=0, orientation=1, adobe=None, jfif=False)
    pos = 2
    while True:
        while pos < len(data) and data[pos] == 0xFF and pos + 1 < len(data) \
                and data[pos + 1] == 0xFF:
            pos += 1
        if pos + 4 > len(data) or data[pos] != 0xFF:
            raise DecodeError(f"{path}: corrupt or truncated JPEG header")
        marker = data[pos + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker == 0xD9:
            raise DecodeError(f"{path}: JPEG without a scan")
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        if len(body) != length - 2:
            raise DecodeError(f"{path}: truncated JPEG header")
        if marker in _SOF_UNSUPPORTED:
            raise NotImplementedError(f"{path}: {_SOF_UNSUPPORTED[marker]} JPEG is not "
                                      "supported (baseline and extended sequential only)")
        if marker == 0xCC:
            raise NotImplementedError(f"{path}: arithmetic-coded JPEG is not supported")
        if marker == 0xDB:
            k = 0
            while k < len(body):
                pq, tq = body[k] >> 4, body[k] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body[k + 1:k + 1 + n], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                qt[tq] = table
                k += 1 + n
        elif marker == 0xC4:
            k = 0
            while k < len(body):
                tc, th = body[k] >> 4, body[k] & 15
                counts = tuple(body[k + 1:k + 17])
                n = sum(counts)
                ht[(tc, th)] = (counts, body[k + 17:k + 17 + n])
                k += 17 + n
        elif marker in (0xC0, 0xC1):
            precision, h, w, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise NotImplementedError(f"{path}: {precision}-bit JPEG is not supported "
                                          "(8-bit only)")
            if nc not in (1, 3):
                raise NotImplementedError(f"{path}: JPEG with {nc} components (CMYK or YCCK) "
                                          "is not supported (grey or YCbCr only)")
            if h == 0 or w == 0:
                raise NotImplementedError(f"{path}: JPEG with its height in a DNL marker "
                                          "is not supported")
            comps = [dict(id=body[6 + 3 * i], h=body[7 + 3 * i] >> 4,
                          v=body[7 + 3 * i] & 15, tq=body[8 + 3 * i]) for i in range(nc)]
            info.update(height=h, width=w, comps=comps)
        elif marker == 0xDD:
            (info["restart"],) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            info["jfif"] = True
        elif marker == 0xE1 and info["orientation"] == 1:
            info["orientation"] = _exif_orientation(body)
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            info["adobe"] = body[11]
        elif marker == 0xDA:
            if "comps" not in info:
                raise DecodeError(f"{path}: JPEG scan before its frame header")
            ns = body[0]
            scan = [(body[1 + 2 * i], body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15)
                    for i in range(ns)]
            if ns != len(info["comps"]):
                raise NotImplementedError(f"{path}: JPEG with more than one scan is not "
                                          "supported (one interleaved scan only)")
            info.update(qt=qt, ht=ht, scan=scan, scan_start=pos + 2 + length)
            return info
        pos += 2 + length


def _decode_coefficients(data: bytes, info: Dict, path: str) -> List[np.ndarray]:
    """Every component's dequantized coefficients, (rows, cols, 64) natural
    order int64 over its MCU-padded block grid."""
    comps = info["comps"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mx = -(-info["width"] // (8 * hmax))
    my = -(-info["height"] // (8 * vmax))
    by_id = {c["id"]: i for i, c in enumerate(comps)}
    tables = {}
    order = []  # (component index, block row in MCU, block col in MCU, dc tab, ac tab)
    for cid, td, ta in info["scan"]:
        if cid not in by_id:
            raise DecodeError(f"{path}: scan names an unknown component {cid}")
        for key in ((0, td), (1, ta)):
            if key not in tables:
                counts, syms = info["ht"].get(key) or STD_HUFFMAN[key]
                tables[key] = _lookahead(counts, syms, ac=key[0] == 1)
        ci = by_id[cid]
        c = comps[ci]
        if c["tq"] not in info["qt"]:
            raise DecodeError(f"{path}: missing quantization table {c['tq']}")
        for by in range(c["v"]):
            for bx in range(c["h"]):
                order.append((ci, by, bx, tables[(0, td)], tables[(1, ta)]))
    blocks_per_mcu = len(order)
    n_mcu = mx * my
    restart = info["restart"] or n_mcu
    segments, ended = _split_scan(data, info["scan_start"], path)
    n_seg = -(-n_mcu // restart)
    if len(segments) < n_seg:
        if ended:
            raise CorruptData(f"{path}: corrupt JPEG data: {len(segments)} restart intervals "
                              f"of {n_seg}")
    out: List[int] = []
    for s in range(len(segments[:n_seg])):  # intervals after the data's end stay zero
        bits = _Bits(segments[s])
        p = 0
        pred = [0] * len(comps)
        for m in range(s * restart, min((s + 1) * restart, n_mcu)):
            start, mark, saved = p, len(out), list(pred)
            try:
                for j, (ci, _, _, dct, act) in enumerate(order):
                    p, pred[ci] = _decode_block(bits, p, dct, act, pred[ci], out,
                                                (((m * blocks_per_mcu + j) * 64) << 16) + 32768,
                                                path)
            except IndexError:  # read far past the end of the data
                p = bits.nbits + 1
            if p > bits.nbits:
                # libjpeg reads zero bits past the end for this MCU, then leaves
                # the rest of the interval at zero
                del out[mark:]
                zbits = _Bits(segments[s], pad=64 * 64 * blocks_per_mcu)
                p, pred = start, saved
                for j, (ci, _, _, dct, act) in enumerate(order):
                    p, pred[ci] = _decode_block(zbits, p, dct, act, pred[ci], out,
                                                (((m * blocks_per_mcu + j) * 64) << 16) + 32768,
                                                path)
                break
    packed = np.asarray(out, np.int64)
    zz = np.zeros(n_mcu * blocks_per_mcu * 64, np.int64)
    zz[packed >> 16] = (packed & 0xFFFF) - 32768
    zz = zz.reshape(my, mx, blocks_per_mcu, 64)
    planes = []
    for ci, c in enumerate(comps):
        js = [j for j, o in enumerate(order) if o[0] == ci]
        coef = np.zeros((my, mx, c["v"], c["h"], 64), np.int64)
        for j in js:
            _, by, bx, _, _ = order[j]
            coef[:, :, by, bx, ZIGZAG] = zz[:, :, j]
        coef = coef.transpose(0, 2, 1, 3, 4).reshape(my * c["v"], mx * c["h"], 64)
        coef = coef * info["qt"][c["tq"]]
        if np.abs(coef).max(initial=0) > 32767:  # libjpeg-turbo's SIMD IDCT wraps there
            raise CorruptData(f"{path}: corrupt JPEG data: dequantized coefficient past 16 bits")
        planes.append(coef)
    return planes


# jpeg_idct_islow (T.81 Annex A.3.3 in libjpeg's integer form)
_CONST_BITS, _PASS1_BITS = 13, 2
_FIX = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373, f1175=9633,
            f1501=12299, f1847=15137, f1961=16069, f2053=16819, f2562=20995, f3072=25172)


def _islow_1d(x):
    """One 8-point pass of jpeg_idct_islow before its rounding shift: a
    linear map of integers (the zero-AC shortcuts give the same values)."""
    f = _FIX
    z1 = (x[2] + x[6]) * f["f0541"]
    tmp2 = z1 - x[6] * f["f1847"]
    tmp3 = z1 + x[2] * f["f0765"]
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * f["f1175"]
    o0, o1, o2, o3 = o0 * f["f0298"], o1 * f["f2053"], o2 * f["f3072"], o3 * f["f1501"]
    z1, z2 = z1 * -f["f0899"], z2 * -f["f2562"]
    z3, z4 = z3 * -f["f1961"] + z5, z4 * -f["f0390"] + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    return [t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3]


_IDCT_M = np.array([_islow_1d([int(i == j) for j in range(8)]) for i in range(8)], np.int64)


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """(..., 64) dequantized coefficients (natural order) -> (..., 8, 8)
    uint8 samples, jpeg_idct_islow's arithmetic."""
    c = coef.reshape(-1, 8, 8)  # [n, u (vertical frequency), v]
    # pass 1 down each column: ws[n, v, y]; pass 2 along each row: out[n, y, x]
    s1 = _CONST_BITS - _PASS1_BITS
    ws = (c.transpose(0, 2, 1) @ _IDCT_M + (1 << (s1 - 1))) >> s1
    s2 = _CONST_BITS + _PASS1_BITS + 3
    out = (ws.transpose(0, 2, 1) @ _IDCT_M + (1 << (s2 - 1))) >> s2
    return (np.clip(out, -128, 127) + 128).astype(np.uint8).reshape(coef.shape[:-1] + (8, 8))


def _plane(coef: np.ndarray) -> np.ndarray:
    rows, cols, _ = coef.shape
    return idct_islow(coef).transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)


def _upsample(plane: np.ndarray, ch: int, cv: int, hmax: int, vmax: int,
              comp_h: int, comp_w: int, out_h: int, out_w: int) -> np.ndarray:
    """A chroma plane to the image's sampling, as libjpeg-turbo's upsampler
    does with do_fancy_upsampling (its default)."""
    fx, fy = hmax // ch, vmax // cv
    if hmax % ch or vmax % cv:
        raise NotImplementedError("JPEG with non-integral sampling ratios is not supported")
    x = plane[:comp_h, :comp_w].astype(np.int32)
    if (fx, fy) == (1, 1):
        return x[:out_h, :out_w]
    if fx == 2 and fy == 1 and comp_w > 2:  # h2v1_fancy_upsample
        e = np.pad(x, ((0, 0), (1, 1)), mode="edge")
        left = (3 * x + e[:, :-2] + 1) >> 2
        right = (3 * x + e[:, 2:] + 2) >> 2
        y = np.stack([left, right], axis=2).reshape(comp_h, 2 * comp_w)
    elif fx == 1 and fy == 2:  # h1v2_fancy_upsample
        e = np.pad(x, ((1, 1), (0, 0)), mode="edge")
        top = (3 * x + e[:-2] + 1) >> 2
        bottom = (3 * x + e[2:] + 2) >> 2
        y = np.stack([top, bottom], axis=1).reshape(2 * comp_h, comp_w)
    elif fx == 2 and fy == 2 and comp_w > 2:  # h2v2_fancy_upsample
        e = np.pad(x, ((1, 1), (0, 0)), mode="edge")
        rows = np.stack([3 * x + e[:-2], 3 * x + e[2:]], axis=1).reshape(2 * comp_h, comp_w)
        r = np.pad(rows, ((0, 0), (1, 1)), mode="edge")
        left = (3 * rows + r[:, :-2] + 8) >> 4
        right = (3 * rows + r[:, 2:] + 7) >> 4
        y = np.stack([left, right], axis=2).reshape(2 * comp_h, 2 * comp_w)
    else:  # int_upsample (and h2v1/h2v2 at widths of 2 or less): replication
        y = np.repeat(np.repeat(plane.astype(np.int32), fy, axis=0), fx, axis=1)
    return y[:out_h, :out_w]


# jdcolor.c's YCbCr -> RGB tables
_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


_X = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _X + _ONE_HALF) >> _SCALEBITS
_CB_B = (_fix(1.77200) * _X + _ONE_HALF) >> _SCALEBITS
_CR_G = -_fix(0.71414) * _X
_CB_G = -_fix(0.34414) * _X + _ONE_HALF
del _X


def ycc_to_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """uint8-valued planes -> (H, W, 3) uint8 BGR, ycc_rgb_convert's
    arithmetic."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> _SCALEBITS)
    b = y + _CB_B[cb]
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ApplyExifOrientation for EXIF Orientation values 1-8."""
    if orientation >= 5:
        img = img.swapaxes(0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def jpeg_decode(data: bytes, grey: bool = False, path: str = "<bytes>") -> Tuple[np.ndarray, int]:
    """JPEG bytes -> ((H, W) uint8 for a grey file or with grey=True, else
    (H, W, 3) uint8 BGR; the EXIF Orientation value, not applied)."""
    info = _parse(data, path)
    comps = info["comps"]
    if len(comps) == 3:
        ids = tuple(c["id"] for c in comps)
        rgb = (info["adobe"] == 0) if info["adobe"] is not None else (
            not info["jfif"] and ids == (82, 71, 66))
        if rgb:
            raise NotImplementedError(f"{path}: RGB-coded JPEG is not supported (YCbCr only)")
    coefs = _decode_coefficients(data, info, path)
    h, w = info["height"], info["width"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    planes = []
    for ci, (c, coef) in enumerate(zip(comps, coefs)):
        if ci and grey:
            break
        comp_h = -(-h * c["v"] // vmax)
        comp_w = -(-w * c["h"] // hmax)
        planes.append(_upsample(_plane(coef), c["h"], c["v"], hmax, vmax,
                                comp_h, comp_w, h, w))
    if len(planes) == 1:
        return planes[0].astype(np.uint8), info["orientation"]
    return ycc_to_bgr(*planes), info["orientation"]


# --- the encoder ---------------------------------------------------------

def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling applied to an Annex K table,
    baseline-limited to 1..255."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    return m  # F = M f M^T (T.81 A.3.3)


_DCT = _dct_matrix()


def _blocks(plane: np.ndarray) -> np.ndarray:
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _encode_table(counts, symbols):
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    for c, n, s in _huffman_codes(counts, symbols):
        code[s], size[s] = c, n
    return code, size


def _bit_size(v: np.ndarray) -> np.ndarray:
    a = np.abs(v)
    return np.where(a == 0, 0, np.floor(np.log2(np.maximum(a, 1))).astype(np.int64) + 1)


def _huffman_stream(zz: np.ndarray, comp_of_block: np.ndarray, table_of_comp: np.ndarray,
                    dc_tabs, ac_tabs) -> bytes:
    """(nblocks, 64) quantized coefficients in zigzag and scan order, each
    block's component and each component's table -> the
    Huffman-coded, byte-stuffed scan data, in array passes: every field (a
    code or its value bits) gets a sort key (block, slot, part), the fields
    are sorted by it and packed MSB first.  Slot 2k holds coefficient k
    (k = 0 the DC difference), odd slots before it its ZRLs, slot 129 EOB."""
    nb = len(zz)
    codes, lens, keys = [], [], []

    def emit_symbol(block, slot, symbol, tabs):
        c = np.zeros(len(symbol), np.int64)
        n = np.zeros(len(symbol), np.int64)
        comp = table_of_comp[comp_of_block[block]]
        for t, (code, size) in enumerate(tabs):
            sel = comp == t
            c[sel], n[sel] = code[symbol[sel]], size[symbol[sel]]
        codes.append(c)
        lens.append(n)
        keys.append((block * 256 + slot) * 2)

    def emit_value(block, slot, v, s):
        codes.append(np.where(v < 0, v + (1 << s) - 1, v) & ((1 << s) - 1))
        lens.append(s)
        keys.append((block * 256 + slot) * 2 + 1)

    # DC: differences within each component, in scan order
    dc = zz[:, 0]
    diff = np.zeros(nb, np.int64)
    for t in np.unique(comp_of_block):
        idx = np.flatnonzero(comp_of_block == t)
        diff[idx] = np.diff(dc[idx], prepend=0)
    s = _bit_size(diff)
    blocks = np.arange(nb)
    zero = np.zeros(nb, np.int64)
    emit_symbol(blocks, zero, s, dc_tabs)
    emit_value(blocks, zero, diff, s)
    # AC: each nonzero after its run of zeros (a ZRL per 16 of them), then
    # EOB where the block's last nonzero is before 63
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[b, k]
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    nzrl = run // 16
    if nzrl.any():
        zb = np.repeat(b, nzrl)
        i = np.arange(len(zb)) - np.repeat(np.cumsum(nzrl) - nzrl, nzrl)
        slot = np.repeat(2 * k - 2 * nzrl - 1, nzrl) + 2 * i
        emit_symbol(zb, slot, np.full(len(zb), 0xF0), ac_tabs)
    s = _bit_size(v)
    emit_symbol(b, 2 * k, (run % 16) * 16 + s, ac_tabs)
    emit_value(b, 2 * k, v, s)
    last = np.zeros(nb, np.int64)
    np.maximum.at(last, b, k)
    eob = np.flatnonzero(last < 63)
    emit_symbol(eob, np.full(len(eob), 129), np.zeros(len(eob), np.int64), ac_tabs)
    order = np.argsort(np.concatenate(keys), kind="stable")
    code, size = np.concatenate(codes)[order], np.concatenate(lens)[order]
    code, size = code[size > 0], size[size > 0]
    shift = size[:, None] - 1 - np.arange(16)[None, :]
    bitstream = ((code[:, None] >> np.maximum(shift, 0)) & 1)[shift >= 0]
    bitstream = np.concatenate([bitstream, np.ones((-len(bitstream)) % 8, np.int64)])
    return np.packbits(bitstream.astype(np.uint8)).tobytes().replace(b"\xff", b"\xff\x00")


def jpeg_encode(img: np.ndarray, quality: int = 95) -> bytes:
    """(H, W) grey or (H, W, 3) BGR uint8 -> baseline JPEG bytes (4:2:0 for
    colour, quality-scaled Annex K tables, the Annex K Huffman tables)."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise TypeError(f"JPEG holds (H, W) or (H, W, 3) uint8, not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    if img.ndim == 3:
        b, g, r = (img[..., i].astype(np.float64) for i in range(3))
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
        samp = [(2, 2), (1, 1), (1, 1)]
    else:
        planes, samp = [img.astype(np.float64)], [(1, 1)]
    hmax, vmax = samp[0]
    mh, mw = -(-h // (8 * vmax)) * 8 * vmax, -(-w // (8 * hmax)) * 8 * hmax
    qts = [quality_table(_K_LUMA_Q, quality), quality_table(_K_CHROMA_Q, quality)]
    comp_blocks = []
    for i, (plane, (ch, cv)) in enumerate(zip(planes, samp)):
        p = np.pad(plane, ((0, mh - h), (0, mw - w)), mode="edge")
        fy, fx = vmax // cv, hmax // ch
        p = p.reshape(mh // fy, fy, mw // fx, fx).mean(axis=(1, 3))
        f = _DCT @ _blocks(p - 128.0) @ _DCT.T
        q = np.rint(f / qts[min(i, 1)].reshape(8, 8)).astype(np.int64)
        comp_blocks.append(q.reshape(q.shape[0], q.shape[1], 64)[..., ZIGZAG])
    my, mx = mh // (8 * vmax), mw // (8 * hmax)
    per_mcu, comp_ids = [], []
    for i, ((ch, cv), q) in enumerate(zip(samp, comp_blocks)):
        q = q.reshape(my, cv, mx, ch, 64).transpose(0, 2, 1, 3, 4).reshape(my, mx, ch * cv, 64)
        per_mcu.append(q)
        comp_ids += [i] * (ch * cv)
    zz = np.concatenate(per_mcu, axis=2).reshape(-1, 64)
    comp_of_block = np.tile(np.array(comp_ids), my * mx)
    nt = 2 if img.ndim == 3 else 1
    dc_tabs = [_encode_table(*STD_HUFFMAN[(0, t)]) for t in range(nt)]
    ac_tabs = [_encode_table(*STD_HUFFMAN[(1, t)]) for t in range(nt)]
    scan = _huffman_stream(zz, comp_of_block, np.array([0, 1, 1]), dc_tabs, ac_tabs)

    def seg(marker: int, body: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    out = [b"\xff\xd8", seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in range(nt):
        out.append(seg(0xDB, bytes([t]) + bytes(qts[t][ZIGZAG].astype(np.uint8))))
    ncomp = len(planes)
    sof = struct.pack(">BHHB", 8, h, w, ncomp) + b"".join(
        bytes([i + 1, (ch << 4) | cv, min(i, 1)]) for i, (ch, cv) in enumerate(samp))
    out.append(seg(0xC0, sof))
    for (tc, th), (counts, syms) in sorted(STD_HUFFMAN.items()):
        if th < nt:
            out.append(seg(0xC4, bytes([(tc << 4) | th]) + bytes(counts) + syms))
    sos = bytes([ncomp]) + b"".join(bytes([i + 1, (min(i, 1) << 4) | min(i, 1)])
                                    for i in range(ncomp)) + b"\x00\x3f\x00"
    out += [seg(0xDA, sos), scan, b"\xff\xd9"]
    return b"".join(out)
