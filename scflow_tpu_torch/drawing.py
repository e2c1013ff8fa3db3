"""cv2's LINE_8, shift-0 drawing calls that the pose overlays use
(visualize.py), in numpy and plain Python, pixel for pixel:

- line(img, p0, p1, color, thickness): cv2.line.  Thickness 1 is the
  8-connected Bresenham walk, left to right, after cv2's clip of the
  segment to the image.  Thickness 2 or more first clips the segment to
  the image grown by the thickness on every side, then fills a convex
  quad in 16-bit fixed point (its edges walked in fixed point, its rows
  filled between edges stepped in fixed point) and a filled circle of
  radius (thickness + 1) // 2 at each end (imops.fill_circle).
- find_contours_external(mask): cv2.findContours(mask, RETR_EXTERNAL,
  CHAIN_APPROX_SIMPLE)'s contours: Suzuki-Abe border following on the
  mask padded by one zero pixel, outer borders only (a border inside a
  traced component's hole is skipped), each run of equal steps kept as
  its first point, in cv2's order (the last border found first).
- draw_contours(img, contours, color, thickness): cv2.drawContours with
  every contour and no hierarchy: each contour a closed polyline, one
  line() per pair of consecutive points.

No source of OpenCV is used: each behaviour was rebuilt from cv2 5.0.0's
output and is held to it by tests/test_torch_drawing.py.  Coordinates are
Python or numpy integers; like cv2, a coordinate outside int32 raises."""

import math
from typing import Sequence, Tuple

import numpy as np

from scflow_tpu_torch.datasets.pipelines.imops import fill_circle

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_INT_MIN, _INT_MAX = -(1 << 31), (1 << 31) - 1


def _point(p) -> Tuple[int, int]:
    x, y = int(p[0]), int(p[1])
    if not (_INT_MIN <= x <= _INT_MAX and _INT_MIN <= y <= _INT_MAX):
        raise ValueError(f"point {tuple(p)} is outside int32 (cv2 refuses it)")
    return x, y


def _color(img: np.ndarray, color):
    """cv2's scalar for the image: the first `channels` values, rounded and
    saturated to the image's dtype."""
    vals = [color] if np.isscalar(color) else list(color)
    ch = 1 if img.ndim == 2 else img.shape[2]
    vals = (vals + [0] * ch)[:ch]
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        vals = [int(np.clip(np.rint(v), info.min, info.max)) for v in vals]
    return vals[0] if img.ndim == 2 else np.asarray(vals, img.dtype)


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2.clipLine on [0, w) x [0, h): the clipped end points, or None
    when the segment misses the image.  The second end point is moved
    along the line through the first one's clipped position."""
    if w <= 0 or h <= 0:
        return None
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _line_pixels(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """The pixels of cv2's 8-connected walk from (x1, y1) to (x2, y2),
    both inside int32: the segment clipped to the image, then walked from
    its left end along the major axis, stepping the minor one while the
    error term is negative.  Returns (xs, ys) lists."""
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return [], []
        x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # left to right
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    err = major - 2 * minor
    xs, ys = [], []
    x, y = x1, y1
    for _ in range(major + 1):
        xs.append(x)
        ys.append(y)
        step = err < 0
        err += -2 * minor + (2 * major if step else 0)
        if vert:
            y += sy
            x += step
        else:
            x += 1
            y += sy if step else 0
    return xs, ys


def _line_fixed(img: np.ndarray, value, p1, p2) -> None:
    """cv2's walk of a segment between 16-bit fixed-point end points (the
    edges of a thick line's quad): clipped to the image scaled by 2^16,
    one pixel per major-axis column from the lower end, the minor
    coordinate stepped by the slope in fixed point, and the far end's
    rounded pixel."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1[0], p1[1], p2[0], p2[1])
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    half = XY_ONE >> 1
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        y_step = _cdiv(dy << XY_SHIFT, ax | 1)
        count = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step = _cdiv(dx << XY_SHIFT, ay | 1)
        count = (y2 - y1) >> XY_SHIFT
    x1 += half
    y1 += half
    pts = [((x2 + half) >> XY_SHIFT, (y2 + half) >> XY_SHIFT)]
    if ax > ay:
        x1 >>= XY_SHIFT
        for _ in range(count + 1):
            pts.append((x1, y1 >> XY_SHIFT))
            x1 += 1
            y1 += y_step
    else:
        y1 >>= XY_SHIFT
        for _ in range(count + 1):
            pts.append((x1 >> XY_SHIFT, y1))
            x1 += x_step
            y1 += 1
    for x, y in pts:
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = value


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _fill_convex_fixed(img: np.ndarray, value, v) -> None:
    """cv2's fill of a convex polygon with 16-bit fixed-point vertices
    `v` (a list of (x, y) ints): each edge walked by _line_fixed, then
    the rows from the top vertex's rounded row to the bottom one's, each
    filled between the two edges' x (each edge's x starts at its upper
    vertex and steps by its rounded slope per row; the row spans from the
    left x rounded to the right x rounded)."""
    h, w = img.shape[:2]
    npts = len(v)
    half = XY_ONE >> 1
    p0 = v[-1]
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax = max(ymax, p[1])
        xmax = max(xmax, p[0])
        xmin = min(xmin, p[0])
        _line_fixed(img, value, p0, p)
        p0 = p
    xmin, xmax = (xmin + half) >> XY_SHIFT, (xmax + half) >> XY_SHIFT
    ymin, ymax = (ymin + half) >> XY_SHIFT, (ymax + half) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per edge: [index of its lower vertex, direction, x, dx, last row]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    y = ymin
    edges = npts
    while True:
        for e in edge:
            if y < e[4]:
                continue
            idx0, di = e[0], e[1]
            idx = idx0 + di
            if idx >= npts:
                idx -= npts
            while True:
                more = edges > 0
                edges -= 1
                if not more:
                    break
                ty = (v[idx][1] + half) >> XY_SHIFT
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    e[4] = ty
                    e[3] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                    e[2] = xs
                    e[0] = idx
                    break
                idx0 = idx
                idx += di
                if idx >= npts:
                    idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (edge[1], edge[0]) if edge[0][2] > edge[1][2] else (edge[0], edge[1])
            xx1 = (left[2] + half) >> XY_SHIFT
            xx2 = (right[2] + half) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = value
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> np.ndarray:
    """cv2.line(img, p0, p1, color, thickness) (LINE_8, shift 0) in place;
    returns img.  img is (H, W) or (H, W, C)."""
    x0, y0 = _point(p0)
    x1, y1 = _point(p1)
    value = _color(img, color)
    h, w = img.shape[:2]
    thickness = int(thickness)
    if thickness <= 1:
        xs, ys = _line_pixels(w, h, x0, y0, x1, y1)
        if xs:
            img[np.asarray(ys), np.asarray(xs)] = value
        return img
    # first clipped to the image grown by `thickness` on every side
    clipped = _clip_line(w + 2 * thickness, h + 2 * thickness, x0 + thickness, y0 + thickness,
                         x1 + thickness, y1 + thickness)
    if clipped is None:
        return img
    x0, y0, x1, y1 = (c - thickness for c in clipped)
    fx0, fy0, fx1, fy1 = (c << XY_SHIFT for c in (x0, y0, x1, y1))
    dx = (fx0 - fx1) / XY_ONE
    dy = (fy1 - fy0) / XY_ONE
    r = dx * dx + dy * dy
    half_width = thickness << (XY_SHIFT - 1)
    if abs(r) > 2.220446049250313e-16:
        r = (half_width + (thickness & 1) * XY_ONE * 0.5) / math.sqrt(r)
        ex, ey = round(dy * r), round(dx * r)
        _fill_convex_fixed(img, value, [(fx0 + ex, fy0 + ey), (fx0 - ex, fy0 - ey),
                                        (fx1 - ex, fy1 - ey), (fx1 + ex, fy1 + ey)])
    radius = (half_width + (XY_ONE >> 1)) >> XY_SHIFT
    for x, y in ((x0, y0), (x1, y1)):
        fill_circle(img, (x, y), radius, value)
    return img


_STEPS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))


def _follow_outer(img: list, step: int, i0: int, x: int, y: int):
    """Follow the outer border that starts at flat index i0 (pixel (x, y)
    of the padded image `img`, a flat list of 0, 1 and marks), marking
    each border pixel 2, or -126 where the search around it passed over
    its right neighbour as background; returns its CHAIN_APPROX_SIMPLE
    points (each direction change's pixel) in the padded frame."""
    deltas = (1, 1 - step, -step, -step - 1, -1, step - 1, step, step + 1) * 2
    s_end = s = 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if img[i1] != 0 or s == s_end:
            break
    if s == s_end:  # a lone pixel
        img[i0] = -126
        return [(x, y)]
    pts = []
    i3, prev_s = i0, s ^ 4
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if img[i4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:  # the search passed the right neighbour
            img[i3] = -126
        elif img[i3] == 1:
            img[i3] = 2
        if s != prev_s:
            pts.append((x, y))
            prev_s = s
        x += _STEPS[s][0]
        y += _STEPS[s][1]
        if i4 == i0 and i3 == i1:
            return pts
        i3 = i4
        s = (s + 4) & 7


def find_contours_external(mask: np.ndarray) -> tuple:
    """cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]
    for a 2-D mask (any nonzero pixel is foreground): a tuple of (k, 1, 2)
    int32 arrays of (x, y) points, the border found last first (cv2's
    order); () for an empty mask."""
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"mask must be 2-D, got shape {mask.shape}")
    h, w = mask.shape
    step = w + 2
    padded = np.zeros((h + 2, step), np.int8)
    padded[1:-1, 1:-1] = mask != 0
    img = padded.ravel().tolist()
    rows = np.flatnonzero(padded.any(1)).tolist()
    found = []
    for y in rows:
        base = y * step
        lnbd = base  # the last border pixel passed on this row
        prev = 0
        x = 1
        while x <= w:
            p = img[base + x]
            if p == prev:
                x += 1
                continue
            if prev == 0 and p == 1 and img[lnbd] <= 0:  # an outer border, not in a hole
                pts = _follow_outer(img, step, base + x, x, y)
                found.append(np.asarray(pts, np.int32).reshape(-1, 1, 2) - 1)
                prev = img[base + x]
                x += 1
                continue
            if p == 0 and prev >= 2:  # leaving a marked border into background
                lnbd = base + x - 1
            prev = p
            if prev & -2:
                lnbd = base + x
            x += 1
    return tuple(reversed(found))


def draw_contours(img: np.ndarray, contours: Sequence, color, thickness: int = 1) -> np.ndarray:
    """cv2.drawContours(img, contours, -1, color, thickness) for thickness
    >= 1 in place: each contour's consecutive points, the last joined to the
    first, drawn by line().  Returns img."""
    if thickness < 1:
        raise ValueError("draw_contours draws outlines (thickness >= 1); cv2's filled "
                         "contours are not ported")
    for c in contours:
        pts = np.asarray(c).reshape(-1, 2)
        n = len(pts)
        for j in range(n):
            line(img, pts[j], pts[(j + 1) % n], color, thickness)
    return img
