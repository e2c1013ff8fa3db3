"""The port's cv2-free drawing (scflow_tpu_torch/drawing.py) against the
test host's cv2 (5.0.0), bit for bit: cv2.line at thickness 1-3,
cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)'s point lists, and
cv2.drawContours at thickness 1-2.  The cases are seeded and include the
overlays' trouble spots: end points far outside the image (a point
projected near the camera plane), zero-length segments, masks that touch
the border, one-pixel components and one-pixel necks, and masks with holes
and components inside the holes (which RETR_EXTERNAL skips)."""

import cv2
import numpy as np
import pytest

from scflow_tpu_torch import drawing

from torch_port_helpers import keep_torch_rng  # noqa: F401

CASES = 250  # per parametrised case


def _point(rng, h, w, where):
    if where == "inside":
        return int(rng.integers(0, w)), int(rng.integers(0, h))
    if where == "near":  # a few pixels around the border
        return int(rng.integers(-4, w + 4)), int(rng.integers(-4, h + 4))
    if where == "far":  # a projection near the camera plane
        return int(rng.integers(-2 * 10**9, 2 * 10**9)), int(rng.integers(-2 * 10**9, 2 * 10**9))
    return int(rng.integers(-3 * w, 4 * w)), int(rng.integers(-3 * h, 4 * h))


@pytest.mark.parametrize("thickness", [1, 2, 3])
@pytest.mark.parametrize("where", ["inside", "near", "far", "around", "zero_length"])
def test_line_matches_cv2(thickness, where):
    rng = np.random.default_rng([thickness, len(where)])
    for _ in range(CASES):
        h, w = (int(v) for v in rng.integers(1, 48, 2))
        if where == "zero_length":
            p0 = _point(rng, h, w, "near")
            p1 = p0
        else:
            p0 = _point(rng, h, w, where)
            p1 = _point(rng, h, w, rng.choice(["inside", where]))
        want = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        got = want.copy()
        cv2.line(want, p0, p1, (0, 255, 0), thickness)
        drawing.line(got, p0, p1, (0, 255, 0), thickness)
        assert np.array_equal(got, want), (h, w, p0, p1, thickness)


def test_line_on_grey_and_int32_limits():
    img = np.zeros((9, 11), np.uint8)
    want = img.copy()
    for p0, p1 in (((2**31 - 1, 4), (-2**31, 3)), ((5, 5), (5, -2**31))):
        for t in (1, 2):
            cv2.line(want, p0, p1, 200, t)
            drawing.line(img, p0, p1, 200, t)
    assert np.array_equal(img, want)
    with pytest.raises(ValueError, match="int32"):
        drawing.line(img, (0, 0), (2**31, 0), 1, 2)  # cv2 refuses it too


def _mask(rng, kind, h, w):
    if kind == "noise":
        return rng.random((h, w)) < rng.uniform(0.05, 0.9)
    if kind == "boxes":  # toggled boxes: holes, boxes inside holes, border contact
        m = np.zeros((h, w), bool)
        for _ in range(int(rng.integers(1, 7))):
            y, x = int(rng.integers(-2, h)), int(rng.integers(-2, w))
            m[max(y, 0):y + int(rng.integers(1, 12)), max(x, 0):x + int(rng.integers(1, 12))] ^= True
        return m
    if kind == "rings":  # annuli with a blob or a pixel inside the hole
        yy, xx = np.mgrid[:h, :w]
        cy, cx = rng.uniform(-2, h + 2), rng.uniform(-2, w + 2)
        r2 = (yy - cy) ** 2 + (xx - cx) ** 2
        outer = rng.uniform(4, 200)
        m = (r2 < outer) & (r2 >= rng.uniform(0.3, 0.8) * outer)
        m |= r2 < rng.uniform(0, 0.2) * outer
        return m
    # thin: one-pixel components, lines and necks
    m = np.zeros((h, w), bool)
    for _ in range(int(rng.integers(1, 8))):
        y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
        if rng.random() < 0.4:
            m[y, x] = True
        elif rng.random() < 0.5:
            m[y, x:x + int(rng.integers(1, 10))] = True
        else:
            n = int(rng.integers(1, 10))
            idx = np.arange(n)
            ys, xs = np.clip(y + idx, 0, h - 1), np.clip(x + idx * rng.choice([-1, 1]), 0, w - 1)
            m[ys, xs] = True
    return m


@pytest.mark.parametrize("kind", ["noise", "boxes", "rings", "thin"])
def test_find_contours_matches_cv2(kind):
    rng = np.random.default_rng(len(kind))
    for _ in range(CASES):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        m = _mask(rng, kind, h, w).astype(np.uint8)
        want, _ = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        got = drawing.find_contours_external(m)
        assert isinstance(got, tuple) and len(got) == len(want), (m, len(got), len(want))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), m


@pytest.mark.parametrize("mask", ["empty", "full", "pixel", "corner_pixels", "ellipse_256"])
def test_find_contours_edge_masks(mask):
    m = np.zeros((256, 256) if mask == "ellipse_256" else (7, 9), np.uint8)
    if mask == "full":
        m[:] = 1
    elif mask == "pixel":
        m[3, 4] = 7  # any nonzero value is foreground
    elif mask == "corner_pixels":
        m[0, 0] = m[0, -1] = m[-1, 0] = m[-1, -1] = 1
    elif mask == "ellipse_256":
        yy, xx = np.mgrid[:256, :256]
        m = (((yy - 120) ** 2 / 3000 + (xx - 130) ** 2 / 5000) < 1).astype(np.uint8)
    want, _ = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    got = drawing.find_contours_external(m)
    assert len(got) == len(want)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(got, want))


@pytest.mark.parametrize("thickness", [1, 2])
@pytest.mark.parametrize("kind", ["noise", "boxes", "rings", "thin", "points"])
def test_draw_contours_matches_cv2(kind, thickness):
    rng = np.random.default_rng([thickness, len(kind)])
    for _ in range(CASES // 2):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        if kind == "points":  # any point lists: one and two points, off the image
            contours = tuple(rng.integers(-30, 70, (int(rng.integers(1, 6)), 1, 2)).astype(np.int32)
                             for _ in range(3))
        else:
            contours, _ = cv2.findContours(_mask(rng, kind, h, w).astype(np.uint8),
                                           cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        want = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        got = want.copy()
        cv2.drawContours(want, contours, -1, (0, 255, 0), thickness)
        drawing.draw_contours(got, contours, (0, 255, 0), thickness)
        assert np.array_equal(got, want), (kind, thickness, [c.tolist() for c in contours])
