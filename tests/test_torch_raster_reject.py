"""The raster kernels' per-warp face rejection, through its plain mirror
(scflow_tpu_torch/ops/cuda/rasterize.py::rect_keeps, the same formula and
constants as csrc/raster_common.cuh): it must be conservative, that is keep
every face that the float32 per-pixel test lets cover any pixel of the
rectangle, or the kernels would drop a winner.  The kernels themselves are
held bit for bit to their plain versions on the card
(tests/test_torch_kernels.py, and chip_smoke.py, which also checks that the
card counts the same surviving (warp, face) pairs as the mirror).

Imports no JAX."""

import math

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from scflow_tpu_torch.ops import raster_pack as pk
from scflow_tpu_torch.ops.cuda import rasterize as k2

from torch_port_helpers import adversarial_raster_corners, keep_torch_rng  # noqa: F401

SETTINGS = settings(max_examples=300, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.too_slow])


def _covers(coef, x0, x1, y0, y1):
    """Does the plain per-pixel test (float32, the kernels' order of
    operations) let the face with rows coef (6,) cover a pixel centre of
    the rectangle [x0, x1] x [y0, y1]?"""
    ys, xs = torch.meshgrid(torch.arange(y0, y1 + 1), torch.arange(x0, x1 + 1), indexing="ij")
    px, py = xs.reshape(-1).float(), ys.reshape(-1).float()
    w0 = coef[0] * px + coef[1] * py + coef[2]
    w1 = coef[3] * px + coef[4] * py + coef[5]
    w2 = 1.0 - w0 - w1
    return bool((torch.minimum(torch.minimum(w0, w1), w2) >= 0).any())


def _keeps(coef, x0, x1, y0, y1):
    r = [torch.tensor(float(v), dtype=torch.float64) for v in (x0, x1, y0, y1)]
    return bool(k2.rect_keeps(coef, *r))


def _face_coef(tri):
    """Rows 0-5 (float32) of one face with corners tri (3, 2), as the packs
    compute them, and its valid flag."""
    tri_xy = torch.tensor(np.asarray(tri, np.float32)).reshape(1, 1, 3, 2)
    planes = pk._face_plane_coeffs(tri_xy, torch.full((1, 1, 3), 400.0),
                                   torch.ones((1, 1), dtype=torch.bool))
    return torch.stack([p[0, 0] for p in planes[:6]]), bool(planes[9][0, 0] > 0.5)


def _check_conservative(tri, rect):
    coef, _ = _face_coef(tri)
    if _covers(coef, *rect):
        assert _keeps(coef, *rect), (tri, rect, coef)


# a warp's rectangle: at most 16 x 8 pixel centres, anywhere from -1e4 to 1e4
rects = st.tuples(st.integers(-10_000, 10_000), st.integers(0, 15), st.integers(-10_000, 10_000),
                  st.integers(0, 7)).map(lambda r: (r[0], r[0] + r[1], r[2], r[2] + r[3]))


@st.composite
def near_faces(draw, rect, span):
    """Corners at integer or half-integer offsets from the rectangle's
    corner, so that edges run through pixel centres (w exactly 0)."""
    x0, _, y0, _ = rect
    return [(x0 + draw(st.integers(-span, span)) / 2, y0 + draw(st.integers(-span, span)) / 2)
            for _ in range(3)]


@SETTINGS
@given(st.data(), rects, st.sampled_from([4, 40, 400]))
def test_kept_when_an_edge_runs_through_pixel_centres(data, rect, span):
    _check_conservative(data.draw(near_faces(rect, span)), rect)


def test_kept_when_an_edge_runs_along_a_pixel_column():
    """w0 is exactly 0 on the column x = 3 and negative right of it: only
    that column of the rectangle is covered."""
    coef, _ = _face_coef([(3.0, -4.0), (3.0, 12.0), (-9.0, 4.0)])
    assert _covers(coef, 3, 18, 0, 7) and _keeps(coef, 3, 18, 0, 7)
    assert not _covers(coef, 4, 19, 0, 7) and not _keeps(coef, 4, 19, 0, 7)


@SETTINGS
@given(rects, st.floats(0, 2 * math.pi), st.floats(1.0, 4e4),
       st.sampled_from([0.0, 1e-6, 1e-4, 1e-3, 1e-2, 0.3]), st.floats(-30, 30),
       st.floats(-30, 30))
def test_kept_for_slivers_and_edge_on_faces(rect, angle, length, eps, ox, oy):
    """Long, thin (or zero-area) faces through or beside the rectangle:
    their coefficients are large and cancel."""
    x0, x1, y0, y1 = rect
    c = np.array([(x0 + x1) / 2 + ox, (y0 + y1) / 2 + oy])
    d = length * np.array([math.cos(angle), math.sin(angle)])
    perp = np.array([-d[1], d[0]]) / length
    _check_conservative([c - d / 2, c + d / 2, c + eps * perp * length], rect)


@SETTINGS
@given(rects, st.lists(st.tuples(st.floats(-1.2e4, 1.2e4), st.floats(-1.2e4, 1.2e4)),
                       min_size=3, max_size=3))
def test_kept_for_faces_anywhere_near_1e4(rect, tri):
    _check_conservative(tri, rect)


@SETTINGS
@given(rects, st.integers(0, 15), st.integers(0, 7), st.floats(0, 2 * math.pi),
       st.floats(1.0, 7.0), st.floats(-9.0, -4.0), st.floats(-1.0, 1.0), st.floats(-1.0, 1.0))
def test_kept_when_w2_cancels(rect, dx, dy, angle, log_k, log_rho, sx, sy):
    """w0 and w1 steep and opposite, so that w2 = 1 - w0 - w1 is their
    small difference: its float32 rounding error scales with |w0| + |w1|,
    and its margin must too.  w2 is within rho (|w0| + |w1|) of 0 at one
    pixel of the rectangle."""
    x0, x1, y0, y1 = rect
    px, py = min(x0 + dx, x1), min(y0 + dy, y1)
    k = 10.0 ** log_k
    u, v = k * math.cos(angle), k * math.sin(angle)
    big = abs(u) * abs(px) + abs(v) * abs(py)
    delta = (10.0 ** log_rho) * (big + 1.0) * (1 if sx > 0 else -1)
    coef = np.array([u, v, -(u * px + v * py) + 0.5,
                     -u + 1e-3 * sx, -v + 1e-3 * sy, (u * px + v * py) + 0.5 + delta])
    c = torch.tensor(coef, dtype=torch.float32)
    if _covers(c, *rect):
        assert _keeps(c, *rect), (coef, rect)


finite32 = st.floats(width=32, allow_nan=False, allow_infinity=False)
coef32 = st.one_of(finite32, st.floats(-4.0, 4.0, width=32),
                   st.sampled_from([0.0, -0.0, 1e-38, -1e-38, 1e-45, 3e38, -3e38]))


@SETTINGS
@given(rects, st.lists(coef32, min_size=6, max_size=6))
def test_kept_for_any_float32_coefficients(rect, coef):
    """Coefficients that no triangle gives: subnormal, huge, mixed signs."""
    c = torch.tensor(coef, dtype=torch.float32)
    if _covers(c, *rect):
        assert _keeps(c, *rect), (coef, rect)


@SETTINGS
@given(rects, st.lists(coef32, min_size=6, max_size=6), st.integers(0, 5),
       st.sampled_from([math.nan, math.inf, -math.inf]))
def test_nan_or_inf_coefficient_never_rejects_on_its_function(rect, coef, which, bad):
    """A NaN or infinite coefficient leaves its function, and w2, unable to
    reject: with the other of w0, w1 at 1 everywhere the face is kept, and
    the per-pixel test rules on it (a NaN never covers)."""
    coef[which] = bad
    if which < 3:
        coef[3:6] = [0.0, 0.0, 1.0]
    else:
        coef[0:3] = [0.0, 0.0, 1.0]
    assert _keeps(torch.tensor(coef, dtype=torch.float32), *rect)


@SETTINGS
@given(rects)
def test_invalid_faces_are_always_rejected(rect):
    """The packs give an invalid or culled face w0 == -1 (a0 = b0 = 0,
    c0 = -1) and zeros elsewhere."""
    c = torch.tensor([0.0, 0.0, -1.0, 0.0, 0.0, 0.0])
    assert not _keeps(c, *rect)


def test_far_faces_are_rejected():
    """The rejection does reject: a face well outside the rectangle on
    either side, and a face whose w2 alone excludes it."""
    rect = (16, 31, 8, 15)
    for tri in ([(40, 8), (60, 8), (50, 15)], [(0, 0), (10, 0), (5, 6)],
                [(16, 40), (31, 40), (24, 60)]):
        coef, valid = _face_coef(tri)
        assert valid and not _covers(coef, *rect) and not _keeps(coef, *rect), tri
    coef, _ = _face_coef([(10, 8), (40, 8), (25, 20)])
    assert _covers(coef, *rect) and _keeps(coef, *rect)


@pytest.mark.parametrize("img,th,tw", [(128, 8, 128), (192, 8, 192), (100, 100, 100)])
def test_warp_rects_follow_the_kernels_layout(img, th, tw):
    """Each tile splits into 8 x 128 pieces, each piece into 8 warps of 8 x
    16 pixels; pixels past the tile are left out, and a warp with none has
    x0 > x1."""
    x0, x1, y0, y1 = k2.warp_rects(img, img, th, tw)
    pieces = -(-th // 8) * -(-tw // 128)
    assert x0.shape == ((img // th) * (img // tw), pieces * 8)
    has = x0 <= x1
    # every pixel lies in exactly one rectangle, and rectangles do not overlap
    area = ((x1 - x0 + 1) * (y1 - y0 + 1))[has]
    assert int(area.sum()) == img * img
    assert int(((x1 - x0)[has]).max()) <= 15 and int(((y1 - y0)[has]).max()) <= 7
    bx = -(-tw // 128)
    for t, s in [(0, 0), (0, pieces * 8 - 1), (x0.shape[0] - 1, 3)]:
        ty, tx = divmod(t, img // tw)
        by, bxi = divmod(s // 8, bx)
        ex0 = tx * tw + bxi * 128 + (s % 8) * 16
        ey0 = ty * th + by * 8
        ex1 = min(ex0 + 15, tx * tw + tw - 1)
        ey1 = min(ey0 + 7, ty * th + th - 1)
        if ex0 > tx * tw + tw - 1 or ey0 > ty * th + th - 1:
            assert not has[t, s]
        else:
            assert (int(x0[t, s]), int(x1[t, s]), int(y0[t, s]), int(y1[t, s])) == (
                ex0, ex1, ey0, ey1)


@pytest.mark.parametrize("kind,img,th,tw,fc", [
    ("shaded", 128, 8, 128, 128), ("shaded", 256, 8, 128, 128),
    ("depth", 192, 8, 192, 128), ("depth", 100, 100, 100, 128), ("depth", 128, 8, 128, 512)])
def test_rejection_is_conservative_on_the_adversarial_scene(kind, img, th, tw, fc):
    """On the adversarial scene of the card tests (slivers, edge-on faces,
    faces on tile and warp borders, huge faces, a face over a whole tile),
    for every warp rectangle and every face of the chunks active for its
    tile, a face the plain per-pixel test lets cover one of the warp's
    pixels is kept; and the rejection drops most pairs."""
    tri_xy, tri_z, fv, corner = adversarial_raster_corners(img)
    if kind == "shaded":
        rows, active, _ = pk.pack_shaded_and_bin(tri_xy, tri_z, fv, corner, img, img, th, tw, fc,
                                                 cull_backfaces=False)
    else:
        rows, active, _ = pk.pack_faces_and_bin(tri_xy, tri_z, fv, img, img, th, tw, fc,
                                                cull_backfaces=True)
    x0, x1, y0, y1 = k2.warp_rects(img, img, th, tw)
    act = active.reshape(rows.shape[0], -1, active.shape[-1]).bool()
    covered = kept = 0
    for i in range(rows.shape[0]):
        for t in range(x0.shape[0]):
            faces = torch.cat([torch.arange(c * fc, (c + 1) * fc)
                               for c in act[i, t].nonzero().flatten().tolist()])
            for s in range(x0.shape[1]):
                if x0[t, s] > x1[t, s]:
                    continue
                rect = [int(v[t, s]) for v in (x0, x1, y0, y1)]
                ys, xs = torch.meshgrid(torch.arange(rect[2], rect[3] + 1),
                                        torch.arange(rect[0], rect[1] + 1), indexing="ij")
                px, py = xs.reshape(1, -1).float(), ys.reshape(1, -1).float()
                c = rows[i, :11, faces, None]
                w0 = c[0] * px + c[1] * py + c[2]
                w1 = c[3] * px + c[4] * py + c[5]
                cover = (torch.minimum(torch.minimum(w0, w1), 1.0 - w0 - w1) >= 0).any(1)
                keep = k2.rect_keeps(rows[i, :6, faces],
                                     *(torch.tensor(float(v), dtype=torch.float64) for v in rect))
                assert not (cover & ~keep).any(), (i, t, s, faces[cover & ~keep])
                covered += int(cover.sum())
                kept += int(keep.sum())
    assert covered > 0 and kept < 0.5 * act.sum().item() * fc * x0.shape[1]


def test_count_survivors_counts_each_warp_and_face():
    """count_survivors against a direct count on a small scene."""
    tri_xy, tri_z, fv, corner = adversarial_raster_corners(128)
    rows, active, _ = pk.pack_faces_and_bin(tri_xy, tri_z, fv, 128, 128, 8, 128, 128,
                                            cull_backfaces=True)
    kept, tested = k2.count_survivors(rows, active, 128, 128, 8, 128, 128, True)
    x0, x1, y0, y1 = (v.double() for v in k2.warp_rects(128, 128, 8, 128))
    want_kept = want_tested = 0
    for i in range(rows.shape[0]):
        for t, c in active.reshape(rows.shape[0], -1, active.shape[-1])[i].nonzero().tolist():
            faces = slice(c * 128, (c + 1) * 128)
            for s in range(x0.shape[1]):
                keep = k2.rect_keeps(rows[i, :6, faces], x0[t, s], x1[t, s], y0[t, s], y1[t, s])
                want_kept += int((keep & (rows[i, 10, faces] > 0.5)).sum())
                want_tested += 128
    assert (kept, tested) == (want_kept, want_tested)
    assert 0 < kept < tested
