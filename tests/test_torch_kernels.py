"""Kernels K1, K7, K8 (the corr lookup's variants), K1b (its backward) and
K2-K6 (the raster kernels) against their plain PyTorch versions, and the
CPU/CUDA dispatch of their wrappers.

Tests marked `cuda` need a card and skip without one.  This file imports no
JAX, so on a machine with only PyTorch and a card it runs as
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from scflow_tpu_torch.ops.cuda import corr_lookup as k1
from scflow_tpu_torch.ops import raster_pack as pk
from scflow_tpu_torch.ops.cuda import rasterize as k2
from scflow_tpu_torch.render.meshbank import make_synthetic_bank
from scflow_tpu_torch.render.rasterizer import gather_corner_attrs, gather_tri, project_to_screen

from torch_port_helpers import adversarial_raster_corners, keep_torch_rng  # noqa: F401


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _lookup_case(case: str, seed: int = 0):
    """(levels, coords) with 300 rows: random, border-straddling or exactly
    integer window centres."""
    g = torch.Generator().manual_seed(seed)
    n, h = 3, 10
    sizes = (10, 5, 3, 2)
    levels = [torch.randn((n * h * h, s * s), generator=g) for s in sizes]
    if case == "random":
        flow = 3.0 * torch.randn((n, h, h, 2), generator=g)
    elif case == "border":
        flow = 28.0 * torch.rand((n, h, h, 2), generator=g) - 14.0
    else:
        flow = torch.randint(-6, 7, (n, h, h, 2), generator=g).float()
    gy, gx = torch.meshgrid(torch.arange(h), torch.arange(h), indexing="ij")
    coords = (torch.stack([gx, gy], -1)[None] + flow).reshape(-1, 2).contiguous()
    return levels, coords


def _raster_corners(device, n=2, img=128):
    """Projected corners (N, F, 3, 2), corner depths, face_valid and corner
    [normal, colour] attributes of two posed spheres on an img x img crop."""
    bank = make_synthetic_bank(3, kind="sphere", size=160.0, subdivisions=2)
    g = torch.Generator().manual_seed(3)
    labels = torch.tensor([0, 2])[:n]
    q = torch.nn.functional.normalize(torch.randn((n, 4), generator=g), dim=-1)
    w, x, y, z = q.unbind(-1)
    R = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                     2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                     2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                    -1).reshape(n, 3, 3)
    t = torch.tensor([[5.0, -4.0, 400.0], [-6.0, 3.0, 420.0]])[:n]
    K = torch.tensor([[150.0, 0, img / 2], [0, 150.0, img / 2], [0, 0, 1]]).expand(n, 3, 3)
    verts = torch.from_numpy(bank.verts)[labels]
    faces = torch.from_numpy(bank.faces)[labels]
    verts_cam = torch.einsum("nij,nvj->nvi", R, verts) + t[:, None]
    normals_cam = torch.einsum("nij,nvj->nvi", R, torch.from_numpy(bank.normals)[labels])
    xy, zv = project_to_screen(verts_cam, K)
    tri_xy, tri_z = gather_tri(xy, zv, faces)
    corner = gather_corner_attrs(
        torch.cat([normals_cam, torch.from_numpy(bank.colors)[labels]], -1), faces)
    fv = torch.from_numpy(bank.face_valid)[labels]
    return tuple(a.to(device) for a in (tri_xy, tri_z, fv, corner))


def _raster_scene(device, n=2, img=128, cull=True, fc=128):
    """Shaded packs at 8x128 tiles: rows (N, 32, F'), active, img."""
    tri_xy, tri_z, fv, corner = _raster_corners(device, n, img)
    rows, active, _ = pk.pack_shaded_and_bin(tri_xy, tri_z, fv, corner, img, img, 8, 128, fc,
                                             cull_backfaces=cull)
    return rows, active, img


def _packed_scene(device, img, fc):
    """Depth-only packs at rasterize()'s tiles for an img x img crop."""
    tri_xy, tri_z, fv, _ = _raster_corners(device, img=img)
    th, tw = (8 if img % 8 == 0 else img), (128 if img % 128 == 0 else img)
    rows, active, _ = pk.pack_faces_and_bin(tri_xy, tri_z, fv, img, img, th, tw, fc,
                                            cull_backfaces=True)
    return rows, active, dict(h=img, w=img, th=th, tw=tw, fc=fc,
                              id_bits=pk.id_bits_for(rows.shape[-1]))


def _v4_scene(device, dup):
    tri_xy, tri_z, fv, corner = _raster_corners(device)
    packs = pk.pack_shaded_exact(tri_xy, tri_z, fv, corner, 128, 128, 8, 128, 128, dup=dup,
                                 cull_backfaces=True)
    return packs[:5], dict(h=128, w=128, th=8, tw=128, fc=128,
                           id_bits=pk.id_bits_for(packs[0].shape[-1]))


def _all_launches():
    return (k1.KERNEL.launches, k1.SHIFT_KERNEL.launches, k1.BDIAG_KERNEL.launches,
            k1.BWD_KERNEL.launches, k2.V3_KERNEL.launches, k2.V4_KERNEL.launches,
            k2.PACKED_KERNEL.launches, k2.V12_KERNELS[1].launches, k2.V12_KERNELS[2].launches)


def test_cpu_tensors_run_the_plain_versions_without_launching():
    levels, coords = _lookup_case("random")
    before = _all_launches()
    torch.testing.assert_close(k1.corr_lookup_flat(levels, coords),
                               k1.corr_lookup_flat_plain(levels, coords), rtol=0, atol=0)
    assert torch.equal(k1.corr_lookup_flat(levels, coords, variant="shift"),
                       k1.corr_lookup_flat_shift_plain(levels, coords))
    assert torch.equal(k1.corr_lookup_flat(levels, coords, variant="bdiag"),
                       k1.corr_lookup_flat_plain(levels, coords))
    g = torch.randn((coords.shape[0], 4 * 81), generator=torch.Generator().manual_seed(1))
    got = k1.corr_lookup_flat_bwd(levels, coords, g)
    want = k1.corr_lookup_flat_bwd_plain(levels, coords, g)
    assert all(torch.equal(a, b) for a, b in zip(got[0] + [got[1]], want[0] + [want[1]]))
    cpu = torch.device("cpu")
    rows, active, img = _raster_scene(cpu)
    bits = pk.id_bits_for(rows.shape[-1])
    torch.testing.assert_close(k2.rasterize_shaded_v3(rows, active, img, img, bits),
                               k2.rasterize_shaded_v3_plain(rows, active, img, img, bits),
                               rtol=0, atol=0)
    for version in (1, 2):
        assert torch.equal(
            k2.rasterize_shaded(rows, active, img, img, 8, 128, 128, bits, version=version),
            k2.rasterize_shaded_plain(rows, active, img, img, 8, 128, 128, bits))
    rows, active, kw = _packed_scene(cpu, 100, 128)
    assert torch.equal(k2.rasterize_packed(rows, active, **kw),
                       k2.rasterize_packed_plain(rows, active, **kw))
    packs, kw = _v4_scene(cpu, 8)
    assert torch.equal(k2.rasterize_shaded_v4(*packs, **kw),
                       k2.rasterize_shaded_v4_plain(*packs, **kw))
    assert _all_launches() == before


def test_wrappers_reject_other_devices():
    levels = [torch.empty((4, s * s), device="meta") for s in (4, 2, 1)]
    for variant in k1.VARIANTS:
        with pytest.raises(ValueError, match="unsupported device"):
            k1.corr_lookup_flat(levels, torch.empty((4, 2), device="meta"), variant=variant)
    with pytest.raises(ValueError, match="unsupported device"):
        k1.corr_lookup_flat_bwd(levels, torch.empty((4, 2), device="meta"),
                                torch.empty((4, 3 * 81), device="meta"))
    with pytest.raises(ValueError, match="variant"):
        k1.corr_lookup_flat(levels, torch.empty((4, 2), device="meta"), variant="tri")
    rows = torch.empty((1, 32, 128), device="meta")
    act = torch.empty((1, 1, 1, 1), dtype=torch.int32, device="meta")
    tiles = torch.empty((1, 1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k2.rasterize_shaded_v3(rows, act, 8, 128, 7)
    for version in (1, 2):
        with pytest.raises(ValueError, match="unsupported device"):
            k2.rasterize_shaded(rows, act, 8, 128, 8, 128, 128, 7, version=version)
    with pytest.raises(ValueError, match="unsupported device"):
        k2.rasterize_packed(rows[:, :16], act, 8, 128, 8, 128, 128, 7)
    with pytest.raises(ValueError, match="unsupported device"):
        k2.rasterize_shaded_v4(rows, tiles, tiles, tiles, act, 8, 128, 8, 128, 128, 7)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "border", "integer"])
def test_corr_lookup_kernel_matches_plain(case, cuda):
    """atol 1e-4: the kernel blends 4 corners, the plain version sums tent
    weights over whole rows; the two round differently."""
    levels, coords = _lookup_case(case)
    levels = [m.to(cuda) for m in levels]
    coords = coords.to(cuda)
    before = k1.KERNEL.launches
    got = k1.corr_lookup_flat(levels, coords)
    torch.cuda.synchronize()
    assert k1.KERNEL.launches == before + 1
    want = k1.corr_lookup_flat_plain(levels, coords)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "border", "integer"])
def test_shift_kernel_matches_plain_bit_for_bit(case, cuda):
    """K7 and its plain version make the same two products and one sum per
    blend, unfused (-fmad=false): the outputs are identical."""
    levels, coords = _lookup_case(case)
    levels = [m.to(cuda) for m in levels]
    coords = coords.to(cuda)
    before = k1.SHIFT_KERNEL.launches
    got = k1.corr_lookup_flat(levels, coords, variant="shift")
    torch.cuda.synchronize()
    assert k1.SHIFT_KERNEL.launches == before + 1
    assert torch.equal(got, k1.corr_lookup_flat_shift_plain(levels, coords))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "border", "integer"])
def test_bdiag_kernel_matches_tent_plain(case, cuda):
    """K8 against the tent plain version at K1's atol 1e-4."""
    levels, coords = _lookup_case(case)
    levels = [m.to(cuda) for m in levels]
    coords = coords.to(cuda)
    before = k1.BDIAG_KERNEL.launches
    got = k1.corr_lookup_flat(levels, coords, variant="bdiag")
    torch.cuda.synchronize()
    assert k1.BDIAG_KERNEL.launches == before + 1
    torch.testing.assert_close(got, k1.corr_lookup_flat_plain(levels, coords), rtol=0,
                               atol=1e-4)


# every radius the launch switch of K7/K8 instantiates (0-12, checked against
# the library below) at every level count
WINDOW_RADII = range(13)
WINDOW_SHAPES = [(r, n) for r in WINDOW_RADII for n in range(1, 5)]
WINDOW_KERNELS = {"tent": k1.KERNEL, "shift": k1.SHIFT_KERNEL, "bdiag": k1.BDIAG_KERNEL}
# K1 and K1b build radius 0-15; these radii at every level count cover every
# (radius, levels) pair the first K1 launched (L * (2r+1)^2 <= 1024: radius
# <= 15, 10, 8, 7 at 1-4 levels) at its edges, and pairs past them
TENT_RADII = (0, 1, 4, 7, 8, 10, 11, 13, 14, 15)
TENT_SHAPES = [(r, n) for r in TENT_RADII for n in range(1, 5)]


def _launched_before(radius, levels):
    """A pair the first K1 (one thread per output column) launched."""
    return levels * (2 * radius + 1) ** 2 <= 1024


def _window_case(rows, sizes, radius, seed=0):
    """(levels, coords): a quarter each of random, border-straddling and
    exactly integer centres, then NaN and far-outside ones, on levels of
    the given sizes."""
    g = torch.Generator().manual_seed(seed)
    levels = [torch.randn((rows, s * s), generator=g) for s in sizes]
    span = float(sizes[0])
    coords = span * torch.rand((rows, 2), generator=g)
    q = rows // 4
    coords[q:2 * q] = (span + 4 * radius + 4) * torch.rand((q, 2), generator=g) - 2 * radius - 2
    coords[2 * q:3 * q] = torch.randint(-radius - 2, int(span) + radius + 2, (q, 2),
                                        generator=g).float()
    tail = coords[3 * q:]
    tail[0::4] = float("nan")
    tail[1::4, 0] = float("nan")
    tail[2::4] = torch.tensor([1e7, -3e6])
    tail[3::4] = torch.tensor([-1e9, 2.5])
    return levels, coords.contiguous()


def _plain_must_not_run(*args, **kwargs):
    raise AssertionError("the plain version ran for a CUDA tensor")


def _check_window_kernel(variant, levels, coords, radius, cuda):
    """K7 bit-identical to its plain version (NaN where it is NaN), K1 and
    K8 within K1's atol 1e-4 of the tent plain version; one launch a
    call."""
    levels = [m.to(cuda) for m in levels]
    coords = coords.to(cuda)
    kernel = WINDOW_KERNELS[variant]
    before = kernel.launches
    got = k1.corr_lookup_flat(levels, coords, radius, variant=variant)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = k1.PLAIN[variant](levels, coords, radius)
    if variant == "shift":
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
        finite = ~torch.isnan(want).any(dim=1)
        assert torch.equal(got[finite], want[finite])
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["shift", "bdiag"])
@pytest.mark.parametrize("radius,levels", WINDOW_SHAPES)
def test_window_kernels_every_radius_and_level_count(variant, radius, levels, cuda):
    """Every radius the launch switch instantiates at every level count, on
    75 rows (18 groups and a ragged tail of 3)."""
    levels_, coords = _window_case(75, (10, 5, 3, 2)[:levels], radius, seed=radius)
    _check_window_kernel(variant, levels_, coords, radius, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["shift", "bdiag"])
def test_window_layout_matches_the_launch_switch(variant, cuda):
    """The library's layout covers exactly the radii the tests drive, and
    refuses the next radius and a fifth level."""
    for radius, levels in WINDOW_SHAPES:
        layout = k1.window_layout(variant, levels, radius)
        assert layout["max_radius"] == max(WINDOW_RADII)
        assert layout["threads"] % 32 == 0 and 0 < layout["smem_bytes"] <= 227 * 1024
    for radius, levels in [(max(WINDOW_RADII) + 1, 1), (-1, 2), (4, 5), (4, 0)]:
        with pytest.raises(RuntimeError, match="CUDA error"):
            k1.window_layout(variant, levels, radius)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["tent", "shift", "bdiag"])
@pytest.mark.parametrize("rows", ["one", "group-1", "group+1"])
def test_window_kernels_ragged_row_counts(variant, rows, cuda):
    """One row, one row short of a group, one row past a group (the group
    size read from the built library)."""
    group = k1.window_layout(variant, 4, 4)["rows_per_group"]
    rows = {"one": 1, "group-1": group - 1, "group+1": group + 1}[rows]
    g = torch.Generator().manual_seed(rows)
    levels = [torch.randn((rows, s * s), generator=g) for s in (10, 5, 3, 2)]
    coords = (12.0 * torch.rand((rows, 2), generator=g) - 1.0).contiguous()
    _check_window_kernel(variant, levels, coords, 4, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["tent", "shift", "bdiag"])
def test_window_kernels_at_the_flagship_level_sizes(variant, cuda):
    """Levels 32^2..4^2, radius 4, 2 images of 32^2 rows, with NaN,
    far-outside and integer centres."""
    levels, coords = _window_case(2 * 32 * 32, (32, 16, 8, 4), 4, seed=5)
    _check_window_kernel(variant, levels, coords, 4, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["tent", "shift", "bdiag"])
@pytest.mark.parametrize("radius,levels", [("past", 1), ("past", 4), (-1, 2)])
def test_window_kernels_raise_outside_the_instantiated_set(variant, radius, levels, cuda,
                                                          monkeypatch):
    """A radius outside the launch switch ('past': one more than the
    library's largest) raises from the launch; the plain version never runs
    for a CUDA tensor."""
    if radius == "past":
        radius = k1.window_layout(variant, levels, 0)["max_radius"] + 1
    monkeypatch.setitem(k1.PLAIN, variant, _plain_must_not_run)
    monkeypatch.setattr(k1, "corr_lookup_flat_plain", _plain_must_not_run)
    monkeypatch.setattr(k1, "corr_lookup_flat_shift_plain", _plain_must_not_run)
    lv, coords = _window_case(16, (6, 3, 2, 1)[:levels], 1)
    lv = [m.to(cuda) for m in lv]
    kernel = WINDOW_KERNELS[variant]
    before = kernel.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        k1.corr_lookup_flat(lv, coords.to(cuda), radius, variant=variant)
    assert kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("radius,levels", TENT_SHAPES)
def test_tent_kernel_every_window(radius, levels, cuda, monkeypatch):
    """K1 at every pair of TENT_SHAPES on 75 rows (18 groups and a ragged
    tail of 3, NaN, far-outside and integer centres): each pair the first
    K1 launched launches; a pair whose two ring stages exceed a block's
    shared memory (the library's layout refuses it) raises, without the
    plain version."""
    levels_, coords = _window_case(75, (10, 5, 3, 2)[:levels], radius, seed=radius)
    try:
        k1.window_layout("tent", levels, radius)
    except RuntimeError:
        assert not _launched_before(radius, levels)
        monkeypatch.setitem(k1.PLAIN, "tent", _plain_must_not_run)
        before = k1.KERNEL.launches
        with pytest.raises(RuntimeError, match="CUDA error"):
            k1.corr_lookup_flat([m.to(cuda) for m in levels_], coords.to(cuda), radius)
        assert k1.KERNEL.launches == before
        return
    _check_window_kernel("tent", levels_, coords, radius, cuda)


@pytest.mark.cuda
def test_tent_layout_takes_every_pair_the_first_k1_took(cuda):
    """K1's library builds radius 0-15 and accepts every pair L*(2r+1)^2 <=
    1024; it refuses radius 15 at four levels (about 258 KB of shared
    memory) and radius 16."""
    for radius in range(16):
        for levels in range(1, 5):
            if _launched_before(radius, levels):
                layout = k1.window_layout("tent", levels, radius)
                assert layout["max_radius"] == 15
                assert layout["smem_bytes"] <= 227 * 1024
    for radius, levels in [(15, 4), (16, 1), (-1, 1), (4, 5)]:
        with pytest.raises(RuntimeError, match="CUDA error"):
            k1.window_layout("tent", levels, radius)


def _bwd_grad_out(rows, cols, seed, offset=False):
    """The output gradient; with offset, a contiguous view 4 bytes past a
    16-byte boundary (K1b then stages it with 4-byte copies)."""
    g = torch.randn((rows * cols + 1,), generator=torch.Generator().manual_seed(seed))
    return (g[1:] if offset else g[:-1]).view(rows, cols)


def _check_bwd_kernel(levels, coords, g, radius, want_coords, cuda):
    """K1b against its plain version at atol 1e-4 (level grads, NaN where
    they are NaN; the coords grad of every row with a finite centre), one
    launch a call, the same bits from a second launch, and a NaN centre's
    rows NaN in every level and in the coords grad."""
    levels = [m.to(cuda) for m in levels]
    coords, g = coords.to(cuda), g.to(cuda)
    before = k1.BWD_KERNEL.launches
    grads, gc = k1.corr_lookup_flat_bwd(levels, coords, g, radius, want_coords)
    torch.cuda.synchronize()
    assert k1.BWD_KERNEL.launches == before + 1
    again, again_c = k1.corr_lookup_flat_bwd(levels, coords, g, radius, want_coords)
    want, want_c = k1.corr_lookup_flat_bwd_plain(levels, coords, g, radius, want_coords)
    nan_rows = torch.isnan(coords).any(dim=1)
    for a, b, c in zip(grads, want, again):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4, equal_nan=True)
        assert torch.equal(a.nan_to_num(7.0), c.nan_to_num(7.0))
        assert torch.isnan(a[nan_rows]).all() and not torch.isnan(a[~nan_rows]).any()
    if want_coords:  # a NaN centre's flow gradient is NaN (the plain version
        # gives 0 on the axis whose weights' derivative a NaN compare zeroes)
        torch.testing.assert_close(gc[~nan_rows], want_c[~nan_rows], rtol=0, atol=1e-4)
        assert torch.isnan(gc[nan_rows]).all()
        assert torch.equal(gc.nan_to_num(7.0), again_c.nan_to_num(7.0))
    else:
        assert gc is None and again_c is None


@pytest.mark.cuda
@pytest.mark.parametrize("want_coords", [True, False])
@pytest.mark.parametrize("radius,levels", TENT_SHAPES)
def test_bwd_kernel_every_window(radius, levels, want_coords, cuda, monkeypatch):
    """K1b at K1's windows on 75 rows (random, border, integer, NaN and
    far-outside centres; a 10^2 level of 16-byte stores, 5^2 and 3^2 of
    4-byte ones, a 2^2 one whose 16-byte chunks span two map rows); every
    window K1 takes launches, a window the library's layout refuses raises
    without the plain version."""
    levels_, coords = _window_case(75, (10, 5, 3, 2)[:levels], radius, seed=radius)
    g = _bwd_grad_out(75, levels * (2 * radius + 1) ** 2, radius, offset=radius % 2 == 1)
    try:
        k1.bwd_layout(levels, radius, want_coords)
    except RuntimeError:
        assert not _launched_before(radius, levels)
        monkeypatch.setattr(k1, "corr_lookup_flat_bwd_plain", _plain_must_not_run)
        before = k1.BWD_KERNEL.launches
        with pytest.raises(RuntimeError, match="CUDA error"):
            k1.corr_lookup_flat_bwd([m.to(cuda) for m in levels_], coords.to(cuda), g.to(cuda),
                                    radius, want_coords)
        assert k1.BWD_KERNEL.launches == before
        return
    _check_bwd_kernel(levels_, coords, g, radius, want_coords, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("want_coords", [True, False])
@pytest.mark.parametrize("rows", ["one", "group-1", "group+1"])
def test_bwd_kernel_ragged_row_counts(rows, want_coords, cuda):
    """One row, one short of a group, one past a group (the group size read
    from the built library)."""
    group = k1.bwd_layout(4, 4, want_coords)["rows_per_group"]
    rows = {"one": 1, "group-1": group - 1, "group+1": group + 1}[rows]
    gen = torch.Generator().manual_seed(rows)
    levels = [torch.randn((rows, s * s), generator=gen) for s in (10, 5, 3, 2)]
    coords = (12.0 * torch.rand((rows, 2), generator=gen) - 1.0).contiguous()
    _check_bwd_kernel(levels, coords, _bwd_grad_out(rows, 4 * 81, rows), 4, want_coords, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("want_coords", [True, False])
def test_bwd_kernel_at_the_flagship_level_sizes(want_coords, cuda):
    """Levels 32^2..4^2, radius 4, 8 images of 32^2 rows (more groups than
    the resident blocks take at once, so blocks walk the ring), with NaN,
    far-outside and integer centres."""
    levels, coords = _window_case(8 * 32 * 32, (32, 16, 8, 4), 4, seed=6)
    g = _bwd_grad_out(coords.shape[0], 4 * 81, 6)
    _check_bwd_kernel(levels, coords, g, 4, want_coords, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("radius,levels", [(16, 1), (-1, 2), (4, 5)])
def test_bwd_kernel_raises_outside_the_instantiated_set(radius, levels, cuda, monkeypatch):
    """A radius K1b does not build, or a fifth level, raises from the
    launch, without the plain version."""
    monkeypatch.setattr(k1, "corr_lookup_flat_bwd_plain", _plain_must_not_run)
    lv = [torch.randn((16, s * s), device=cuda) for s in (6, 3, 2, 1, 1)[:levels]]
    coords = torch.rand((16, 2), device=cuda)
    g = torch.randn((16, levels * (2 * max(radius, 0) + 1) ** 2), device=cuda)
    before = k1.BWD_KERNEL.launches
    with pytest.raises((RuntimeError, ValueError)):
        k1.corr_lookup_flat_bwd(lv, coords, g, radius)
    assert k1.BWD_KERNEL.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("want_coords", [True, False])
@pytest.mark.parametrize("case", ["random", "border", "integer"])
def test_bwd_kernel_matches_plain(case, want_coords, cuda):
    """K1b against its plain version: level grads and the coords grad at
    atol 1e-4 (sums of a few O(1) terms, in another order)."""
    levels, coords = _lookup_case(case)
    g = torch.randn((coords.shape[0], 4 * 81), generator=torch.Generator().manual_seed(2))
    levels = [m.to(cuda) for m in levels]
    coords, g = coords.to(cuda), g.to(cuda)
    before = k1.BWD_KERNEL.launches
    grads, gc = k1.corr_lookup_flat_bwd(levels, coords, g, want_coords=want_coords)
    torch.cuda.synchronize()
    assert k1.BWD_KERNEL.launches == before + 1
    want, want_c = k1.corr_lookup_flat_bwd_plain(levels, coords, g, want_coords=want_coords)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    if want_coords:
        torch.testing.assert_close(gc, want_c, rtol=0, atol=1e-4)
        if case == "integer":  # level 0 sits on the kinks; the others do not
            assert gc.abs().max() > 0
    else:
        assert gc is None


@pytest.mark.cuda
def test_corr_lookup_kernel_rejects_bad_input(cuda):
    levels, coords = _lookup_case("random")
    levels = [m.to(cuda) for m in levels]
    with pytest.raises(ValueError):
        k1.corr_lookup_flat(levels, coords.to(cuda).t().contiguous().t())
    with pytest.raises(ValueError):
        k1.corr_lookup_flat(levels, coords.to(cuda).double())


@pytest.mark.cuda
@pytest.mark.parametrize("cull", [False, True])
def test_raster_kernel_matches_plain_bit_for_bit(cull, cuda):
    """No FMA contraction on either side (the kernel is built with
    -fmad=false), so every map is identical, not just close."""
    rows, active, img = _raster_scene(cuda, cull=cull)
    bits = pk.id_bits_for(rows.shape[-1])
    before = k2.V3_KERNEL.launches
    got = k2.rasterize_shaded_v3(rows, active, img, img, bits)
    torch.cuda.synchronize()
    assert k2.V3_KERNEL.launches == before + 1
    want = k2.rasterize_shaded_v3_plain(rows, active, img, img, bits)
    assert want[:, 1].mean() > 0.1  # the scene is not empty
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("img,fc", [(128, 128), (128, 512), (192, 128), (100, 128)])
def test_packed_kernel_matches_plain_bit_for_bit(img, fc, cuda):
    """K4 at 8x128 tiles, at 8x192 tiles (a 192^2 crop) and on one 100x100
    tile, where each tile takes several blocks."""
    rows, active, kw = _packed_scene(cuda, img, fc)
    before = k2.PACKED_KERNEL.launches
    got = k2.rasterize_packed(rows, active, **kw)
    torch.cuda.synchronize()
    assert k2.PACKED_KERNEL.launches == before + 1
    want = k2.rasterize_packed_plain(rows, active, **kw)
    assert (want != k2.INT32_MAX).float().mean() > 0.1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("fc", [128, 512])
def test_shaded_v12_kernel_matches_plain_bit_for_bit(version, fc, cuda):
    rows, active, img = _raster_scene(cuda, fc=fc)
    bits = pk.id_bits_for(rows.shape[-1])
    before = k2.V12_KERNELS[version].launches
    got = k2.rasterize_shaded(rows, active, img, img, 8, 128, fc, bits, version=version)
    torch.cuda.synchronize()
    assert k2.V12_KERNELS[version].launches == before + 1
    want = k2.rasterize_shaded_plain(rows, active, img, img, 8, 128, fc, bits)
    assert want[:, 1].mean() > 0.1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dup", [8, 1])
def test_v4_kernel_matches_plain_bit_for_bit(dup, cuda):
    """K3; dup 1 sends nearly every face through the overflow lists."""
    packs, kw = _v4_scene(cuda, dup)
    before = k2.V4_KERNEL.launches
    got = k2.rasterize_shaded_v4(*packs, **kw)
    torch.cuda.synchronize()
    assert k2.V4_KERNEL.launches == before + 1
    want = k2.rasterize_shaded_v4_plain(*packs, **kw)
    assert want[:, 1].mean() > 0.1
    assert torch.equal(got, want)


# (kernel, crop, tiles th x tw, chunk fc, culling): every raster kernel on
# the adversarial scene, at K2's 8x128 tiles, at fc 512, on 8x192 tiles (a
# 192^2 crop) and on one 100x100 tile, where blocks overhang their tile, and
# the tile-generic kernels on one 5x5 and one 99x99 tile, where H*W is odd
# and the maps' channel planes are not 16-byte aligned
ADVERSARIAL_CASES = [
    ("K2", 128, 8, 128, 128, False), ("K2", 256, 8, 128, 128, True),
    ("K3", 128, 8, 128, 128, False), ("K3", 256, 8, 128, 128, True),
    ("K4", 128, 8, 128, 512, False), ("K4", 192, 8, 192, 128, True),
    ("K4", 100, 100, 100, 128, False),
    ("K5", 128, 8, 128, 512, True), ("K5", 100, 100, 100, 128, False),
    ("K6", 192, 8, 192, 128, False), ("K6", 256, 8, 128, 128, True),
    ("K3", 5, 5, 5, 128, False), ("K3", 99, 99, 99, 128, True),
    ("K4", 5, 5, 5, 128, True), ("K4", 99, 99, 99, 128, False),
    ("K5", 5, 5, 5, 128, True), ("K5", 99, 99, 99, 128, False),
    ("K6", 5, 5, 5, 128, False), ("K6", 99, 99, 99, 128, True),
]


def _misaligned(rows):
    """A contiguous copy of rows whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(rows.numel() + 4, dtype=rows.dtype, device=rows.device)
    start = next(i for i in range(4) if (buf.data_ptr() + 4 * i) % 16 == 4)
    out = buf[start:start + rows.numel()].view(rows.shape)
    out.copy_(rows)
    return out


def _adversarial_case(kernel, img, th, tw, fc, cull, device, misalign=False):
    """(kernel call, plain call, launch counter) on the adversarial scene;
    misalign hands the kernel rows that are not 16-byte aligned."""
    tri_xy, tri_z, fv, corner = (a.to(device) for a in adversarial_raster_corners(img))
    place = _misaligned if misalign else (lambda t: t)
    if kernel == "K3":
        packs = pk.pack_shaded_exact(tri_xy, tri_z, fv, corner, img, img, th, tw, fc,
                                     cull_backfaces=cull)[:5]
        packs = (place(packs[0]),) + tuple(packs[1:])
        kw = dict(h=img, w=img, th=th, tw=tw, fc=fc, id_bits=pk.id_bits_for(packs[0].shape[-1]))
        return (lambda: k2.rasterize_shaded_v4(*packs, **kw),
                lambda: k2.rasterize_shaded_v4_plain(*packs, **kw), k2.V4_KERNEL)
    if kernel == "K4":
        rows, active, _ = pk.pack_faces_and_bin(tri_xy, tri_z, fv, img, img, th, tw, fc,
                                                cull_backfaces=cull)
        rows = place(rows)
        kw = dict(h=img, w=img, th=th, tw=tw, fc=fc, id_bits=pk.id_bits_for(rows.shape[-1]))
        return (lambda: k2.rasterize_packed(rows, active, **kw),
                lambda: k2.rasterize_packed_plain(rows, active, **kw), k2.PACKED_KERNEL)
    rows, active, _ = pk.pack_shaded_and_bin(tri_xy, tri_z, fv, corner, img, img, th, tw, fc,
                                             cull_backfaces=cull)
    rows = place(rows)
    bits = pk.id_bits_for(rows.shape[-1])
    if kernel == "K2":
        return (lambda: k2.rasterize_shaded_v3(rows, active, img, img, bits),
                lambda: k2.rasterize_shaded_v3_plain(rows, active, img, img, bits),
                k2.V3_KERNEL)
    version = int(kernel[1]) - 4
    return (lambda: k2.rasterize_shaded(rows, active, img, img, th, tw, fc, bits,
                                        version=version),
            lambda: k2.rasterize_shaded_plain(rows, active, img, img, th, tw, fc, bits),
            k2.V12_KERNELS[version])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,img,th,tw,fc,cull", ADVERSARIAL_CASES)
def test_raster_kernels_on_the_adversarial_scene_bit_for_bit(kernel, img, th, tw, fc, cull,
                                                             cuda):
    """K2-K6 skip, per warp, the faces that cannot cover its pixels: on a
    scene of slivers, edge-on faces, faces on tile and warp borders, huge
    faces and a face over a whole tile, every key and map still equals the
    plain version's, which tests every face."""
    run, plain, counter = _adversarial_case(kernel, img, th, tw, fc, cull, cuda)
    before = counter.launches
    got = run()
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = plain()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,img,th,tw,fc,cull", [
    ("K2", 128, 8, 128, 128, True), ("K3", 99, 99, 99, 128, False),
    ("K4", 192, 8, 192, 512, True), ("K5", 100, 100, 100, 128, True),
    ("K6", 128, 8, 128, 128, False)])
def test_raster_kernels_take_rows_off_16_byte_boundaries(kernel, img, th, tw, fc, cull, cuda):
    """Contiguous rows that start 4 bytes past a 16-byte boundary are staged
    with 4-byte loads and give the plain version's keys and maps bit for
    bit."""
    run, plain, counter = _adversarial_case(kernel, img, th, tw, fc, cull, cuda, misalign=True)
    before = counter.launches
    got = run()
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert torch.equal(got, plain())


@pytest.mark.cuda
def test_raster_kernels_reject_bad_input(cuda):
    rows, active, img = _raster_scene(cuda)
    bits = pk.id_bits_for(rows.shape[-1])
    with pytest.raises(ValueError, match="version"):
        k2.rasterize_shaded(rows, active, img, img, 8, 128, 128, bits, version=3)
    with pytest.raises(ValueError):  # tiles that do not divide the crop
        k2.rasterize_shaded(rows, active, img, img, 8, 96, 128, bits)
    with pytest.raises(ValueError):  # active of another shape
        k2.rasterize_shaded(rows, active[:, :, :, :0].contiguous(), img, img, 8, 128, 128, bits)
    with pytest.raises(ValueError):  # too few id bits
        k2.rasterize_shaded(rows, active, img, img, 8, 128, 128, 3)
    with pytest.raises(ValueError):  # rows that are not contiguous
        k2.rasterize_packed(rows[:, :16], active, img, img, 8, 128, 128, bits)
    packs, kw = _v4_scene(cuda, 8)
    with pytest.raises(ValueError):  # an int64 overflow list
        k2.rasterize_shaded_v4(*packs[:4], packs[4].long(), **kw)
