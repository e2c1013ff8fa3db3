"""Kernels K1, K7, K8 (the corr lookup's variants), K1b (its backward) and
K2-K6 (the raster kernels) against their plain PyTorch versions, and the
CPU/CUDA dispatch of their wrappers.  The lookups and K1b run on float32
and on bfloat16 maps (their bf16 instances).

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
            k1.BWD_KERNEL.launches, k1.KERNEL_BF16.launches, k1.SHIFT_KERNEL_BF16.launches,
            k1.BDIAG_KERNEL_BF16.launches, k1.BWD_KERNEL_BF16.launches, k2.V3_KERNEL.launches,
            k2.V4_KERNEL.launches, k2.PACKED_KERNEL.launches, k2.V12_KERNELS[1].launches,
            k2.V12_KERNELS[2].launches)


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
@pytest.mark.parametrize("radius", [3, 4])
def test_corr_lookup_kernel_matches_plain(radius, case, cuda):
    """atol 1e-4: the kernel blends 4 corners, the plain version sums tent
    weights over whole rows; the two round differently.  Radius 4 (the
    shipped models) and 3 (RAFT-S and the SCFlow option set)."""
    levels, coords = _lookup_case(case)
    levels = [m.to(cuda) for m in levels]
    coords = coords.to(cuda)
    before = k1.KERNEL.launches
    got = k1.corr_lookup_flat(levels, coords, radius)
    torch.cuda.synchronize()
    assert k1.KERNEL.launches == before + 1
    want = k1.corr_lookup_flat_plain(levels, coords, radius)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_gather_lookup_matches_k1_at_the_train_rows(cuda):
    """ops/corr.py::corr_lookup_gather, the JAX package's numerical oracle
    for the lookup (the reference's bilinear gathers), over
    correlation_pyramid's 4-D levels against K1 through corr_lookup on the
    same levels, at the train step's 16,384 rows (16 x 32^2, levels
    32^2..4^2, radius 4; random, border-straddling and integer centres):
    within 1e-4."""
    from scflow_tpu_torch.ops.corr import corr_lookup, corr_lookup_gather, correlation_pyramid

    g = torch.Generator().manual_seed(4)
    f1, f2 = (torch.randn((16, 32, 32, 64), generator=g).to(cuda) for _ in range(2))
    flow = 4.0 * torch.randn((16, 32, 32, 2), generator=g)
    flow[5:10] = 80.0 * torch.rand((5, 32, 32, 2), generator=g) - 40.0
    flow[10:] = torch.randint(-12, 13, (6, 32, 32, 2), generator=g).float()
    flow = flow.to(cuda)
    pyramid = correlation_pyramid(f1, f2, 4)
    launches = k1.KERNEL.launches
    got = corr_lookup(pyramid, flow, 4, backend="pallas")
    assert k1.KERNEL.launches == launches + 1
    want = corr_lookup_gather(pyramid, flow, 4)
    assert got.shape == want.shape == (16, 32, 32, 324)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "border", "integer"])
@pytest.mark.parametrize("radius", [3, 4])
def test_shift_kernel_matches_plain_bit_for_bit(radius, case, cuda):
    """K7 and its plain version make the same two products and one sum per
    blend, unfused (-fmad=false): the outputs are identical."""
    levels, coords = _lookup_case(case)
    levels = [m.to(cuda) for m in levels]
    coords = coords.to(cuda)
    before = k1.SHIFT_KERNEL.launches
    got = k1.corr_lookup_flat(levels, coords, radius, variant="shift")
    torch.cuda.synchronize()
    assert k1.SHIFT_KERNEL.launches == before + 1
    assert torch.equal(got, k1.corr_lookup_flat_shift_plain(levels, coords, radius))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "border", "integer"])
@pytest.mark.parametrize("radius", [3, 4])
def test_bdiag_kernel_matches_tent_plain(radius, case, cuda):
    """K8 against the tent plain version at K1's atol 1e-4."""
    levels, coords = _lookup_case(case)
    levels = [m.to(cuda) for m in levels]
    coords = coords.to(cuda)
    before = k1.BDIAG_KERNEL.launches
    got = k1.corr_lookup_flat(levels, coords, radius, variant="bdiag")
    torch.cuda.synchronize()
    assert k1.BDIAG_KERNEL.launches == before + 1
    torch.testing.assert_close(got, k1.corr_lookup_flat_plain(levels, coords, radius), rtol=0,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["shift", "bdiag"])
def test_shift_and_bdiag_kernels_raise_at_radius_13(variant, cuda):
    """K7 and K8 build pipeline instances for radius 0-12: radius 13 takes
    their generic route, one launch, and matches their plain versions (K7
    bit for bit, K8 within K1's 1e-4); check_window, which the entry points
    call, takes it and refuses only a negative radius, and so does the
    launch."""
    levels, coords = _lookup_case("random")
    assert k1.window_layout(variant, 4, 13)["route"] == "generic"
    k1.check_window(variant, 4, 13)
    _check_window_kernel(variant, levels, coords, 13, cuda)
    with pytest.raises(ValueError, match="radius"):
        k1.check_window(variant, 4, -1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        k1.corr_lookup_flat([m.to(cuda) for m in levels], coords.to(cuda), -1, variant=variant)


@pytest.mark.cuda
def test_entry_point_rejects_a_radius_the_variant_does_not_build(cuda):
    """make_raft_infer_fn on a radius-13 model with lookup_variant 'shift'
    (past K7's pipeline instances) builds without launching anything; its
    call launches K7 once per iteration, on its generic route."""
    from scflow_tpu_torch.refiners.raft import RAFTRefinerFlowMask
    from scflow_tpu_torch.refiners.system import RenderAssets, make_raft_infer_fn

    model = RAFTRefinerFlowMask(iters=1, radius=13, convex_upsample_flow=False)
    assets = RenderAssets.from_bank(make_synthetic_bank(3), device=cuda)
    before = _all_launches()
    infer = make_raft_infer_fn(model, assets, image_size=(64, 64), lookup_backend="pallas",
                               lookup_variant="shift", device=cuda)
    assert _all_launches() == before
    rng = np.random.default_rng(0)
    batch = {"real_images": rng.random((2, 64, 64, 3), dtype=np.float32),
             "ref_rotations": np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)),
             "ref_translations": np.array([[0.0, 0.0, 400.0]] * 2, np.float32),
             "labels": np.array([0, 1]),
             "k": np.tile(np.array([[150.0, 0, 32], [0, 150.0, 32], [0, 0, 1]], np.float32),
                          (2, 1, 1))}
    out = infer(batch)
    torch.cuda.synchronize()
    assert k1.SHIFT_KERNEL.launches == before[1] + 1
    assert bool(torch.isfinite(out["flow"]).all())


# the route table: the largest radius of each source's pipeline instances
# (MAX_RADIUS, BWD_MAX_RADIUS in csrc/); the pipeline takes a window of at
# most four levels whose two ring stages fit a block's opt-in shared memory
# (227 KB on an H100), the generic kernel every other, four levels a launch;
# and the windows of up to four levels that a radius in the pipeline's range
# still sends to the generic kernel: {(levels, radius): (fp32, bf16)}
PIPELINE_RADIUS = {"tent": 15, "shift": 12, "bdiag": 12, "bwd": 15}
OVER_SMEM = {(4, 15): (True, False), (4, 12): (False, False), (3, 15): (False, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_max_radius_table_matches_the_libraries(dtype, cuda):
    """The route table (PIPELINE_RADIUS, OVER_SMEM) against each built
    library, at level counts 1-7: one pipeline launch up to the largest
    radius and four levels, else the generic kernel, one launch per four
    levels, without dynamic shared memory."""
    for variant in (*k1.VARIANTS, "bwd"):
        top = PIPELINE_RADIUS[variant]
        for radius in (0, 4, top, top + 1, 24):
            for levels in range(1, 8):
                if variant == "bwd":
                    layouts = [k1.bwd_layout(levels, radius, w, dtype) for w in (False, True)]
                else:
                    layouts = [k1.window_layout(variant, levels, radius, dtype)]
                for layout in layouts:
                    assert layout["max_radius"] == top
                    if radius > top or levels > 4:
                        assert layout["route"] == "generic"
                    if layout["route"] == "generic":
                        assert layout["launches"] == -(-levels // 4)
                        assert layout["smem_bytes"] == 0
                    else:
                        assert layout["launches"] == 1
                        assert 0 < layout["smem_bytes"] <= 227 * 1024
    for (levels, radius), generic in OVER_SMEM.items():
        got = k1.window_layout("tent", levels, radius, dtype)["route"]
        assert got == ("generic" if generic[dtype == torch.bfloat16] else "window")


@pytest.mark.cuda
def test_non_square_maps_refuse_the_kernel_backend_on_the_card(cuda):
    """The 1/8 maps of a 256x192 crop (32x24): no kernel takes them, so
    backend 'pallas' on CUDA tensors raises, in corr_lookup and at an entry
    point's construction, and launches nothing; 'xla' (and 'auto') runs the
    JAX package's route there and matches the same route on the CPU."""
    from scflow_tpu_torch.ops.corr import corr_lookup, correlation_pyramid_flat
    from scflow_tpu_torch.refiners.raft import RAFTRefinerFlow
    from scflow_tpu_torch.refiners.system import RenderAssets, make_raft_infer_fn

    g = torch.Generator().manual_seed(0)
    f1, f2 = (torch.randn((1, 32, 24, 16), generator=g) for _ in range(2))
    flow = 3.0 * torch.randn((1, 32, 24, 2), generator=g)
    want = corr_lookup(correlation_pyramid_flat(f1, f2), flow, 3, backend="pallas")
    levels = correlation_pyramid_flat(f1.to(cuda), f2.to(cuda))
    before = _all_launches()
    with pytest.raises(ValueError, match="square"):
        corr_lookup(levels, flow.to(cuda), 3, backend="pallas")
    for backend in ("xla", "auto"):
        got = corr_lookup(levels, flow.to(cuda), 3, backend=backend)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    model = RAFTRefinerFlow(iters=1, convex_upsample_flow=False)
    assets = RenderAssets.from_bank(make_synthetic_bank(3), device=cuda)
    with pytest.raises(ValueError, match="square"):
        make_raft_infer_fn(model, assets, image_size=(256, 192), lookup_backend="pallas",
                           device=cuda)
    make_raft_infer_fn(model, assets, image_size=(256, 192), lookup_backend="xla", device=cuda)
    assert _all_launches() == before


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
    """The library's pipeline covers exactly the radii the tests drive, in
    one launch at 1-4 levels; the next radius and a fifth level take the
    generic route (a fifth level in a second launch); a negative radius and
    no levels are refused."""
    for radius, levels in WINDOW_SHAPES:
        layout = k1.window_layout(variant, levels, radius)
        assert layout["max_radius"] == max(WINDOW_RADII)
        assert (layout["route"], layout["launches"]) == ("window", 1)
        assert layout["threads"] % 32 == 0 and 0 < layout["smem_bytes"] <= 227 * 1024
    assert k1.window_layout(variant, 1, max(WINDOW_RADII) + 1)["route"] == "generic"
    five = k1.window_layout(variant, 5, 4)
    assert (five["route"], five["launches"]) == ("generic", 2)
    for radius, levels in [(-1, 2), (4, 0)]:
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
    library's largest) takes the generic route and matches the plain
    version; a negative radius raises from the launch, and the plain
    version never runs for a CUDA tensor."""
    lv, coords = _window_case(16, (6, 3, 2, 1)[:levels], 1)
    if radius == "past":
        radius = k1.window_layout(variant, levels, 0)["max_radius"] + 1
        assert k1.window_layout(variant, levels, radius)["route"] == "generic"
        _check_window_kernel(variant, lv, coords, radius, cuda)
        return
    monkeypatch.setitem(k1.PLAIN, variant, _plain_must_not_run)
    monkeypatch.setattr(k1, "corr_lookup_flat_plain", _plain_must_not_run)
    monkeypatch.setattr(k1, "corr_lookup_flat_shift_plain", _plain_must_not_run)
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
    tail of 3, NaN, far-outside and integer centres): every pair launches
    (a pair whose two ring stages exceed a block's shared memory in groups
    of fewer levels, each at its column offset) and matches the plain
    version."""
    levels_, coords = _window_case(75, (10, 5, 3, 2)[:levels], radius, seed=radius)
    _check_window_kernel("tent", levels_, coords, radius, cuda)


@pytest.mark.cuda
def test_tent_layout_takes_every_pair_the_first_k1_took(cuda):
    """K1's library builds pipeline instances for radius 0-15 and launches
    every pair L*(2r+1)^2 <= 1024 in one pipeline launch; radius 15 at four
    levels (about 258 KB of shared memory in one launch), radius 16 and five
    levels take the generic route (five levels in two launches).  A
    negative radius and no levels are refused."""
    for radius in range(16):
        for levels in range(1, 5):
            if _launched_before(radius, levels):
                layout = k1.window_layout("tent", levels, radius)
                assert layout["max_radius"] == 15 and layout["launches"] == 1
                assert layout["route"] == "window" and layout["smem_bytes"] <= 227 * 1024
    got = {pair: k1.window_layout("tent", *pair) for pair in [(4, 15), (1, 16), (5, 4)]}
    assert [(v["route"], v["launches"]) for v in got.values()] == [
        ("generic", 1), ("generic", 1), ("generic", 2)]
    for levels, radius in [(1, -1), (0, 4)]:
        with pytest.raises(RuntimeError, match="CUDA error"):
            k1.window_layout("tent", levels, radius)


def _bwd_grad_out(rows, cols, seed, offset=False):
    """The output gradient; with offset, a contiguous view 4 bytes past a
    16-byte boundary (K1b then stages it with 4-byte copies)."""
    g = torch.randn((rows * cols + 1,), generator=torch.Generator().manual_seed(seed))
    return (g[1:] if offset else g[:-1]).view(rows, cols)


def _coords_atol(levels, radius):
    """The flow gradient's bound: 1e-4 at the flagship window's 4 x 81
    taps, growing with the taps it sums in float32 past them (the plain
    version sums them by matrix products in another order)."""
    return 1e-4 * max(1.0, levels * (2 * radius + 1) ** 2 / 324)


def _check_bwd_kernel(levels, coords, g, radius, want_coords, cuda, coords_atol=1e-4):
    """K1b against its plain version at atol 1e-4 (level grads, NaN where
    they are NaN; the coords grad of every row with a finite centre, at
    coords_atol), one launch a call, the same bits from a second launch,
    and a NaN centre's rows NaN in every level and in the coords grad."""
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
        torch.testing.assert_close(gc[~nan_rows], want_c[~nan_rows], rtol=0, atol=coords_atol)
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
    window launches (one past a block's shared memory in groups of fewer
    levels, the flow gradient summed on from group to group) and matches
    the plain version."""
    levels_, coords = _window_case(75, (10, 5, 3, 2)[:levels], radius, seed=radius)
    g = _bwd_grad_out(75, levels * (2 * radius + 1) ** 2, radius, offset=radius % 2 == 1)
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
    """Radius 16 (past K1b's pipeline instances: the generic kernels) and a
    fifth level (a second launch) run and match the plain version; a
    negative radius raises from the launch, without the plain version."""
    gen = torch.Generator().manual_seed(levels)
    lv = [torch.randn((16, s * s), generator=gen) for s in (6, 3, 2, 1, 1)[:levels]]
    coords = 6.0 * torch.rand((16, 2), generator=gen)
    g = torch.randn((16, levels * (2 * max(radius, 0) + 1) ** 2), generator=gen)
    if radius >= 0:
        for want_coords in (True, False):
            _check_bwd_kernel(lv, coords, g, radius, want_coords, cuda,
                              _coords_atol(levels, radius))
        return
    monkeypatch.setattr(k1, "corr_lookup_flat_bwd_plain", _plain_must_not_run)
    before = k1.BWD_KERNEL.launches
    with pytest.raises((RuntimeError, ValueError)):
        k1.corr_lookup_flat_bwd([m.to(cuda) for m in lv], coords.to(cuda), g.to(cuda), radius)
    assert k1.BWD_KERNEL.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("want_coords", [True, False])
@pytest.mark.parametrize("case", ["random", "border", "integer"])
@pytest.mark.parametrize("radius", [3, 4])
def test_bwd_kernel_matches_plain(radius, case, want_coords, cuda):
    """K1b against its plain version: level grads and the coords grad at
    atol 1e-4 (sums of a few O(1) terms, in another order)."""
    levels, coords = _lookup_case(case)
    k = 2 * radius + 1
    g = torch.randn((coords.shape[0], 4 * k * k), generator=torch.Generator().manual_seed(2))
    levels = [m.to(cuda) for m in levels]
    coords, g = coords.to(cuda), g.to(cuda)
    before = k1.BWD_KERNEL.launches
    grads, gc = k1.corr_lookup_flat_bwd(levels, coords, g, radius, want_coords=want_coords)
    torch.cuda.synchronize()
    assert k1.BWD_KERNEL.launches == before + 1
    want, want_c = k1.corr_lookup_flat_bwd_plain(levels, coords, g, radius,
                                                 want_coords=want_coords)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    if want_coords:
        torch.testing.assert_close(gc, want_c, rtol=0, atol=1e-4)
        if case == "integer":  # level 0 sits on the kinks; the others do not
            assert gc.abs().max() > 0
    else:
        assert gc is None


# The windows past the first K1's: more than four levels and radii past the
# pipeline instances (the generic route), against the plain versions, on
# levels that halve down to the window
NEW_WINDOWS = [(5, 4), (6, 3), (4, 16), (2, 24)]  # (levels, radius)
NEW_WINDOW_SIZES = {5: (16, 8, 4, 2, 1), 6: (32, 16, 8, 4, 2, 1), 4: (32, 16, 8, 4),
                    2: (32, 16)}


def _new_window_case(levels, radius):
    lv, coords = _window_case(75, NEW_WINDOW_SIZES[levels], radius, seed=levels + radius)
    return lv, _corner_rows(coords, NEW_WINDOW_SIZES[levels][0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["tent", "shift", "bdiag"])
@pytest.mark.parametrize("levels,radius", NEW_WINDOWS)
def test_lookup_kernels_at_the_new_windows(levels, radius, variant, dtype, cuda, monkeypatch):
    """K1, K7 and K8 at 5 and 6 levels and at radius 16 and 24 (the generic
    route; more than four levels in two launches): K7 bit for bit with its
    plain version, K1 and K8 within 1e-4 of the tent plain version, one
    count a call; on bf16 maps the bf16 instances."""
    lv, coords = _new_window_case(levels, radius)
    layout = k1.window_layout(variant, levels, radius, dtype)
    assert (layout["route"], layout["launches"]) == ("generic", -(-levels // 4))
    if dtype == torch.bfloat16:
        _check_bf16_window_kernel(variant, lv, coords, radius, cuda, monkeypatch)
    else:
        _check_window_kernel(variant, lv, coords, radius, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("want_coords", [True, False])
@pytest.mark.parametrize("levels,radius", NEW_WINDOWS)
def test_bwd_kernel_at_the_new_windows(levels, radius, want_coords, dtype, cuda, monkeypatch):
    """K1b at the new windows (the generic kernels), with and without the
    flow gradient: level grads within 1e-4 (bf16: one bf16 ulp) of the
    plain version's, the flow gradient within _coords_atol (it sums L k^2
    taps; summed on from group to group), the same bits from two launches,
    NaN rows NaN."""
    lv, coords = _new_window_case(levels, radius)
    g = _bwd_grad_out(75, levels * (2 * radius + 1) ** 2, radius, offset=radius % 2 == 1)
    assert k1.bwd_layout(levels, radius, want_coords, dtype)["route"] == "generic"
    atol = _coords_atol(levels, radius)
    if dtype == torch.bfloat16:
        _check_bf16_bwd_kernel(lv, coords, g, radius, want_coords, cuda, monkeypatch, atol)
    else:
        _check_bwd_kernel(lv, coords, g, radius, want_coords, cuda, atol)


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


# ---------------------------------------------------------------------------
# bfloat16 maps: the bf16 instances of K1, K7, K8 and K1b

def _bf16(levels):
    """The same seeded levels rounded to bfloat16."""
    return [m.to(torch.bfloat16) for m in levels]


def _corner_rows(coords, size0):
    """The last three rows' centres on the maps' last column and row (the
    last element of each level), at integer and fractional positions."""
    coords = coords.clone()
    coords[-3:] = torch.tensor([[size0 - 1.0, size0 - 1.0], [size0 - 0.5, size0 - 1.0],
                                [size0 - 1.25, size0 - 0.75]])
    return coords


def test_cpu_bf16_maps_run_the_plain_versions_without_launching():
    """On the CPU a bf16 map runs the plain versions, on its cells upcast:
    the same output as the float32 plain version on the upcast levels, and
    level grads rounded from the float32 ones."""
    levels, coords = _lookup_case("random")
    lv16 = _bf16(levels)
    up = [m.float() for m in lv16]
    before = _all_launches()
    for variant in k1.VARIANTS:
        got = k1.corr_lookup_flat(lv16, coords, variant=variant)
        assert got.dtype == torch.float32
        assert torch.equal(got, k1.PLAIN[variant](up, coords))
    g = torch.randn((coords.shape[0], 4 * 81), generator=torch.Generator().manual_seed(1))
    grads, gc = k1.corr_lookup_flat_bwd(lv16, coords, g)
    want, want_c = k1.corr_lookup_flat_bwd_plain(up, coords, g)
    assert all(a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16))
               for a, b in zip(grads, want))
    assert torch.equal(gc, want_c)
    assert _all_launches() == before


def _bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _assert_within_bf16_ulp(got, want):
    """Level grads: each element within one bf16 ulp of the plain version's
    (the two float32 sums, in another order, round to neighbours at most),
    or within 1e-6 where the terms cancel to about zero; NaN where NaN."""
    assert got.dtype == want.dtype == torch.bfloat16
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    a, b = got.float()[~nan], want.float()[~nan]
    d = (a - b).abs()
    assert bool((d <= torch.maximum(_bf16_ulp(a), _bf16_ulp(b)) + 1e-6).all()), d.max()


def _check_bf16_window_kernel(variant, levels, coords, radius, cuda, monkeypatch):
    """The bf16 instance of K1/K7/K8 on bf16 maps against the plain version
    on the same maps: K7 bit for bit, K1 and K8 within 1e-4 (float32 on
    exact cells); one launch of the bf16 instance, none of the float32 one,
    and no plain version."""
    lv = [m.to(cuda) for m in _bf16(levels)]
    coords = coords.to(cuda)
    want = k1.PLAIN[variant](lv, coords, radius)
    monkeypatch.setitem(k1.PLAIN, variant, _plain_must_not_run)
    monkeypatch.setattr(k1, "corr_lookup_flat_plain", _plain_must_not_run)
    monkeypatch.setattr(k1, "corr_lookup_flat_shift_plain", _plain_must_not_run)
    kernel, other = k1.FORWARD_KERNELS_BF16[variant], k1.FORWARD_KERNELS[variant]
    before, before_other = kernel.launches, other.launches
    got = k1.corr_lookup_flat(lv, coords, radius, variant=variant)
    torch.cuda.synchronize()
    assert (kernel.launches, other.launches) == (before + 1, before_other)
    assert got.dtype == torch.float32
    if variant == "shift":
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["tent", "shift", "bdiag"])
@pytest.mark.parametrize("radius", range(16))
@pytest.mark.parametrize("sizes", [(10, 5, 3, 2), (32, 16, 8, 4)])
def test_bf16_window_kernels_every_radius(variant, radius, sizes, cuda, monkeypatch):
    """Radius 0-15 (K7/K8's pipeline builds 0-12, their generic route takes
    13-15) at 4 levels on 75 rows: odd and even window x starts (random,
    border, integer, NaN and far centres), odd map sizes (5, 3: the start's
    parity changes from row to row) and an odd element count (75 x 5^2: the
    level's last element sits alone in its word), with the last rows on
    each map's last column and row."""
    levels, coords = _window_case(75, sizes, radius, seed=radius)
    coords = _corner_rows(coords, sizes[0])
    _check_bf16_window_kernel(variant, levels, coords, radius, cuda, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["tent", "shift", "bdiag"])
@pytest.mark.parametrize("levels", [1, 2, 3])
def test_bf16_window_kernels_every_level_count(variant, levels, cuda, monkeypatch):
    lv, coords = _window_case(75, (9, 5, 3)[:levels], 3, seed=levels)
    _check_bf16_window_kernel(variant, lv, _corner_rows(coords, 9), 3, cuda, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["tent", "shift", "bdiag"])
@pytest.mark.parametrize("rows", ["one", "group-1", "group+1"])
def test_bf16_window_kernels_ragged_row_counts(variant, rows, cuda, monkeypatch):
    group = k1.window_layout(variant, 4, 4, torch.bfloat16)["rows_per_group"]
    rows = {"one": 1, "group-1": group - 1, "group+1": group + 1}[rows]
    g = torch.Generator().manual_seed(rows)
    levels = [torch.randn((rows, s * s), generator=g) for s in (9, 5, 3, 1)]
    coords = (11.0 * torch.rand((rows, 2), generator=g) - 1.0).contiguous()
    _check_bf16_window_kernel(variant, levels, coords, 4, cuda, monkeypatch)


@pytest.mark.cuda
def test_bf16_layout_takes_every_pair_the_first_k1_took(cuda):
    """The bf16 instances take every (radius, levels) pair the float32 ones
    take below L*(2r+1)^2 <= 1024."""
    for variant in k1.VARIANTS:
        top = k1.window_layout(variant, 1, 0)["max_radius"]
        for radius in range(top + 1):
            for levels in range(1, 5):
                if _launched_before(radius, levels):
                    layout = k1.window_layout(variant, levels, radius, torch.bfloat16)
                    assert layout["smem_bytes"] <= 227 * 1024
                    bwd = k1.bwd_layout(levels, radius, True, torch.bfloat16)
                    assert bwd["smem_bytes"] <= 227 * 1024


@pytest.mark.cuda
def test_bf16_levels_off_4_byte_boundaries_raise(cuda):
    levels, coords = _lookup_case("random")
    lv = [m.to(cuda) for m in _bf16(levels)]
    flat = torch.empty(lv[0].numel() + 1, dtype=torch.bfloat16, device=cuda)
    off = flat[1:].view(lv[0].shape)
    off.copy_(lv[0])
    with pytest.raises(ValueError, match="4-byte"):
        k1.corr_lookup_flat([off] + lv[1:], coords.to(cuda))
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        k1.corr_lookup_flat([lv[0].float()] + lv[1:], coords.to(cuda))
    with pytest.raises(ValueError, match="float32 coords"):
        k1.corr_lookup_flat(lv, coords.to(cuda).to(torch.bfloat16))


def _check_bf16_bwd_kernel(levels, coords, g, radius, want_coords, cuda, monkeypatch,
                           coords_atol=1e-4):
    """K1b's bf16 instance on bf16 maps: level grads bf16 within one bf16
    ulp of the plain version's (each rounded once from a float32 sum), the
    flow grad within 1e-4 for every finite centre; the same bits from a
    second launch; one launch of the bf16 instance, none of the float32
    one, no plain version."""
    lv = [m.to(cuda) for m in _bf16(levels)]
    coords, g = coords.to(cuda), g.to(cuda)
    want, want_c = k1.corr_lookup_flat_bwd_plain(lv, coords, g, radius, want_coords)
    monkeypatch.setattr(k1, "corr_lookup_flat_bwd_plain", _plain_must_not_run)
    before = (k1.BWD_KERNEL_BF16.launches, k1.BWD_KERNEL.launches)
    grads, gc = k1.corr_lookup_flat_bwd(lv, coords, g, radius, want_coords)
    torch.cuda.synchronize()
    assert (k1.BWD_KERNEL_BF16.launches, k1.BWD_KERNEL.launches) == (before[0] + 1, before[1])
    again, again_c = k1.corr_lookup_flat_bwd(lv, coords, g, radius, want_coords)
    nan_rows = torch.isnan(coords).any(dim=1)
    for a, b, c in zip(grads, want, again):
        _assert_within_bf16_ulp(a, b)
        assert torch.equal(a.float().nan_to_num(7.0), c.float().nan_to_num(7.0))
    if want_coords:
        assert gc.dtype == torch.float32
        torch.testing.assert_close(gc[~nan_rows], want_c[~nan_rows], rtol=0, atol=coords_atol)
        assert torch.isnan(gc[nan_rows]).all()
        assert torch.equal(gc.nan_to_num(7.0), again_c.nan_to_num(7.0))
    else:
        assert gc is None


@pytest.mark.cuda
@pytest.mark.parametrize("want_coords", [True, False])
@pytest.mark.parametrize("radius", [0, 1, 2, 4, 7, 9, 10, 14, 15])
@pytest.mark.parametrize("sizes", [(10, 5, 3, 2), (32, 16, 8, 4)])
def test_bf16_bwd_kernel(radius, sizes, want_coords, cuda, monkeypatch):
    """K1b on bf16 maps at radius 0-15 (each group size: 8, 4 and 2 rows),
    4 levels where they fit a block, else 1: 75 rows of random, border,
    integer, NaN and far centres, the last rows on the maps' last column;
    10^2 and 32^2..8^2 levels take 16-byte stores of 8 values, 5^2, 3^2
    and 2^2 2-byte ones; an output gradient off 16 bytes on odd radii."""
    levels = 4 if _launched_before(radius, 4) else 1
    lv, coords = _window_case(75, sizes[:levels], radius, seed=radius)
    coords = _corner_rows(coords, sizes[0])
    g = _bwd_grad_out(75, levels * (2 * radius + 1) ** 2, radius, offset=radius % 2 == 1)
    _check_bf16_bwd_kernel(lv, coords, g, radius, want_coords, cuda, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("want_coords", [True, False])
def test_bf16_bwd_kernel_at_the_train_shape(want_coords, cuda, monkeypatch):
    """Levels 32^2..4^2, radius 4, 16 images of 32^2 rows: the train step's
    16,384 rows."""
    lv, coords = _window_case(16 * 32 * 32, (32, 16, 8, 4), 4, seed=7)
    g = _bwd_grad_out(coords.shape[0], 4 * 81, 7)
    _check_bf16_bwd_kernel(lv, coords, g, 4, want_coords, cuda, monkeypatch)


# The kernels as torch.library custom ops (scflow::*) on the card.

def _card_op_cases(cuda):
    """{name: (op, args)}: each op at a small shape on CUDA tensors."""
    levels, coords = _lookup_case("random")
    levels = [m.to(cuda) for m in levels]
    coords = coords.to(cuda)
    g = torch.randn((coords.shape[0], 4 * 81), generator=torch.Generator().manual_seed(2))
    cases = {f"corr_lookup_{v}_{dt}": (torch.ops.scflow.corr_lookup.default,
                                       ([m.to(dtype) for m in levels], coords, 4, v))
             for v in k1.VARIANTS for dt, dtype in (("f32", torch.float32),
                                                     ("bf16", torch.bfloat16))}
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for want in (True, False):
            cases[f"corr_lookup_bwd_{dt}_{want}"] = (
                torch.ops.scflow.corr_lookup_bwd.default,
                ([m.to(dtype) for m in levels], coords, g.to(cuda), 4, want))
    rows, active, img = _raster_scene(cuda)
    bits = pk.id_bits_for(rows.shape[-1])
    cases["raster_v3"] = (torch.ops.scflow.raster_v3.default, (rows, active, img, img, bits))
    for version in (1, 2):
        cases[f"raster_v12_{version}"] = (torch.ops.scflow.raster_v12.default,
                                          (rows, active, img, img, 8, 128, 128, bits, version))
    rows_p, active_p, kw = _packed_scene(cuda, 128, 128)
    cases["raster_packed"] = (torch.ops.scflow.raster_packed.default,
                              (rows_p, active_p, *kw.values()))
    packs, kw = _v4_scene(cuda, 8)
    cases["raster_v4"] = (torch.ops.scflow.raster_v4.default, (*packs, *kw.values()))
    return cases


def _op_kernel(name):
    """The CudaKernel an op case launches."""
    if name.startswith("corr_lookup_bwd"):
        return k1.bwd_kernel(torch.bfloat16 if "bf16" in name else torch.float32)
    if name.startswith("corr_lookup"):
        _, _, variant, dt = name.split("_")
        return k1.forward_kernel(variant, torch.bfloat16 if dt == "bf16" else torch.float32)
    if name.startswith("raster_v12"):
        return k2.V12_KERNELS[int(name[-1])]
    return {"raster_v3": k2.V3_KERNEL, "raster_v4": k2.V4_KERNEL,
            "raster_packed": k2.PACKED_KERNEL}[name]


CARD_OPS = ([f"corr_lookup_{v}_{dt}" for v in k1.VARIANTS for dt in ("f32", "bf16")]
            + [f"corr_lookup_bwd_{dt}_{w}" for dt in ("f32", "bf16") for w in (True, False)]
            + ["raster_v3", "raster_v4", "raster_packed", "raster_v12_1", "raster_v12_2"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_OPS)
def test_op_opcheck_on_the_card(name, cuda):
    """torch.library.opcheck of each op on CUDA tensors, where its body
    launches the kernel: the schema, the fake against the kernel, the
    autograd registration (the lookup's backward is K1b) and the trace
    with dynamic shapes."""
    op, args = _card_op_cases(cuda)[name]
    if name.startswith("corr_lookup_") and not name.startswith("corr_lookup_bwd"):
        args = ([m.requires_grad_() for m in args[0]], args[1].requires_grad_(), *args[2:])
    torch.library.opcheck(op, args)


def _all_kernels():
    """The counters of _all_launches, in its order."""
    return (k1.KERNEL, k1.SHIFT_KERNEL, k1.BDIAG_KERNEL, k1.BWD_KERNEL, k1.KERNEL_BF16,
            k1.SHIFT_KERNEL_BF16, k1.BDIAG_KERNEL_BF16, k1.BWD_KERNEL_BF16, k2.V3_KERNEL,
            k2.V4_KERNEL, k2.PACKED_KERNEL, k2.V12_KERNELS[1], k2.V12_KERNELS[2])


def _wrapper_call(name, args):
    """The same call through the op's public wrapper."""
    if name.startswith("corr_lookup_bwd"):
        return k1.corr_lookup_flat_bwd(*args)
    if name.startswith("corr_lookup"):
        return k1.corr_lookup_flat(*args)
    if name.startswith("raster_v12"):
        return k2.rasterize_shaded(*args[:-1], version=args[-1])
    return {"raster_v3": k2.rasterize_shaded_v3, "raster_v4": k2.rasterize_shaded_v4,
            "raster_packed": k2.rasterize_packed}[name](*args)


@pytest.mark.cuda
def test_each_op_call_is_one_launch(cuda):
    """Each op call, through torch.ops or its public wrapper, moves its
    kernel's count by exactly one and no other count (the count moves in
    CudaKernel.launch only); the lookup's backward launches one K1b."""
    assert _all_launches() == tuple(k.launches for k in _all_kernels())
    cases = _card_op_cases(cuda)
    for name, (op, args) in cases.items():
        want = [int(k is _op_kernel(name)) for k in _all_kernels()]
        assert sum(want) == 1, name
        for call in (lambda: op(*args), lambda: _wrapper_call(name, args)):
            before = _all_launches()
            call()
            torch.cuda.synchronize()
            assert [a - b for a, b in zip(_all_launches(), before)] == want, name
    levels, coords, radius, variant = cases["corr_lookup_tent_f32"][1]
    lv = [m.clone().requires_grad_() for m in levels]
    out = k1.corr_lookup_flat(lv, coords, radius, variant)
    before = _all_launches()
    out.sum().backward()
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_all_launches(), before)] == [
        int(k is k1.BWD_KERNEL) for k in _all_kernels()]


@pytest.mark.cuda
def test_op_launch_count_is_exact_across_threads(cuda):
    """8 threads x 50 lookups through the op, with a short switch
    interval: 400 launches counted, one per call."""
    import sys
    import threading

    levels, coords = _lookup_case("random")
    levels, coords = [m.to(cuda) for m in levels], coords.to(cuda)
    before = k1.KERNEL.launches

    def work():
        for _ in range(50):
            torch.ops.scflow.corr_lookup(levels, coords, 4, "tent")

    threads = [threading.Thread(target=work) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    assert not any(t.is_alive() for t in threads)
    assert k1.KERNEL.launches == before + 400


@pytest.mark.cuda
def test_overfit_check_launches_per_step(cuda):
    """The learning check (tools/overfit_check.py) on lookup 'pallas' at the
    tool's shapes (8 x 128^2, 4 iterations), 3 steps then one evaluation:
    every step launches exactly 1 K2, 4 K1 and 4 K1b, the evaluation 1 K2
    and 4 K1; finite losses."""
    from scflow_tpu_torch.tools import overfit_check

    per_step = []

    def on_step(i, logs):
        per_step.append(_all_launches())

    start = _all_launches()
    res = overfit_check.run(steps=3, every=3, lookup_backend="pallas", device=cuda,
                            on_step=on_step, log=lambda line: None)
    torch.cuda.synchronize()
    end = _all_launches()
    # _all_launches' order: K1, K7, K8, K1b, the four bf16 instances, K2-K6
    step = (4, 0, 0, 4, 0, 0, 0, 0, 1, 0, 0, 0, 0)
    counts = [tuple(b - a for a, b in zip(x, y)) for x, y in zip([start] + per_step, per_step)]
    assert counts == [step] * 3
    assert tuple(b - a for a, b in zip(per_step[-1], end)) == (4, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0,
                                                               0, 0)
    assert np.isfinite(res["losses"]).all() and len(res["curve"]) == 1
