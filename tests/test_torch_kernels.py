"""Kernels K1 (corr lookup) and K2 (raster v3) against their plain PyTorch
versions, and the CPU/CUDA dispatch of their wrappers.

Tests marked `cuda` need a card and skip without one.  This file imports no
JAX, so on a machine with only PyTorch and a card it runs as
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from scflow_tpu_torch.ops.cuda import corr_lookup as k1
from scflow_tpu_torch.ops.cuda import rasterize as k2
from scflow_tpu_torch.render.meshbank import make_synthetic_bank
from scflow_tpu_torch.render.rasterizer import gather_corner_attrs, gather_tri, project_to_screen


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


def _raster_scene(device, n=2, img=128, cull=True):
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
    rows, active, _ = k2.pack_shaded_and_bin(
        tri_xy.to(device), tri_z.to(device), torch.from_numpy(bank.face_valid)[labels].to(device),
        corner.to(device), img, img, cull_backfaces=cull)
    return rows, active, img


def test_cpu_tensors_run_the_plain_versions_without_launching():
    levels, coords = _lookup_case("random")
    before = (k1.KERNEL.launches, k2.KERNEL.launches)
    torch.testing.assert_close(k1.corr_lookup_flat(levels, coords),
                               k1.corr_lookup_flat_plain(levels, coords), rtol=0, atol=0)
    rows, active, img = _raster_scene(torch.device("cpu"))
    bits = k2.id_bits_for(rows.shape[-1])
    torch.testing.assert_close(k2.rasterize_shaded_v3(rows, active, img, img, bits),
                               k2.rasterize_shaded_v3_plain(rows, active, img, img, bits),
                               rtol=0, atol=0)
    assert (k1.KERNEL.launches, k2.KERNEL.launches) == before


def test_wrappers_reject_other_devices():
    levels = [torch.empty((4, s * s), device="meta") for s in (4, 2, 1)]
    with pytest.raises(ValueError, match="unsupported device"):
        k1.corr_lookup_flat(levels, torch.empty((4, 2), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        k2.rasterize_shaded_v3(torch.empty((1, 32, 128), device="meta"),
                               torch.empty((1, 1, 1, 1), dtype=torch.int32, device="meta"),
                               8, 128, 7)


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
    bits = k2.id_bits_for(rows.shape[-1])
    before = k2.KERNEL.launches
    got = k2.rasterize_shaded_v3(rows, active, img, img, bits)
    torch.cuda.synchronize()
    assert k2.KERNEL.launches == before + 1
    want = k2.rasterize_shaded_v3_plain(rows, active, img, img, bits)
    assert want[:, 1].mean() > 0.1  # the scene is not empty
    assert torch.equal(got, want)
