"""The hand-written kernels as torch.library custom ops (`scflow::*`): every
op passes torch.library.opcheck on CPU tensors (its schema, its fake body
against the real one, its autograd registration, and a trace through
AOTDispatcher with dynamic shapes), where the real body is the kernel's
plain version; the lookup's registered backward is K1b's plain version
and passes gradcheck in float64; the fake bodies give the kernels' output
shapes and dtypes and run their shape checks on CUDA tensors, which
FakeTensorMode makes on a host without a card.

The card's side (opcheck on CUDA tensors, one launch per op call) is in
tests/test_torch_kernels.py."""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from scflow_tpu_torch.geometry import coords_grid
from scflow_tpu_torch.ops import corr
from scflow_tpu_torch.ops import raster_pack as pk
from scflow_tpu_torch.ops.cuda import corr_lookup as k1
from scflow_tpu_torch.ops.cuda import rasterize as k2

from test_torch_kernels import _packed_scene, _raster_scene, _v4_scene
from torch_port_helpers import keep_torch_rng  # noqa: F401

OPS = ("corr_lookup", "corr_lookup_bwd", "raster_v3", "raster_v4", "raster_packed",
       "raster_v12")
SIZES = (8, 4, 2, 1)  # levels of an 8 x 8 map, 6 images


def _levels(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    levels = [torch.randn((6 * 64, s * s), generator=g).to(dtype) for s in SIZES]
    coords = (10.0 * torch.rand((6 * 64, 2), generator=g) - 1.0).contiguous()
    return levels, coords


def test_every_kernel_is_a_registered_op():
    """One op per wrapper in the scflow namespace, none mutating its inputs."""
    for name in OPS:
        schema = getattr(torch.ops.scflow, name).default._schema
        assert not any(a.alias_info is not None and a.alias_info.is_write
                       for a in schema.arguments), name
    assert "Tensor[] levels" in str(torch.ops.scflow.corr_lookup.default._schema)
    assert str(torch.ops.scflow.corr_lookup_bwd.default._schema).endswith("-> Tensor[]")


@pytest.mark.parametrize("flow_grad", [True, False])
@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", k1.VARIANTS)
def test_lookup_op_opcheck(variant, dtype, radius, flow_grad):
    levels, coords = _levels(dtype)
    levels = [m.requires_grad_() for m in levels]
    coords.requires_grad_(flow_grad)
    torch.library.opcheck(torch.ops.scflow.corr_lookup.default,
                          (levels, coords, radius, variant))


@pytest.mark.parametrize("want_coords", [True, False])
@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookup_bwd_op_opcheck(dtype, radius, want_coords):
    """K1b's op (no gradient of its own: the inputs need none)."""
    levels, coords = _levels(dtype, seed=1)
    g = torch.randn((coords.shape[0], 4 * (2 * radius + 1) ** 2),
                    generator=torch.Generator().manual_seed(2))
    torch.library.opcheck(torch.ops.scflow.corr_lookup_bwd.default,
                          (levels, coords, g, radius, want_coords))
    out = torch.ops.scflow.corr_lookup_bwd(levels, coords, g, radius, want_coords)
    assert len(out) == 4 + want_coords
    assert [t.dtype for t in out[:4]] == [dtype] * 4


def _raster_args(op):
    cpu = torch.device("cpu")
    if op in ("raster_v3", "raster_v12_1", "raster_v12_2"):
        rows, active, img = _raster_scene(cpu, n=1)
        bits = pk.id_bits_for(rows.shape[-1])
        if op == "raster_v3":
            return torch.ops.scflow.raster_v3.default, (rows, active, img, img, bits)
        return torch.ops.scflow.raster_v12.default, (rows, active, img, img, 8, 128, 128, bits,
                                                     int(op[-1]))
    if op == "raster_packed":
        rows, active, kw = _packed_scene(cpu, 128, 128)
        return torch.ops.scflow.raster_packed.default, (rows, active, *kw.values())
    packs, kw = _v4_scene(cpu, 8)
    return torch.ops.scflow.raster_v4.default, (*packs, *kw.values())


@pytest.mark.parametrize("op", ["raster_v3", "raster_v4", "raster_packed", "raster_v12_1",
                                "raster_v12_2"])
def test_raster_op_opcheck(op):
    torch.library.opcheck(*_raster_args(op))


def test_lookup_gradcheck_float64():
    """The op's registered backward (K1b's plain version) against finite
    differences, centres away from the tent's kinks."""
    g = torch.Generator().manual_seed(3)
    levels = [torch.randn((5, s * s), generator=g, dtype=torch.float64).requires_grad_()
              for s in (6, 3, 2)]
    coords = (torch.randint(0, 5, (5, 2), generator=g) + 0.25
              + 0.5 * torch.rand((5, 2), generator=g)).double().requires_grad_()
    for variant in k1.VARIANTS:
        assert torch.autograd.gradcheck(
            lambda c, *lv: k1.corr_lookup_flat(list(lv), c, 2, variant), (coords, *levels))


def test_lookup_backward_asks_for_the_flow_grad_only_when_needed(monkeypatch):
    """corr_lookup's autograd asks K1b for the coords' gradient only where
    the coords need one (the decoders detach the flow)."""
    asked = []
    bwd = k1.corr_lookup_flat_bwd

    def record(levels, coords, grad, radius, want_coords):
        asked.append(want_coords)
        return bwd(levels, coords, grad, radius, want_coords)

    monkeypatch.setattr(k1, "corr_lookup_flat_bwd", record)
    levels, coords = _levels(torch.float32)
    for flow_grad in (False, True):
        lv = [m.clone().requires_grad_() for m in levels]
        c = coords.clone().requires_grad_(flow_grad)
        k1.corr_lookup_flat(lv, c, 4).sum().backward()
        assert (c.grad is not None) == flow_grad
    assert asked == [False, True]


def test_kernel_lookup_route_equals_the_plain_pairing():
    """ops/corr.py's 'pallas' lookup (the op and its autograd) against the
    plain forward and K1b's plain backward, on a (N, h, w, 2) flow."""
    g = torch.Generator().manual_seed(4)
    feat = torch.randn((2, 8, 8, 16), generator=g)
    pyramid = corr.correlation_pyramid_flat(feat, feat.flip(0))
    flow = (2.0 * torch.randn((2, 8, 8, 2), generator=g)).requires_grad_()
    levels = [m.detach().requires_grad_() for m in pyramid]
    out = corr.corr_lookup(levels, flow, 4, backend="pallas")
    coords = (coords_grid(8, 8, flow.dtype, flow.device)[None] + flow).reshape(-1, 2)
    want = k1.corr_lookup_flat_plain([m.detach() for m in levels], coords.detach())
    assert torch.equal(out.reshape(-1, out.shape[-1]), want)
    grad = torch.randn(out.shape, generator=g)
    out.backward(grad)
    wg, wc = k1.corr_lookup_flat_bwd_plain([m.detach() for m in levels], coords.detach(),
                                           grad.reshape(want.shape))
    assert all(torch.equal(m.grad, w) for m, w in zip(levels, wg))
    assert torch.equal(flow.grad.reshape(-1, 2), wc)


def test_fake_bodies_on_cuda_tensors():
    """Under FakeTensorMode (CUDA tensors without a card) each op's fake
    gives its kernel's output shapes and dtypes (K1's float32 on bf16
    levels, K1b's level grads in the levels' dtype) and runs the launch's
    checks that need no data (K3 refuses a 3-D overflow list)."""
    with FakeTensorMode():
        lv = [torch.empty((10, s * s), device="cuda", dtype=torch.bfloat16) for s in SIZES]
        c = torch.empty((10, 2), device="cuda")
        out = torch.ops.scflow.corr_lookup(lv, c, 4, "tent")
        assert (out.shape, out.dtype, out.device.type) == ((10, 324), torch.float32, "cuda")
        g = torch.empty((10, 324), device="cuda")
        grads = torch.ops.scflow.corr_lookup_bwd(lv, c, g, 4, True)
        assert [(tuple(t.shape), t.dtype) for t in grads] == (
            [((10, s * s), torch.bfloat16) for s in SIZES] + [((10, 2), torch.float32)])
        wide = torch.ops.scflow.corr_lookup(lv, c, 13, "shift")  # K7's generic route
        assert (wide.shape, wide.dtype) == ((10, len(SIZES) * 27 * 27), torch.float32)
        five = torch.ops.scflow.corr_lookup(lv + lv[:1], c, 3, "tent")  # two launches
        assert five.shape == (10, (len(SIZES) + 1) * 49)
        with pytest.raises(ValueError, match="radius"):
            torch.ops.scflow.corr_lookup(lv, c, -1, "tent")
        with pytest.raises(ValueError, match=r"\(10, S\*S\)"):
            torch.ops.scflow.corr_lookup([torch.empty((10, 63), device="cuda")] * 4, c, 3,
                                         "tent")
        with pytest.raises(ValueError, match="float32 coords"):
            torch.ops.scflow.corr_lookup(lv, torch.empty((10, 2), device="cuda",
                                                         dtype=torch.float64), 3, "tent")
        with pytest.raises(ValueError, match="grad_out"):
            torch.ops.scflow.corr_lookup_bwd(lv, c, torch.empty((10, 100), device="cuda"), 4,
                                             False)
        rows = torch.empty((2, 32, 256), device="cuda")
        act = torch.empty((2, 16, 1, 2), dtype=torch.int32, device="cuda")
        assert torch.ops.scflow.raster_v3(rows, act, 128, 128, 8).shape == (2, 16, 128, 128)
        with pytest.raises(ValueError, match="int32"):
            torch.ops.scflow.raster_v3(rows, torch.empty(act.shape, device="cuda"), 128, 128,
                                       8)
        keys = torch.ops.scflow.raster_packed(torch.empty((2, 16, 256), device="cuda"), act,
                                              128, 128, 8, 128, 128, 8)
        assert (keys.shape, keys.dtype) == ((2, 128, 128), torch.int32)
        with pytest.raises(ValueError, match="tiles must divide"):
            torch.ops.scflow.raster_v12(rows, act, 128, 128, 7, 128, 128, 8, 2)
        with pytest.raises(ValueError, match="version"):
            torch.ops.scflow.raster_v12(rows, act, 128, 128, 8, 128, 128, 8, 3)
        tiles = torch.empty((2, 16, 1), dtype=torch.int32, device="cuda")
        ov = torch.empty((2, 16, 1, 3), dtype=torch.int32, device="cuda")
        maps = torch.ops.scflow.raster_v4(rows, tiles, tiles, tiles, ov, 128, 128, 8, 128, 128,
                                          14)
        assert maps.shape == (2, 16, 128, 128)
        with pytest.raises(ValueError, match="ov_order"):  # a 3-D list, as the launch
            torch.ops.scflow.raster_v4(rows, tiles, tiles, tiles, tiles, 128, 128, 8, 128, 128,
                                       14)


def test_public_wrappers_keep_their_signatures():
    """The wrappers call the ops: their CPU results equal the ops' and the
    plain versions'."""
    levels, coords = _levels(torch.float32)
    assert torch.equal(k1.corr_lookup_flat(levels, coords, 3, "shift"),
                       torch.ops.scflow.corr_lookup(levels, coords, 3, "shift"))
    g = torch.randn((coords.shape[0], 4 * 49), generator=torch.Generator().manual_seed(5))
    grads, gc = k1.corr_lookup_flat_bwd(levels, coords, g, 3, want_coords=False)
    assert gc is None and len(grads) == 4
    rows, active, img = _raster_scene(torch.device("cpu"), n=1)
    bits = pk.id_bits_for(rows.shape[-1])
    for version in (1, 2):
        assert torch.equal(
            k2.rasterize_shaded(rows, active, img, img, id_bits=bits, version=version),
            torch.ops.scflow.raster_v12(rows, active, img, img, 8, 128, 128, bits, version))
    with pytest.raises(ValueError, match="version"):
        k2.rasterize_shaded(rows, active, img, img, id_bits=bits, version=3)
