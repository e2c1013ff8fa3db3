"""The lookup at the windows past the first K1's, against the JAX package:
the plain versions of K1 (tent), K7 (shift), K8 (bdiag) and K1b (what a
CPU tensor runs, and what the card holds each kernel route to) at 5 and 6
levels and at radius 16 and 24, and a 5-level RAFT as a whole.

The forward is held to JAX's Pallas kernels in interpret mode
(`corr_lookup_pallas`, each variant), the backward to `_lookup_bwd` (the
XLA backward of `corr_lookup_pallas_diff`), atol 1e-4 as
tests/test_torch_corr.py: the sums run in another order.  On bfloat16
levels the Pallas kernels read `m_ref[...].astype(float32)`, so their
output on bf16 levels is their output on those levels upcast (checked once
below, then used so that no second interpret compile runs).

A 5-level RAFT (RAFTRefinerFlowMask(num_levels=5,
convex_upsample_flow=False): JAX's module runs it only without convex
upsampling, and upsamples the 1/8 flow 16x, to twice the image) at 128^2,
features 16^2, levels 16..1, 2 iterations: the forward against JAX's
network, the gradients against JAX's in float64 (as
tests/test_torch_options_raft.py), and make_raft_infer_fn on 'pallas'."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_tpu.ops.pallas.corr_lookup import _lookup_bwd, corr_lookup_pallas
from scflow_tpu.refiners import raft as jraft
from scflow_tpu_torch.convert import state_dict_from_flax
from scflow_tpu_torch.ops.corr import corr_lookup
from scflow_tpu_torch.refiners import raft

from torch_port_helpers import (flax_from_port, keep_torch_rng, lecun_variables,  # noqa: F401
                                load_port, no_tf32)

ATOL = 1e-4
# (levels, radius): more than four levels, radii past the pipeline
WINDOWS = {(5, 4): (16, 8, 4, 2, 1), (6, 3): (32, 16, 8, 4, 2, 1), (4, 16): (32, 16, 8, 4),
           (2, 24): (32, 16)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(levels, radius, dtype):
    """2 x 8^2 rows of level maps of the window's sizes, centres spread over
    level 0 and past its borders by more than the radius."""
    sizes = WINDOWS[(levels, radius)]
    rng = np.random.default_rng(levels * 100 + radius)
    n, h = 2, 8
    maps = [rng.normal(size=(n * h * h, s * s)).astype(np.float32) for s in sizes]
    maps = [torch.from_numpy(m).to(DTYPES[dtype]).float().numpy() for m in maps]  # the cells
    centres = rng.uniform(-radius - 2, sizes[0] + radius + 2, (n, h, h, 2))
    centres[0, 0, :4] = np.floor(centres[0, 0, :4])  # integer centres: the kinks
    gy, gx = np.meshgrid(np.arange(h), np.arange(h), indexing="ij")
    flow = (centres - np.stack([gx, gy], -1)[None]).astype(np.float32)
    return maps, flow


def _port_levels(maps, dtype):
    return [torch.from_numpy(m).to(DTYPES[dtype]) for m in maps]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["tent", "shift", "bdiag"])
@pytest.mark.parametrize("levels,radius", list(WINDOWS))
def test_plain_lookups_match_pallas_kernels(levels, radius, variant, dtype, no_tf32):
    """K1's, K7's and K8's plain versions against the TPU kernel of the same
    variant in interpret mode, on float32 and on bfloat16 levels."""
    maps, flow = _case(levels, radius, dtype)
    want = np.asarray(corr_lookup_pallas([jnp.asarray(m) for m in maps], jnp.asarray(flow),
                                         radius=radius, interpret=True, variant=variant))
    got = corr_lookup(_port_levels(maps, dtype), torch.from_numpy(flow), radius=radius,
                      backend="pallas", variant=variant)
    k = 2 * radius + 1
    assert got.dtype == torch.float32 and got.shape == flow.shape[:3] + (levels * k * k,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_pallas_kernel_reads_bf16_levels_as_their_upcast():
    """The premise of the bf16 cases above: JAX's tent kernel on bf16 levels
    gives its output on the same levels upcast, bit for bit."""
    maps, flow = _case(5, 4, "bfloat16")
    kw = dict(radius=4, interpret=True, variant="tent")
    on_bf16 = corr_lookup_pallas([jnp.asarray(m, jnp.bfloat16) for m in maps],
                                 jnp.asarray(flow), **kw)
    on_f32 = corr_lookup_pallas([jnp.asarray(m) for m in maps], jnp.asarray(flow), **kw)
    assert np.array_equal(np.asarray(on_bf16), np.asarray(on_f32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("levels,radius", list(WINDOWS))
def test_plain_bwd_matches_lookup_bwd(levels, radius, dtype):
    """K1b's plain version (the 'pallas' lookup's autograd on the CPU)
    against `_lookup_bwd`: the level grads (bf16 levels: in bf16, each
    rounded once from its float32 sum, within one bf16 ulp) and the flow
    grad, atol 1e-4."""
    maps, flow = _case(levels, radius, dtype)
    k = 2 * radius + 1
    g = np.random.default_rng(radius).normal(size=flow.shape[:3] + (levels * k * k,))
    g = g.astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    bwd = jax.jit(functools.partial(_lookup_bwd, radius, 256, True, "tent"))
    gp_j, gf_j = bwd((tuple(jnp.asarray(m, jdt) for m in maps), jnp.asarray(flow)),
                     jnp.asarray(g))
    lv = [m.requires_grad_() for m in _port_levels(maps, dtype)]
    fl = torch.from_numpy(flow).requires_grad_()
    corr_lookup(lv, fl, radius=radius, backend="pallas").backward(torch.from_numpy(g))
    for m, w in zip(lv, gp_j):
        assert m.grad.dtype == DTYPES[dtype]
        a, b = m.grad.float().numpy(), np.asarray(w, np.float32)
        tol = ATOL if dtype == "float32" else ATOL + np.abs(b) * 2.0 ** -7
        assert np.all(np.abs(a - b) <= tol)
    np.testing.assert_allclose(fl.grad.numpy(), np.asarray(gf_j), rtol=0, atol=ATOL)


# the 5-level RAFT: the shipped raft.py's network (Basic, 256-channel
# encoders, SeqConv GRU) with 5 levels, and RAFT-S at 5 levels for the
# gradients (JAX's float64 step at the Basic widths would take minutes)
N, IMG, ITERS = 1, 128, 2
FIVE = dict(num_levels=5, convex_upsample_flow=False)
RAFT_S = dict(net_type="Small", h_channels=96, cxt_channels=64, encoder_out_channels=128,
              encoder_norm="IN", cxt_norm=None, radius=3, gru_type="Conv", **FIVE)


def test_five_level_raft_forward(no_tf32):
    """The port's 5-level RAFT on 'pallas' (K1's plain version at 5 levels)
    against JAX's network: the flow (16x the 1/8 maps: 256^2 from 128^2)
    within 1e-4 px + 1e-4 of its scale, the occlusion within 1e-5."""
    fmodel = jraft.RAFTRefinerFlowMask(iters=ITERS, **FIVE)
    z = jnp.zeros((1, IMG, IMG, 3))
    variables = lecun_variables(fmodel, 30, z, z)
    with torch.random.fork_rng(devices=[]):
        port = load_port(raft.RAFTRefinerFlowMask(iters=ITERS, **FIVE), variables)
    rng = np.random.default_rng(31)
    render, real = (rng.normal(size=(N, IMG, IMG, 3)).astype(np.float32) for _ in range(2))
    f = jax.jit(lambda v, a, b: fmodel.apply(v, a, b, lookup_backend="xla"))
    want = {k: np.asarray(v) for k, v in f(variables, jnp.asarray(render),
                                            jnp.asarray(real)).items()}
    with torch.no_grad():
        got = port(torch.from_numpy(render), torch.from_numpy(real), lookup_backend="pallas")
    assert got["flow"].shape == (ITERS, N, 2 * IMG, 2 * IMG, 2)
    assert np.abs(want["flow"]).max() > 0.1
    for key, w in want.items():
        atol = 1e-4 + 1e-4 * np.abs(w).max() if key == "flow" else 1e-5
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=atol, err_msg=key)


def test_five_level_raft_gradients(no_tf32):
    """Gradients of every parameter of a 5-level RAFT-S through a training
    forward on 'pallas' (K1b's plain version at 5 levels; the
    sequence-weighted L1 of flow and occlusion at the flow's size), from
    PyTorch's initialisation, against JAX's network in float64 on 'xla':
    the loss rtol 2e-4, per leaf within relative L2 2e-2, skipping leaves
    below 1e-5 of the global norm (tests/test_torch_options_raft.py's
    bounds)."""
    fmodel = jraft.RAFTRefinerFlowMask(iters=ITERS, **RAFT_S)
    z = jnp.zeros((1, IMG, IMG, 3))
    template = lecun_variables(fmodel, 32, z, z)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(32)
        port = raft.RAFTRefinerFlowMask(iters=ITERS, **RAFT_S)
    variables = flax_from_port(template, port.state_dict(), encoder_norm="IN", cxt_norm=None)
    rng = np.random.default_rng(33)
    render, real = (rng.uniform(0, 1, (N, IMG, IMG, 3)).astype(np.float32) for _ in range(2))
    gt = rng.normal(size=(N, 2 * IMG, 2 * IMG, 2)).astype(np.float32)

    def loss_of(out, gt_flow):
        T = out["flow"].shape[0]
        return sum(0.8 ** (T - 1 - i) * (abs(out["flow"][i] - gt_flow).mean()
                                         + abs(out["occlusion"][i] - 0.5).mean())
                   for i in range(T))

    def jax_loss(params):
        out = fmodel.apply({"params": params}, jnp.asarray(render, jnp.float64),
                           jnp.asarray(real, jnp.float64), train=True, lookup_backend="xla")
        return loss_of(out, jnp.asarray(gt, jnp.float64))

    params64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables["params"])
    with jax.enable_x64(True):
        want_loss, jgrads = jax.jit(jax.value_and_grad(jax_loss))(params64)
    want = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, jgrads)},
                                encoder_norm="IN", cxt_norm=None)
    port.train()
    loss = loss_of(port(torch.from_numpy(render), torch.from_numpy(real), train=True,
                        lookup_backend="pallas"), torch.from_numpy(gt))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-4)
    got = {k: p.grad for k, p in port.named_parameters()}
    assert set(got) == set(want)
    gn = np.sqrt(sum(float((v.double() ** 2).sum()) for v in want.values()))
    worst = 0.0
    for k, w in want.items():
        w, g = w.double(), got[k].double()
        if float(w.norm()) < 1e-5 * gn:
            assert float(g.norm()) < 1e-3 * gn, k
            continue
        worst = max(worst, float((g - w).norm() / w.norm()))
    assert worst <= 2e-2, worst


def test_make_raft_infer_fn_builds_at_five_levels():
    """make_raft_infer_fn on 'pallas' takes a 5-level model (check_window
    refuses no window) and runs it with the config's default host PnP,
    which reads the flow at the rendered pixels as JAX's host solve does;
    the shipped convex upsampling at 5 levels raises at construction, where
    JAX fails its reshape."""
    from scflow_tpu_torch.refiners.system import RenderAssets, make_raft_infer_fn
    from scflow_tpu_torch.refiners.flow_pose import solve_poses_from_flow
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    with pytest.raises(ValueError, match="convex"):
        raft.RAFTRefinerFlowMask(iters=1, num_levels=5)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(34)
        model = raft.RAFTRefinerFlowMask(iters=1, **RAFT_S)
    assets = RenderAssets.from_bank(make_synthetic_bank(3), device="cpu")
    infer = make_raft_infer_fn(model, assets, image_size=(IMG, IMG), lookup_backend="pallas",
                               device="cpu")
    batch = {"real_images": np.random.default_rng(35).random((2, IMG, IMG, 3), np.float32),
             "ref_rotations": np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)),
             "ref_translations": np.array([[0.0, 0.0, 400.0]] * 2, np.float32),
             "labels": np.array([0, 1]),
             "k": np.tile(np.array([[150.0, 0, 64], [0, 150.0, 64], [0, 0, 1]], np.float32),
                          (2, 1, 1))}
    out = infer(batch)
    assert out["flow"].shape == (2, 2 * IMG, 2 * IMG, 2) and bool(torch.isfinite(out["flow"]).all())
    R, t, ok = solve_poses_from_flow(torch.zeros_like(out["flow"]), out["rendered_depths"],
                                     batch["ref_rotations"], batch["ref_translations"],
                                     batch["k"])
    assert ok.all()
    np.testing.assert_allclose(R, batch["ref_rotations"], atol=1e-4)
    np.testing.assert_allclose(t, batch["ref_translations"], atol=1e-2)
