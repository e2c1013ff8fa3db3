"""The RAFT decoder's and refiners' options against the JAX package on the
same numpy-seeded inputs and weights (flax variables carried across by
convert.state_dict_from_flax), at 64^2, batch 2, 2-3 iterations: the
'Small' net (no up-mask head: bilinear upsampling), the Conv GRU and fused
gates, radius 2/3/5, 3 levels (a 4x upsampling) with and without convex
upsampling, feat_channels and mask_channels; RAFT-S, the RAFT paper's small
model that chip_smoke.py runs on the card, as a whole (forward, gradients
from PyTorch's initialisation, and a 256x192 crop, whose maps are not
square); and the entry points on RAFT-S and the SCFlow option set.

Bounds: the flow within 1e-4 px + 1e-4 of its scale and the occlusion
within 1e-5 (tests/test_torch_raft_model.py's); gradients per leaf within
relative L2 2e-2 (tests/test_torch_train.py's bound, from PyTorch's
initialisation).  Each combination the JAX package cannot run raises in
the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_tpu.models.raft_decoder import RAFTDecoder as FDecoder
from scflow_tpu.refiners import raft as jraft
from scflow_tpu_torch.convert import state_dict_from_flax
from scflow_tpu_torch.models.raft_decoder import RAFTDecoder
from scflow_tpu_torch.refiners import raft

from torch_port_helpers import (flax_from_port, keep_torch_rng, lecun_variables,  # noqa: F401
                                load_port, no_tf32)

N, IMG = 2, 64
# RAFT-S (Teed & Deng, RAFT, ECCV 2020): chip_smoke.py's raft_small model
RAFT_S = dict(net_type="Small", h_channels=96, cxt_channels=64, encoder_out_channels=128,
              encoder_norm="IN", cxt_norm=None, num_levels=4, radius=3, gru_type="Conv")


def _close(got, want, what=""):
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k].float().numpy()
        assert g.shape == w.shape, (what, k)
        atol = 1e-4 + 1e-4 * np.abs(w).max() if k == "flow" else 1e-5
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"{what} {k}")


@pytest.mark.parametrize("kw", [
    dict(net_type="Small", radius=3, gru_type="Conv"),
    dict(radius=2, convex_upsample_flow=False, gru_fuse_gates=True),
    dict(radius=5, convex_upsample_flow=False, gru_type="Conv", gru_fuse_gates=True,
         feat_channels=96),
    dict(net_type="Small", num_levels=3),
    dict(num_levels=3, mask_channels=16)])
def test_decoder_options(kw, no_tf32):
    """RAFTDecoderMask alone on random features and a nonzero warm start, 2
    iterations; 3 levels upsample 4x (to H/2 here), with convex weights
    where mask_channels (2r+1) = 9 x 4^2."""
    net = kw.get("net_type", "Basic")
    h, hc, cc = IMG // 8, {"Basic": 128, "Small": 96}[net], {"Basic": 128, "Small": 64}[net]
    rng = np.random.default_rng(len(str(kw)))
    f1, f2 = (rng.normal(size=(N, h, h, 64)).astype(np.float32) for _ in range(2))
    flow = rng.normal(size=(N, h, h, 2)).astype(np.float32)
    hf = np.tanh(rng.normal(size=(N, h, h, hc))).astype(np.float32)
    cf = np.maximum(rng.normal(size=(N, h, h, cc)), 0).astype(np.float32)
    fdec = FDecoder(iters=2, predict_occlusion=True, **kw)
    args = tuple(map(jnp.asarray, (f1, f2, flow, hf, cf)))
    variables = lecun_variables(fdec, 2, *args)
    want = {k: np.asarray(v) for k, v in jax.jit(fdec.apply)(variables, *args).items()}
    with torch.random.fork_rng(devices=[]):
        port = load_port(RAFTDecoder(iters=2, predict_occlusion=True, **kw), variables)
    nchw = [torch.from_numpy(a).permute(0, 3, 1, 2) for a in (f1, f2)]
    with torch.no_grad():
        got = port(*nchw, torch.from_numpy(flow), torch.from_numpy(hf).permute(0, 3, 1, 2),
                   torch.from_numpy(cf).permute(0, 3, 1, 2), lookup_backend="pallas")
    scale = 2 ** (kw.get("num_levels", 4) - 1)
    assert got["flow"].shape == (2, N, h * scale, h * scale, 2)
    assert hasattr(port, "mask_pred") == (net == "Basic" and kw.get("convex_upsample_flow", True))
    _close(got, want, str(kw))


@pytest.mark.parametrize("kw", [dict(radius=3), dict(num_levels=3), dict(mask_channels=32)])
def test_decoder_rejects_convex_masks_that_do_not_reshape(kw):
    """Convex upsampling reshapes the mask head's mask_channels (2r+1)
    channels to 9 scale^2: JAX fails there (a reshape error), the port
    raises at construction."""
    h = IMG // 8
    args = (jnp.zeros((1, h, h, 64)),) * 2 + (jnp.zeros((1, h, h, 2)), jnp.zeros((1, h, h, 128)),
                                             jnp.zeros((1, h, h, 128)))
    fdec = FDecoder(iters=1, **kw)
    with pytest.raises(TypeError, match="reshape"):
        jax.eval_shape(fdec.init, jax.random.PRNGKey(0), *args)
    with pytest.raises(ValueError, match="convex"):
        RAFTDecoder(iters=1, **kw)


def _raft_s_pair(iters, seed, img=IMG, mask=True):
    name = "RAFTRefinerFlowMask" if mask else "RAFTRefinerFlow"
    fmodel = getattr(jraft, name)(iters=iters, **RAFT_S)
    z = jnp.zeros((1, img, img, 3))
    variables = lecun_variables(fmodel, seed, z, z)
    with torch.random.fork_rng(devices=[]):
        port = getattr(raft, name)(iters=iters, **RAFT_S)
    return fmodel, variables, load_port(port, variables, encoder_norm="IN", cxt_norm=None)


def _jax_apply(fmodel, variables, render, real):
    f = jax.jit(lambda v, a, b: fmodel.apply(v, a, b, lookup_backend="xla"))
    return {k: np.asarray(v, np.float32) for k, v in
            f(variables, jnp.asarray(render), jnp.asarray(real)).items()}


def test_raft_small_forward(no_tf32):
    """RAFT-S as a whole, 3 iterations: Bottleneck encoders (IN, and a
    context encoder without norm), radius 3, the Conv GRU, bilinear
    upsampling of flow and occlusion."""
    fmodel, variables, port = _raft_s_pair(3, 20)
    assert not any(k.startswith("decoder.mask_pred") for k in port.state_dict())
    rng = np.random.default_rng(21)
    render, real = (rng.normal(size=(N, IMG, IMG, 3)).astype(np.float32) for _ in range(2))
    want = _jax_apply(fmodel, variables, render, real)
    with torch.no_grad():
        got = port(torch.from_numpy(render), torch.from_numpy(real), lookup_backend="pallas")
    assert np.abs(want["flow"]).max() > 0.1  # the flow moved
    _close(got, want, "RAFT-S")


def test_raft_small_bf16_matches_jax_bf16(monkeypatch, no_tf32):
    """RAFT-S at dtype=bfloat16 (chip_smoke.py's raft_small bf16 call) against
    flax at bfloat16 on the same weights, 3 iterations, lookup 'pallas' on
    both sides (the port's K1 bf16 plain version; JAX's kernel in interpret
    mode).  The bound is JAX's own bf16-to-fp32 distance d on the same
    inputs: the port's bf16 flow and occlusion each within 2 d plus the
    fp32 bound of JAX's bf16 output.  The port's own bf16-to-fp32 distance
    is d's size too (within 3 d), so a large bf16 distance on the card
    is the network's, not the port's."""
    from test_torch_train import _interpret_lookup

    _interpret_lookup(monkeypatch)
    fmodel, variables, port = _raft_s_pair(3, 20)
    with torch.random.fork_rng(devices=[]):
        port16 = raft.RAFTRefinerFlowMask(iters=3, dtype=torch.bfloat16, **RAFT_S)
    port16.load_state_dict(port.state_dict(), strict=True)
    port16.eval()
    rng = np.random.default_rng(21)
    render, real = (rng.normal(size=(N, IMG, IMG, 3)).astype(np.float32) for _ in range(2))
    args = (jnp.asarray(render), jnp.asarray(real))
    j32, j16 = (jax.jit(lambda v, a, b, m=m: m.apply(v, a, b, lookup_backend="pallas"))(
        variables, *args) for m in (fmodel, fmodel.clone(dtype=jnp.bfloat16)))
    with torch.no_grad():
        t32, t16 = (m(torch.from_numpy(render), torch.from_numpy(real), lookup_backend="pallas")
                    for m in (port, port16))
    # bilinear upsampling promotes to float32 in both packages
    assert {k: str(v.dtype) for k, v in t16.items()} == {
        k: "torch." + str(v.dtype) for k, v in j16.items()} == {
        "flow": "torch.float32", "occlusion": "torch.float32"}
    j32, j16, t32, t16 = ({k: np.asarray(v, np.float32) for k, v in o.items()}
                          for o in (j32, j16, t32, t16))
    for k in ("flow", "occlusion"):
        dist = np.abs(j16[k] - j32[k]).max()
        assert dist > 0  # bf16 moved JAX's output
        bound = 1e-4 + 1e-4 * np.abs(j16[k]).max() if k == "flow" else 1e-5
        err = np.abs(t16[k] - j16[k]).max()
        assert err <= 2 * dist + bound, (k, err, dist)
        assert np.abs(t16[k] - t32[k]).max() <= 3 * dist, k


def test_raft_small_non_square_crop(no_tf32):
    """RAFT-S on a 256x192 crop: 32x24 maps, which JAX's lookup dispatch
    sends to its 4-D pyramid and XLA lookup, as the port's does, with the
    'pallas' backend asked for on both sides."""
    fmodel, variables, port = _raft_s_pair(2, 22, mask=False)
    rng = np.random.default_rng(23)
    render, real = (rng.normal(size=(1, 256, 192, 3)).astype(np.float32) for _ in range(2))
    f = jax.jit(lambda v, a, b: fmodel.apply(v, a, b, lookup_backend="pallas"))
    want = {k: np.asarray(v) for k, v in f(variables, jnp.asarray(render),
                                            jnp.asarray(real)).items()}
    with torch.no_grad():
        got = port(torch.from_numpy(render), torch.from_numpy(real), lookup_backend="pallas")
    assert got["flow"].shape == (2, 1, 256, 192, 2)
    _close(got, want, "256x192")


def test_raft_small_gradients(no_tf32):
    """Gradients of every RAFT-S parameter through a training forward (the
    sequence-weighted L1 of flow and occlusion), from PyTorch's
    initialisation carried to flax by the weight bridge's mapping, per leaf
    within relative L2 2e-2, skipping leaves below 1e-5 of the global norm.
    The yardstick is JAX's network in float64 (`jax.enable_x64`), as in
    tests/test_torch_raft_train.py: on these weights JAX's float32
    feature-encoder gradients sit 1.6e-2 from its float64 ones, the port's
    float32 ones within 1.1e-5 of a float64 run of the port."""
    fmodel, template, _ = _raft_s_pair(2, 24)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(24)
        port = raft.RAFTRefinerFlowMask(iters=2, **RAFT_S)
    variables = flax_from_port(template, port.state_dict(), encoder_norm="IN", cxt_norm=None)
    rng = np.random.default_rng(25)
    render, real = (rng.uniform(0, 1, (N, IMG, IMG, 3)).astype(np.float32) for _ in range(2))
    gt = rng.normal(size=(N, IMG, IMG, 2)).astype(np.float32)

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
                                encoder_norm="IN", cxt_norm=None)  # rounded to float32
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


@pytest.fixture(scope="module")
def cpu_bank():
    from scflow_tpu_torch.refiners.system import RenderAssets, loss_assets_from_bank
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    bank = make_synthetic_bank(3)
    return (RenderAssets.from_bank(bank, device="cpu"),
            loss_assets_from_bank(bank, {"cls_2": {"z": 0}}, device="cpu"))


def _batch(n=N, img=IMG):
    rng = np.random.default_rng(26)
    R = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    t = np.tile(np.array([[0.0, 0.0, 400.0]], np.float32), (n, 1))
    K = np.tile(np.array([[[120.0, 0, img / 2], [0, 120.0, img / 2], [0, 0, 1]]], np.float32),
                (n, 1, 1))
    return dict(real_images=rng.normal(size=(n, img, img, 3)).astype(np.float32),
                ref_rotations=R, ref_translations=t, gt_rotations=R,
                gt_translations=t + np.float32(3.0), labels=np.arange(n) % 3, k=K,
                gt_masks=np.ones((n, img, img), np.float32))


def test_entry_points_run_raft_small(cpu_bank):
    """make_raft_infer_fn (device PnP), make_raft_val_step and
    make_raft_train_step run RAFT-S on the kernels' plain versions: finite
    outputs of the right shapes, a finite loss."""
    from scflow_tpu_torch.refiners.system import (make_raft_infer_fn, make_raft_train_step,
                                                  make_raft_val_step)
    from scflow_tpu_torch.runtime.optim import build_optimizer
    from scflow_tpu_torch.runtime.train_state import TrainState

    assets, _ = cpu_bank
    with torch.random.fork_rng(devices=[]):
        model = raft.RAFTRefinerFlowMask(iters=2, **RAFT_S)
    kw = dict(image_size=(IMG, IMG), lookup_backend="pallas", device="cpu")
    out = make_raft_infer_fn(model, assets, pnp_backend="device",
                             pnp_cfg=dict(num_points=64, num_hypotheses=8), **kw)(_batch())
    assert out["flow"].shape == (N, IMG, IMG, 2) and torch.isfinite(out["flow"]).all()
    assert out["rotations"].shape == (N, 3, 3)
    metrics = make_raft_val_step(model, assets, **kw)(_batch())
    assert all(np.isfinite(v.item()) for v in metrics.values())
    tx, _ = build_optimizer(model.parameters(), dict(type="AdamW", lr=4e-4), None, grad_clip=1.0)
    _, logs = make_raft_train_step(model, assets, **kw)(TrainState(model, tx), _batch())
    assert np.isfinite(float(logs["loss"])) and float(logs["grad_norm"]) > 0


def test_entry_points_run_the_scflow_option_set(cpu_bank):
    """make_scflow_infer_fn (slim and full) and make_scflow_train_step run
    the SCFlow option set (test_torch_options_scflow.OPTION_SET) on the
    kernels' plain versions."""
    from scflow_tpu_torch.refiners.scflow import SCFlowRefiner
    from scflow_tpu_torch.refiners.system import make_scflow_infer_fn, make_scflow_train_step
    from scflow_tpu_torch.runtime.optim import build_optimizer
    from scflow_tpu_torch.runtime.train_state import TrainState
    from test_torch_options_scflow import OPTION_SET

    assets, loss_assets = cpu_bank
    with torch.random.fork_rng(devices=[]):
        model = SCFlowRefiner(num_class=3, image_size=(IMG, IMG), iters=2, **OPTION_SET)
    kw = dict(image_size=(IMG, IMG), lookup_backend="pallas", device="cpu")
    for slim in (True, False):
        out = make_scflow_infer_fn(model, assets, slim=slim, **kw)(_batch())
        R = out["rotations"]
        assert torch.allclose(R.transpose(1, 2) @ R, torch.eye(3).expand(N, 3, 3), atol=1e-5)
        assert ("flow" in out) == (not slim)
    tx, _ = build_optimizer(model.parameters(), dict(type="AdamW", lr=4e-4), None, grad_clip=10.0)
    _, logs = make_scflow_train_step(model, assets, loss_assets, **kw)(TrainState(model, tx),
                                                                        _batch())
    assert np.isfinite(float(logs["loss"])) and float(logs["grad_norm"]) > 0


@pytest.mark.parametrize("variant,radius,levels", [("shift", 13, 4), ("bdiag", 13, 4),
                                                   ("tent", 16, 4)])
def test_entry_points_reject_a_window_the_kernels_do_not_build(variant, radius, levels,
                                                              cpu_bank):
    """An entry point built on a model whose radius is past the variant's
    pipeline instances (K7/K8 0-12, K1 0-15: the generic route takes it)
    builds on the kernels' backend and its call (the variant's plain
    version on the CPU) gives the tensor backend's flow and occlusion
    (tests/test_torch_raft_model.py's bounds)."""
    from scflow_tpu_torch.refiners.system import make_raft_infer_fn

    assets, _ = cpu_bank
    with torch.random.fork_rng(devices=[]):
        model = raft.RAFTRefinerFlowMask(iters=1, convex_upsample_flow=False, radius=radius,
                                         num_levels=levels)
    batch = _batch()
    got, want = (make_raft_infer_fn(model, assets, image_size=(IMG, IMG), lookup_backend=b,
                                    lookup_variant=v, device="cpu")(batch)
                 for b, v in (("pallas", variant), ("xla", "tent")))
    _close({k: got[k] for k in ("flow", "occlusion")},
           {k: want[k].numpy() for k in ("flow", "occlusion")}, f"{variant} radius {radius}")
