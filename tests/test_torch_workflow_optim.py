"""The port's optimizers (runtime/optim.py::build_optimizer) against the JAX
package's optax chains, and the inverse of the weight bridge's key mapping
that frozen_prefixes go through (convert.flax_path).

The same SCFlowRefiner weights (64^2, 2 classes) and the same 5 numpy
gradients go through optax and through the port for AdamW (OneCycle),
Adam and SGD (constant lr, JAX's momentum 0.9), with and without a global
norm clip of 1.0 (the gradients' norm is far above it, so every step
clips) and with and without frozen_prefixes naming a feature encoder and
the pose head's trunk (AdamW each way; Adam and SGD plain, and clipped
with frozen prefixes).  Bound: every parameter within rtol 1e-6, atol 1e-7
of optax's (tests/test_torch_losses.py's AdamW bound); frozen parameters
bit-unchanged in both."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scflow_tpu.refiners import SCFlowRefiner as FlaxRefiner
from scflow_tpu.refiners.raft import RAFTRefinerFlowMask as FlaxRaft
from scflow_tpu.runtime import build_optimizer as j_build_optimizer
from scflow_tpu_torch.convert import (_leaves, flax_from_state_dict, flax_param_names,
                                      flax_path, torch_key)
from scflow_tpu_torch.refiners.raft import RAFTRefinerFlowMask
from scflow_tpu_torch.refiners.scflow import SCFlowRefiner
from scflow_tpu_torch.runtime.optim import build_optimizer

from torch_port_helpers import keep_torch_rng, lecun_variables, scflow_init_args  # noqa: F401

IMG = 64
HEAD = dict(type="MultiClassPoseHead", num_class=2)
FROZEN = ["render_encoder", "decoder/update/pose_pred/trunk"]
OPTS = {"AdamW": dict(type="AdamW", lr=4e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2),
        "Adam": dict(type="Adam", lr=1e-3, betas=(0.9, 0.99), eps=1e-8),
        "SGD": dict(type="SGD", lr=1e-3)}
ONECYCLE = dict(policy="OneCycle", max_lr=4e-4, total_steps=20, pct_start=0.2,
                anneal_strategy="linear")


@pytest.fixture(scope="module")
def template():
    fmodel = FlaxRefiner(iters=1, pose_head_cfg=HEAD)
    shapes = jax.eval_shape(fmodel.init, jax.random.PRNGKey(0), *scflow_init_args(1, IMG))
    return {"params": jax.tree_util.tree_map(lambda s: s, dict(shapes["params"]))}


def _port_model():
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        return SCFlowRefiner(num_class=2, image_size=(IMG, IMG), iters=1, pose_head_cfg=HEAD)


CASES = [(kind, clip, frozen) for clip in (None, 1.0) for frozen in (None, FROZEN)
         for kind in ("AdamW",)] + [(kind, None, None) for kind in ("Adam", "SGD")] + [
         (kind, 1.0, FROZEN) for kind in ("Adam", "SGD")]


@pytest.mark.parametrize("kind,clip,frozen", CASES,
                         ids=[f"{k}-{'clip' if c else 'noclip'}-{'frozen' if f else 'all'}"
                              for k, c, f in CASES])
def test_build_optimizer_matches_optax(template, kind, clip, frozen):
    port = _port_model()
    names = [n for n, _ in port.named_parameters()]
    rng = np.random.default_rng(7)
    grads = [{n: torch.from_numpy(rng.normal(0, 0.5, p.shape).astype(np.float32))
              for n, p in port.named_parameters()} for _ in range(5)]
    lr_cfg = ONECYCLE if kind == "AdamW" else None
    params = flax_from_state_dict(template, port.state_dict())["params"]
    start = flax_from_state_dict(template, port.state_dict())["params"]
    tx, _ = j_build_optimizer(OPTS[kind], lr_cfg, grad_clip=clip, frozen_prefixes=frozen)
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(p_j)
    update = jax.jit(tx.update)
    ttx, _ = build_optimizer(port, OPTS[kind], lr_cfg, grad_clip=clip, frozen_prefixes=frozen)
    named = dict(port.named_parameters())
    for step, g in enumerate(grads):
        g_j = jax.tree_util.tree_map(jnp.asarray, flax_from_state_dict(template, g)["params"])
        upd, state = update(g_j, state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        for n in names:
            named[n].grad = g[n].clone()
        ttx.step(step)
    got = flax_from_state_dict(template, port.state_dict())["params"]
    flat_got, flat_want, flat_start = (dict(_leaves(t)) for t in
                                       (got, jax.tree_util.tree_map(np.asarray, p_j), start))
    frozen_paths = [p for p in flat_got if frozen and "/".join(p).startswith(tuple(frozen))]
    assert bool(frozen_paths) == bool(frozen)
    for path, want in flat_want.items():
        if path in frozen_paths:
            np.testing.assert_array_equal(want, flat_start[path])
            np.testing.assert_array_equal(flat_got[path], flat_start[path])
        else:
            assert np.abs(want - flat_start[path]).max() > 0, path  # it moved
            np.testing.assert_allclose(flat_got[path], want, rtol=1e-6, atol=1e-7,
                                       err_msg="/".join(path))


def test_build_optimizer_raises_where_jax_misreads_a_field():
    """An unknown type raises KeyError in both packages; the port also
    raises where JAX runs something else silently: an lr policy other than
    OneCycle (JAX: a constant optimizer.lr), Adam/SGD with weight_decay
    (JAX: dropped), and frozen_prefixes without the refiner's names."""
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(KeyError):
        j_build_optimizer(dict(type="RMSprop"))
    with pytest.raises(KeyError):
        build_optimizer(p, dict(type="RMSprop"))
    j_build_optimizer(dict(type="AdamW"), dict(policy="step", step=[10]))  # runs, constant lr
    with pytest.raises(ValueError, match="policy"):
        build_optimizer(p, dict(type="AdamW"), dict(policy="step", step=[10]))
    for kind in ("Adam", "SGD"):
        j_build_optimizer(dict(type=kind, weight_decay=1e-4))  # runs, no decay
        with pytest.raises(ValueError, match="weight_decay"):
            build_optimizer(p, dict(type=kind, weight_decay=1e-4))
    with pytest.raises(TypeError):
        build_optimizer(p, dict(type="AdamW"), frozen_prefixes=["render_encoder"])


@pytest.mark.parametrize("which", ["scflow", "option_set", "raft", "raft_small"])
def test_flax_path_inverts_torch_key(which):
    """Every flax leaf of the refiners' trees maps to a torch key that
    flax_path maps back to the leaf, and flax_param_names names every
    parameter of the port's refiner with its flax path."""
    if which.startswith("scflow") or which == "option_set":
        kw = dict(pose_head_cfg=HEAD)
        if which == "option_set":
            kw.update(seperate_encoder=True, radius=3, mask_flow=True, mask_corr=True,
                      pose_head_cfg=dict(HEAD, rotation_mode="quaternion"))
        fmodel, args = FlaxRefiner(iters=1, **kw), scflow_init_args(1, IMG)
        with torch.random.fork_rng(devices=[]):
            port = SCFlowRefiner(num_class=2, image_size=(IMG, IMG), iters=1, **kw)
    else:
        kw = {} if which == "raft" else dict(
            net_type="Small", h_channels=96, cxt_channels=64, encoder_out_channels=128,
            cxt_norm=None, radius=3, gru_type="Conv", convex_upsample_flow=False)
        fmodel, args = FlaxRaft(iters=1, **kw), scflow_init_args(1, IMG)[:2]
        with torch.random.fork_rng(devices=[]):
            port = RAFTRefinerFlowMask(iters=1, **kw)
    shapes = jax.eval_shape(fmodel.init, jax.random.PRNGKey(0), *args)
    update = which != "raft" and which != "raft_small"
    cxt = kw.get("cxt_norm", "BN")
    n = 0
    for coll in shapes:
        for path, _ in _leaves(jax.tree_util.tree_map(lambda s: s, dict(shapes[coll]))):
            assert flax_path(torch_key(path, "IN", cxt), update) == path
            n += 1
    names = flax_param_names(port)
    assert set(names) == {k for k, _ in port.named_parameters()}
    flax_params = {"/".join(p) for p, _ in _leaves(jax.tree_util.tree_map(
        lambda s: s, dict(shapes["params"])))}
    assert set(names.values()) == flax_params and n >= len(flax_params)
