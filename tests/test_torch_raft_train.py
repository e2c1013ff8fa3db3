"""The port's RAFT train step (refiners/system.py::make_raft_train_step)
against the JAX package's, one step at N = 2, 64^2, 2 iterations, on the
shipped recipe (RAFTRefinerFlowMask; AdamW 4e-4, betas (0.9, 0.999), eps
1e-8, wd 1e-4; clip 1.0), from PyTorch's initialisation
(torch_port_helpers.raft_pair_torch_init), on both lookup backends.

The bounds PR 3 set for SCFlow (test_torch_train.py's protocol): the loss
and every log_vars entry at rtol 2e-4, every gradient leaf at relative L2
<= 2e-2 (leaves below 1e-5 of the global norm: noise on both sides), the
BatchNorm running statistics at rtol 1e-4 / atol 1e-5.  JAX's gradients
are read from its Adam state (mu = (1 - b1) g, the clipped g).

The yardstick is JAX's step with its network in float64 (`jax.enable_x64`,
float64 variables and real images; the renders and the gt flow stay
float32 in both).  JAX's float32 gradients are not: on these weights its
feature encoder's leaves sit up to 2.4e-2 from its own float64 ones, where
the port's float32 leaves sit within 4e-3 of a float64 run of the port
(and 7.1e-3 of JAX's float64), so JAX's float32 rounding alone would break
the 2e-2 bound.  Both lookup backends compute the same level gradients
here: the decoder detaches the flow, so no coordinate gradient (where
'pallas' and 'xla' take different subgradients) is formed."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scflow_tpu.refiners import system as jsystem
from scflow_tpu.runtime import TrainState as JTrainState
from scflow_tpu.runtime import build_optimizer as j_build_optimizer
from scflow_tpu_torch.convert import state_dict_from_flax
from scflow_tpu_torch.refiners.system import make_raft_train_step
from scflow_tpu_torch.runtime.optim import build_optimizer
from scflow_tpu_torch.runtime.train_state import TrainState

from test_torch_raft_system import make_setup
from test_torch_train import _worst_grad_rel
from torch_port_helpers import keep_torch_rng, no_tf32, raft_pair_torch_init  # noqa: F401

IMG, ITERS = 64, 2
OPT = dict(type="AdamW", lr=4e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
CLIP = 1.0  # configs/refine_models/raft.py optimizer_config


@pytest.fixture(scope="module")
def setup():
    return make_setup(*raft_pair_torch_init(IMG, ITERS, seed=1))


def _jax_step(s, backend, fmodel=None, x64=False, **kw):
    """One JAX step: (new state, log_vars as floats, gradients by torch
    name).  x64: the network in float64 (the variables and real images)."""
    variables, batch = s["variables"], dict(s["batch"])
    if x64:
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        batch["real_images"] = np.asarray(batch["real_images"], np.float64)
    with jax.enable_x64(x64):
        tx, _ = j_build_optimizer(OPT, None, grad_clip=CLIP)
        state = JTrainState.create(variables["params"], tx, variables["batch_stats"])
        step = jsystem.make_raft_train_step(fmodel or s["fmodel"], s["j_render"],
                                            image_size=(IMG, IMG), render_chunk=16,
                                            donate=False, lookup_backend=backend, **kw)
        new, logs = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    adam = [x for x in jax.tree_util.tree_leaves(
        new.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState)][0]
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / (1 - 0.9), adam.mu)
    return new, {k: float(v) for k, v in logs.items()}, state_dict_from_flax({"params": grads})


def _port_step(s, backend, model=None, **kw):
    model = copy.deepcopy(model or s["port"])
    tx, _ = build_optimizer(model.parameters(), OPT, None, grad_clip=CLIP)
    step = make_raft_train_step(model, s["render"], image_size=(IMG, IMG), render_chunk=16,
                                lookup_backend=backend, device="cpu", **kw)
    state, logs = step(TrainState(model, tx), s["batch"])
    return state, logs


@pytest.fixture(scope="module")
def jax64(setup):
    """JAX's float64 step, without and with the depth filter."""
    return {f: _jax_step(setup, "xla", x64=True, filter_invalid_flow_by_depth=f)
            for f in (False, True)}


@pytest.mark.parametrize("backend,depth_filter", [("xla", False), ("pallas", False),
                                                  ("xla", True)])
def test_train_step_matches_jax(setup, jax64, backend, depth_filter, no_tf32):
    """Loss, log_vars (seq_{i}_flow_loss, seq_{i}_occ_loss, loss_flow,
    loss_occ, loss, grad_norm), every gradient leaf and the BatchNorm
    statistics after one step, against JAX's float64 step; with the gt flow
    also filtered by the depth rendered at the gt pose."""
    j_new, j_logs, j_grads = jax64[depth_filter]
    state, logs = _port_step(setup, backend, filter_invalid_flow_by_depth=depth_filter)
    assert set(logs) == set(j_logs) and state.step == 1
    assert {f"seq_{i}_{t}_loss" for i in range(ITERS) for t in ("flow", "occ")} < set(logs)
    for k, v in j_logs.items():
        np.testing.assert_allclose(float(logs[k]), v, rtol=2e-4, err_msg=k)
    assert j_logs["grad_norm"] > CLIP  # the clip acted
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    assert set(grads) == set(j_grads)
    assert _worst_grad_rel(grads, j_grads) <= 2e-2
    want_bs = state_dict_from_flax({"batch_stats": jax.tree_util.tree_map(
        np.asarray, j_new.batch_stats)})
    sd = state.model.state_dict()
    for k, v in want_bs.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_loss_falls_and_donate_false_leaves_the_state(setup, no_tf32):
    """Six steps at a constant lr 1e-3 on one batch: the loss falls; with
    donate=False the given state is left as it was."""
    model = copy.deepcopy(setup["port"])
    tx, _ = build_optimizer(model.parameters(), dict(type="AdamW", lr=1e-3, weight_decay=1e-4),
                            None, grad_clip=CLIP)
    state = TrainState(model, tx)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    keep = make_raft_train_step(model, setup["render"], image_size=(IMG, IMG), render_chunk=16,
                                lookup_backend="pallas", donate=False, device="cpu")
    new, _ = keep(state, setup["batch"])
    assert new is not state and state.step == 0 and new.step == 1
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    step = make_raft_train_step(model, setup["render"], image_size=(IMG, IMG), render_chunk=16,
                                lookup_backend="pallas", device="cpu")
    losses = []
    for _ in range(6):
        state, logs = step(state, setup["batch"])
        losses.append(float(logs["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_train_step_refuses_render_augmentations(setup):
    """Render augmentations are ported (tests/test_torch_augment.py); an
    unknown type (torchvision's ColorJitter, not kornia's ColorJiggle) is
    refused when the step is made."""
    with pytest.raises(ValueError, match="render augmentations: unknown type 'ColorJitter'"):
        make_raft_train_step(setup["port"], setup["render"], image_size=(IMG, IMG),
                             render_augmentations=[dict(type="ColorJitter")], device="cpu")
