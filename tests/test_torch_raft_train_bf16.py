"""The port's RAFT train step with a bf16 model (RAFTRefinerFlowMask(dtype=
torch.bfloat16)) against the JAX package's at dtype=jnp.bfloat16, on the
kernels' path (K1 forward, K1b backward: their plain versions here, JAX's
Pallas lookup in interpret mode), at N = 2, 64^2, 2 iterations, from
PyTorch's initialisation (test_torch_raft_train.py's recipe).  Bounds from
JAX's own bf16-to-fp32 distance d on the same inputs (relative; all
gradients together as one vector, rel L2): the loss within 2 d + 1e-3 of
JAX's bf16 loss, the gradients within 2 d of JAX's bf16 gradients and of
its fp32 ones.  The two packages round independently (flax's op order is
followed, but ties flip), so their bf16 gradients sit about as far apart
as each from fp32: measured 0.177 between them against d = 0.174."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_raft_system import make_setup
from test_torch_raft_train import IMG, ITERS, _jax_step, _port_step
from test_torch_train import _interpret_lookup
from torch_port_helpers import keep_torch_rng, no_tf32, raft_pair_torch_init  # noqa: F401


@pytest.fixture(scope="module")
def setup():
    return make_setup(*raft_pair_torch_init(IMG, ITERS, seed=1))


def test_train_step_bf16_matches_jax_bf16(setup, monkeypatch, no_tf32):
    """dtype=bfloat16 on the same weights, lookup 'pallas' (K1 and K1b's
    bf16 instances' plain versions; JAX's interpret-mode kernels)."""
    from scflow_tpu_torch.refiners.raft import RAFTRefinerFlowMask

    _interpret_lookup(monkeypatch)
    with torch.random.fork_rng(devices=[]):
        port16 = RAFTRefinerFlowMask(iters=ITERS, dtype=torch.bfloat16)
    port16.load_state_dict(setup["port"].state_dict(), strict=True)
    _, j32, g32 = _jax_step(setup, "pallas")
    _, j16, g16 = _jax_step(setup, "pallas", fmodel=setup["fmodel"].clone(dtype=jnp.bfloat16))
    state, logs = _port_step(setup, "pallas", model=port16)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in state.model.parameters())
    loss_bound = 2 * abs(j16["loss"] / j32["loss"] - 1) + 1e-3
    assert abs(float(logs["loss"]) / j16["loss"] - 1) <= loss_bound

    def flat(grads):
        return np.concatenate([np.asarray(grads[k], np.float64).ravel() for k in sorted(g16)])

    got = flat({n: p.grad.numpy() for n, p in state.model.named_parameters()})
    w16, w32 = flat({k: v.numpy() for k, v in g16.items()}), flat(
        {k: v.numpy() for k, v in g32.items()})
    d = np.linalg.norm(w16 - w32) / np.linalg.norm(w32)
    assert np.linalg.norm(got - w16) / np.linalg.norm(w16) <= 2 * d
    assert np.linalg.norm(got - w32) / np.linalg.norm(w32) <= 2 * d
