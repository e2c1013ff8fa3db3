"""Shared pieces of the PyTorch-port parity tests: the flax reference and the
port's module built from one seed, and fp32 settings for both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from scflow_tpu_torch.convert import state_dict_from_flax


@pytest.fixture
def no_tf32():
    """Full fp32 matmuls and convolutions in PyTorch (cuDNN allows TF32 by
    default on a card); restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def np_tree(variables):
    """flax variables -> nested dicts of numpy arrays (writable copies)."""
    return jax.tree_util.tree_map(lambda a: np.array(a), unfreeze(variables))


def load_port(module: torch.nn.Module, variables, **norms) -> torch.nn.Module:
    """Carry flax variables into the port's module through the weight
    bridge, strictly, and put it in eval mode."""
    module.load_state_dict(state_dict_from_flax(variables, **norms), strict=True)
    return module.eval()


def scflow_pair(num_class: int, img: int, iters: int, seed: int = 0,
                perturb: float = 0.02):
    """(flax SCFlowRefiner, numpy variables, port SCFlowRefiner) with the same
    weights.  The pose head's output kernels get normal(0, perturb) noise so
    that the poses, and their feedback into the next lookup, move."""
    from scflow_tpu.refiners import SCFlowRefiner as FlaxRefiner
    from scflow_tpu_torch.refiners.scflow import SCFlowRefiner

    fmodel = FlaxRefiner(iters=iters, pose_head_cfg=dict(
        type="MultiClassPoseHead", num_class=num_class, in_channels=224,
        rotation_mode="ortho6d"))
    z = jnp.zeros((1, img, img, 3))
    eye = jnp.eye(3)[None]
    variables = np_tree(jax.jit(fmodel.init)(
        jax.random.PRNGKey(seed), z, z, eye, jnp.asarray([[0.0, 0.0, 1.0]]),
        jnp.zeros((1, img, img)), eye, jnp.zeros((1,), jnp.int32)))
    rng = np.random.default_rng(seed)
    head = variables["params"]["decoder"]["update"]["pose_pred"]
    for name in ("rotation_pred", "translation_pred"):
        k = head[name]["kernel"]
        head[name]["kernel"] = rng.normal(0.0, perturb, k.shape).astype(np.float32)
    port = load_port(SCFlowRefiner(num_class=num_class, image_size=(img, img),
                                   iters=iters), variables)
    return fmodel, variables, port
