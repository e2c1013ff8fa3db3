"""Shared pieces of the PyTorch-port parity tests: the flax reference and the
port's module built from one seed, fp32 settings for both, and the fixture
that leaves torch's global RNG as each test found it.

JAX and flax are imported inside the functions that need them, so that the
JAX-free card tests (tests/test_torch_kernels.py) can import this module on
a machine without JAX."""

import numpy as np
import pytest
import torch

from scflow_tpu_torch.convert import state_dict_from_flax


@pytest.fixture(autouse=True)
def keep_torch_rng():
    """Restores torch's global (CPU) RNG after the test.  Every port test
    module imports it: tests elsewhere draw their weights from that RNG
    without seeding it (tests/test_grad_parity.py), so a port test that
    seeds it or builds modules with PyTorch's default initialisation would
    change their weights, by the order the tests happen to run in."""
    with torch.random.fork_rng(devices=[]):
        yield


@pytest.fixture
def no_tf32():
    """Full fp32 matmuls and convolutions in PyTorch (cuDNN allows TF32 by
    default on a card); restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def check_maps(got, want, id_exact: bool = True):
    """Raster maps (N, 16, H, W) of the port against the JAX package's on
    the same packs.  XLA's CPU code contracts a*b + c into an FMA and the
    port does not, so the depth plane z = a px + b py + c, whose terms
    cancel, differs by several float32 ulps: depth is held to
    tests/test_pallas_raster.py's bound (|d| > 0.05 on < 2e-3 of the
    pixels) and rtol 2e-6; mask exactly, the winner id exactly (or, where a
    tie of keys can flip, on all but 2e-3 of the pixels), normals, colours
    and barycentrics to atol 1e-4, the padding channels to zero."""
    fg = want[:, 1] > 0.5
    assert fg.mean() > 0.02  # the scene is not empty
    np.testing.assert_array_equal(got[:, 1], want[:, 1])  # mask
    if id_exact:
        np.testing.assert_array_equal(got[:, 2], want[:, 2])  # winner id
    else:
        assert (got[:, 2] != want[:, 2]).mean() < 2e-3
    d = np.abs(got[:, 0] - want[:, 0])
    assert (d > 0.05).mean() < 2e-3
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=2e-6, atol=0)
    np.testing.assert_allclose(got[:, 3:12], want[:, 3:12], atol=1e-4)
    np.testing.assert_array_equal(got[:, 12:], 0.0)


def np_tree(variables):
    """flax variables -> nested dicts of numpy arrays (writable copies)."""
    import jax
    from flax.core import unfreeze

    return jax.tree_util.tree_map(lambda a: np.array(a), unfreeze(variables))


def load_port(module: torch.nn.Module, variables, **norms) -> torch.nn.Module:
    """Carry flax variables into the port's module through the weight
    bridge, strictly, and put it in eval mode."""
    module.load_state_dict(state_dict_from_flax(variables, **norms), strict=True)
    return module.eval()


def scflow_pair(num_class: int, img: int, iters: int, seed: int = 0,
                perturb: float = 0.02, **model_kw):
    """(flax SCFlowRefiner, numpy variables, port SCFlowRefiner) with the same
    weights.  The pose head's output kernels get normal(0, perturb) noise so
    that the poses, and their feedback into the next lookup, move.
    model_kw (the detach options) go to both constructors.  The port's
    module is built under a forked RNG (load_port overwrites every weight),
    so the global RNG is left as it was."""
    import jax
    import jax.numpy as jnp

    from scflow_tpu.refiners import SCFlowRefiner as FlaxRefiner
    from scflow_tpu_torch.refiners.scflow import SCFlowRefiner

    fmodel = FlaxRefiner(iters=iters, pose_head_cfg=dict(
        type="MultiClassPoseHead", num_class=num_class, in_channels=224,
        rotation_mode="ortho6d"), **model_kw)
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
    with torch.random.fork_rng(devices=[]):
        port = SCFlowRefiner(num_class=num_class, image_size=(img, img), iters=iters,
                             **model_kw)
    port = load_port(port, variables)
    return fmodel, variables, port


def scflow_pair_torch_init(num_class: int, img: int, iters: int, seed: int = 0,
                           perturb: float = 0.005, **model_kw):
    """As scflow_pair, with the port's own (PyTorch default) initialisation
    from torch.manual_seed(seed), carried to flax by the JAX package's
    convert_state_dict_to_variables.  These weights are smaller than flax's
    lecun-normal ones.  From flax's initialisation the float32 gradients of
    the two packages differ by several percent (their single-pass norm
    statistics over [0, 1] images lose digits); from these they agree
    within the train-step tests' 2e-2, as tests/test_grad_parity.py, which
    starts from torch weights too, finds for the JAX package.  The seed
    acts on a forked RNG: the global one is left as it was."""
    from scflow_tpu.runtime.convert_torch import convert_state_dict_to_variables
    from scflow_tpu_torch.refiners.scflow import SCFlowRefiner

    fmodel, template, _ = scflow_pair(num_class, img, iters, seed, 0.0, **model_kw)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        port = SCFlowRefiner(num_class=num_class, image_size=(img, img), iters=iters,
                             **model_kw)
    g = torch.Generator().manual_seed(seed + 1)
    head = port.decoder.pose_pred
    with torch.no_grad():
        for lin in (head.rotation_pred, head.translation_pred):
            lin.weight.copy_(perturb * torch.randn(lin.weight.shape, generator=g))
    variables = np_tree(convert_state_dict_to_variables(
        {k: v.numpy() for k, v in port.state_dict().items()}, template))
    return fmodel, variables, port.eval()
