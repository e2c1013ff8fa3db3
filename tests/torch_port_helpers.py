"""Shared pieces of the PyTorch-port parity tests: the flax reference and the
port's module built from one seed, fp32 settings for both, and the fixture
that leaves torch's global RNG as each test found it.

JAX and flax are imported inside the functions that need them, so that the
JAX-free card tests (tests/test_torch_kernels.py) can import this module on
a machine without JAX."""

import os

import numpy as np
import pytest
import torch

from scflow_tpu_torch.convert import state_dict_from_flax

# Under pytest-xdist each worker process would run torch's CPU ops on every
# core; with several workers sharing the cores (and XLA's own thread pools)
# the OpenMP threads contend and the port's tests run many times slower.
# Every worker imports this module while collecting, so it caps torch's
# intra-op threads at the worker's share of the cores before any test runs.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


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
    norms = {k: model_kw[k] for k in ("encoder_norm", "cxt_norm") if k in model_kw}
    variables = np_tree(convert_state_dict_to_variables(
        {k: v.numpy() for k, v in port.state_dict().items()}, template, **norms))
    return fmodel, variables, port.eval()


def adversarial_raster_corners(img: int, n: int = 2, seed: int = 0):
    """Projected corners (N, F, 3, 2), corner depths (N, F, 3), face_valid
    (N, F) and corner [normal, colour] attributes (N, F, 3, 6) of a scene
    made to catch a face test that drops or adds a face: edges through
    pixel centres, slivers and edge-on faces, faces whose corners sit on or
    next to tile (8 x 128) and warp (8 x 16) borders, one far face covering
    the whole crop and a near one covering the first 8 x 128 tile, faces
    with corners near +-1e4, invalid ones (face_valid False, a corner
    behind the camera, zero area), and both windings.  Float32, CPU."""
    rng = np.random.default_rng(seed)
    parts = []

    def add(tri):
        parts.append(np.asarray(tri, np.float64).reshape(-1, 3, 2))

    for _ in range(n):
        base = rng.integers(0, img, (96, 1, 2)) + rng.choice([0.0, 0.5], (96, 1, 2))
        add(base + rng.integers(-6, 7, (96, 3, 2)) * rng.choice([0.5, 1.0], (96, 1, 1)))
        # slivers, exactly edge-on and nearly edge-on faces
        p0 = rng.uniform(-8, img + 8, (96, 2))
        d = rng.normal(size=(96, 2)) * rng.uniform(4, img, (96, 1))
        perp = np.stack([-d[:, 1], d[:, 0]], -1) / np.linalg.norm(d, axis=1, keepdims=True)
        eps = rng.choice([0.0, 1e-6, 1e-3, 1e-2, 0.3], (96, 1))
        add(np.stack([p0, p0 + d, p0 + 0.5 * d + eps * perp], 1))
        # corners on tile and warp borders, or a hair beside them
        gx = rng.integers(0, img // 16 + 1, (96, 3)) * 16.0
        gy = rng.integers(0, img // 8 + 1, (96, 3)) * 8.0
        jit = rng.choice([0.0, 0.5, -0.5, 1e-4, -1e-4, -1.0], (96, 3, 2))
        add(np.stack([gx, gy], -1) + jit)
        # huge faces with corners near +-1e4 (large coefficients that cancel)
        add(rng.choice([-1e4, 1e4], (32, 3, 2)) + rng.uniform(-img, 2 * img, (32, 3, 2)))
        # one far face over the whole crop, one near face over the first tile
        add([[-10.0, -10.0], [3.0 * img, -10.0], [-10.0, 3.0 * img]])
        add([[-1.0, -1.0], [300.0, -1.0], [-1.0, 20.0]])
        # medium faces anywhere
        c = rng.uniform(0, img, (94, 1, 2))
        add(c + rng.normal(size=(94, 3, 2)) * rng.uniform(2, 30, (94, 1, 1)))
    tri = np.concatenate(parts).reshape(n, -1, 3, 2)
    f = tri.shape[1]
    flip = rng.random((n, f)) < 0.5  # both windings, so culling drops about half
    tri[flip] = tri[flip][:, ::-1]
    z = rng.uniform(300, 500, (n, f, 3))
    z[:, 320] = 900.0  # the whole-crop face lies behind the rest
    z[:, 321] = 200.0  # the first-tile face in front of them
    z[rng.random((n, f)) < 0.02, 0] = -1.0  # a corner behind the camera
    valid = rng.random((n, f)) > 0.03
    valid[1:, 320] = False  # images after the first keep a background
    attrs = rng.uniform(-1, 1, (n, f, 3, 6))
    return tuple(torch.from_numpy(a.astype(t)) for a, t in
                 ((tri, np.float32), (z, np.float32), (valid, bool), (attrs, np.float32)))


def lecun_variables(fmodel, seed: int, *init_args):
    """Variables of the shapes fmodel.init gives (traced by jax.eval_shape,
    nothing compiled), filled from a numpy seed as flax initialises them:
    lecun-normal kernels, zero biases, unit norm scales and variances, zero
    means.  Nested dicts of numpy arrays."""
    import jax
    from flax.core import unfreeze

    shapes = unfreeze(jax.eval_shape(fmodel.init, jax.random.PRNGKey(0), *init_args))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0.0, 1.0 / np.sqrt(fan_in), leaf.shape).astype(np.float32)
        if name in ("scale", "var"):
            return np.ones(leaf.shape, np.float32)
        return np.zeros(leaf.shape, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def raft_pair(img: int, iters: int, seed: int = 0, mask: bool = True, **model_kw):
    """(flax RAFT refiner, numpy variables, the port's refiner) with the same
    weights (lecun_variables, carried across by the weight bridge):
    RAFTRefinerFlowMask (mask=True) or RAFTRefinerFlow, model_kw (for
    example seperate_encoder, encoder_norm, cxt_norm) to both.  The port's
    module is built under a forked RNG."""
    import jax.numpy as jnp

    from scflow_tpu.refiners import raft as jraft
    from scflow_tpu_torch.refiners import raft

    name = "RAFTRefinerFlowMask" if mask else "RAFTRefinerFlow"
    fmodel = getattr(jraft, name)(iters=iters, **model_kw)
    z = jnp.zeros((1, img, img, 3))
    variables = lecun_variables(fmodel, seed, z, z)
    with torch.random.fork_rng(devices=[]):
        port = getattr(raft, name)(iters=iters, **model_kw)
    norms = {k: model_kw[k] for k in ("encoder_norm", "cxt_norm") if k in model_kw}
    return fmodel, variables, load_port(port, variables, **norms)


def raft_pair_torch_init(img: int, iters: int, seed: int = 0, mask: bool = True, **model_kw):
    """As raft_pair, with the port's own (PyTorch default) initialisation
    from torch.manual_seed(seed), carried to flax by the JAX package's
    convert_state_dict_to_variables (scflow_pair_torch_init's reason: the
    train-step tests' gradient bounds hold from these weights).  The global
    RNG is left as it was."""
    from scflow_tpu.runtime.convert_torch import convert_state_dict_to_variables
    from scflow_tpu_torch.refiners import raft

    fmodel, template, _ = raft_pair(img, iters, seed, mask, **model_kw)
    name = "RAFTRefinerFlowMask" if mask else "RAFTRefinerFlow"
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        port = getattr(raft, name)(iters=iters, **model_kw)
    norms = {k: model_kw[k] for k in ("encoder_norm", "cxt_norm") if k in model_kw}
    variables = np_tree(convert_state_dict_to_variables(
        {k: v.numpy() for k, v in port.state_dict().items()}, template, **norms))
    return fmodel, variables, port.eval()


def flax_from_port(template, state_dict, encoder_norm="IN", cxt_norm="BN"):
    """The inverse of the weight bridge: flax variables of `template`'s tree
    (nested dicts of arrays or shape structs, e.g. lecun_variables') filled
    from the port's state dict (convert.flax_from_state_dict).  Unlike the
    JAX package's convert_state_dict_to_variables it takes every norm kind,
    None included."""
    from flax.core import unfreeze

    from scflow_tpu_torch.convert import flax_from_state_dict

    return flax_from_state_dict(unfreeze(template), state_dict, encoder_norm, cxt_norm)


def scflow_init_args(n: int, img: int):
    """Dummy inputs for tracing an SCFlowRefiner's init: (render, real, R, t,
    depth, K, label)."""
    import jax.numpy as jnp

    z = jnp.zeros((n, img, img, 3))
    eye = jnp.tile(jnp.eye(3)[None], (n, 1, 1))
    return (z, z, eye, jnp.tile(jnp.asarray([[0.0, 0.0, 700.0]]), (n, 1)),
            jnp.zeros((n, img, img)), eye, jnp.zeros((n,), jnp.int32))


def scflow_options_pair(img: int, iters: int, seed: int = 0, perturb: float = 0.02,
                        num_class: int = 3, **model_kw):
    """(flax SCFlowRefiner, numpy variables, port SCFlowRefiner) with the same
    weights and any of the refiner's options (model_kw to both; the pose
    head is a MultiClassPoseHead of num_class classes unless model_kw's
    pose_head_cfg says otherwise): lecun_variables, the pose head's output
    kernels normal(0, perturb) and its rotation bias the identity of its
    rotation mode (_zero_init_heads' bias; lecun_variables zeroes biases),
    carried to the port by the weight bridge."""
    from scflow_tpu.refiners import SCFlowRefiner as FlaxRefiner
    from scflow_tpu_torch.models.pose_head import ID_BIAS
    from scflow_tpu_torch.refiners.scflow import SCFlowRefiner

    model_kw.setdefault("pose_head_cfg", dict(type="MultiClassPoseHead", num_class=num_class))
    fmodel = FlaxRefiner(iters=iters, **model_kw)
    variables = lecun_variables(fmodel, seed, *scflow_init_args(1, img))
    head = variables["params"]["decoder"]["update"]["pose_pred"]
    rng = np.random.default_rng(seed)
    for name in ("rotation_pred", "translation_pred"):
        k = head[name]["kernel"]
        head[name]["kernel"] = rng.normal(0.0, perturb, k.shape).astype(np.float32)
    bias = np.asarray(ID_BIAS[model_kw["pose_head_cfg"].get("rotation_mode", "ortho6d")])
    rot_bias = head["rotation_pred"]["bias"]
    head["rotation_pred"]["bias"] = np.tile(bias, rot_bias.shape[0] // bias.size).astype(
        np.float32)
    with torch.random.fork_rng(devices=[]):
        port = SCFlowRefiner(num_class=num_class, image_size=(img, img), iters=iters,
                             **model_kw)
    norms = {k: model_kw[k] for k in ("encoder_norm", "cxt_norm") if k in model_kw}
    return fmodel, variables, load_port(port, variables, **norms)
