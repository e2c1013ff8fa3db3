"""The port's registered backbones (models/resnet.py, models/densenet.py)
against the JAX package's, through the weight bridge (convert.py).

Flax variables of each JAX module are filled from a numpy seed (random
kernels, norm scales, biases and running statistics) and carried to the
port by state_dict_from_flax; the same NHWC inputs go through both.
Outputs are held to atol 5e-4, JAX's own bound between its ResNet and the
torch oracle (tests/test_convert_torch.py::test_full_resnet_parity), and
the batch statistics a train-mode call leaves to 1e-5 of each tensor's
largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from scflow_tpu.models.densenet import BasicDenseBlock as JDenseBlock
from scflow_tpu.models.resnet import ResNet as JResNet
from scflow_tpu.models.resnet import ResNetV1d as JResNetV1d
from scflow_tpu_torch.convert import flax_from_state_dict, state_dict_from_flax, torch_key
from scflow_tpu_torch.models.densenet import BasicDenseBlock
from scflow_tpu_torch.models.resnet import ResNet, ResNetV1d

from torch_port_helpers import keep_torch_rng  # noqa: F401

ATOL = 5e-4
STATS_RTOL = 1e-5


def _filled(fmodel, x, seed):
    """Variables of fmodel.init's shapes (jax.eval_shape: nothing
    compiled), from a numpy seed: kernels normal(0, 1/sqrt(fan_in)), biases
    and BatchNorm/GroupNorm offsets normal(0, 0.1), scales and running
    variances uniform(0.5, 1.5), running means normal(0, 0.1)."""
    shapes = unfreeze(jax.eval_shape(fmodel.init, jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0.0, 1.0 / np.sqrt(fan_in), leaf.shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _port(module, variables, norm="BN"):
    module.load_state_dict(state_dict_from_flax(variables, cxt_norm=norm), strict=True)
    return module


CASES = {
    # name: (flax module, port class, kwargs, image size)
    "resnet18_64": (JResNet, ResNet, dict(depth=18), 64),
    "resnetv1d50_70": (JResNetV1d, ResNetV1d, dict(depth=50), 70),
}


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def references():
    """name -> (variables, x NHWC, JAX's float32 eval outputs, its train
    outputs in float32 and in float64, and the float64 call's updated
    batch stats), each JAX model applied once per mode."""
    out = {}
    for i, (name, (jcls, _, kw, size)) in enumerate(CASES.items()):
        fm = jcls(**kw)
        x = np.random.default_rng(10 + i).normal(size=(2, size, size, 3)).astype(np.float32)
        variables = _filled(fm, jnp.asarray(x), seed=i)
        # jit: one compile of the whole net costs less than eager mode's
        # compile of every op
        evals = jax.jit(fm.apply)(variables, jnp.asarray(x))
        train = jax.jit(lambda v, a: fm.apply(v, a, train=True, mutable=["batch_stats"]))
        trains, _ = train(variables, jnp.asarray(x))
        with jax.enable_x64(True):
            trains64, upd = train(_f64(variables), jnp.asarray(x, jnp.float64))
            trains64 = [np.asarray(o) for o in trains64]
            stats = _f64(unfreeze(upd["batch_stats"]))
        out[name] = (variables, x, [np.asarray(o) for o in evals],
                     [np.asarray(o) for o in trains], trains64, stats)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_resnet_matches_jax_eval(references, name):
    """ResNet-18 at 64^2 and ResNetV1d-50 at 70^2 (odd maps through the
    avg-down projections), eval mode: the four stage outputs."""
    _, cls, kw, _ = CASES[name]
    variables, x, evals = references[name][:3]
    port = _port(cls(**kw), variables)
    with torch.no_grad():
        got = port(_nchw(x))
    assert len(got) == len(evals) == 4
    for g, w in zip(got, evals):
        assert _nhwc(g).shape == w.shape
        np.testing.assert_allclose(_nhwc(g), w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_resnet_matches_jax_train(references, name):
    """The same in train mode (batch statistics).  Single-pass batch
    variances lose digits in float32: JAX's own float32 outputs sit up to
    2.8e-3 from its float64 ones at V1d-50's stage 4.  So both networks run
    in float64 too, where the outputs agree within ATOL and the running
    statistics the call leaves within 1e-5 of each tensor's largest entry;
    the port's float32 outputs stay within twice JAX's own float32
    distance from that float64 result, plus 1e-5."""
    _, cls, kw, _ = CASES[name]
    variables, x, _, trains, trains64, stats = references[name]
    port64 = _port(cls(**kw), variables).double()
    with torch.no_grad():
        got64 = port64(_nchw(x).double(), train=True)
    for g, w in zip(got64, trains64):
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), w, atol=ATOL, rtol=0)
    sd = port64.state_dict()
    for key, v in state_dict_from_flax({"batch_stats": stats}, cxt_norm="BN").items():
        if not key.endswith("num_batches_tracked"):
            want = v.numpy()
            np.testing.assert_allclose(sd[key].numpy(), want, rtol=0,
                                       atol=STATS_RTOL * np.abs(want).max(), err_msg=key)
    port = _port(cls(**kw), variables)
    with torch.no_grad():
        got = port(_nchw(x), train=True)
    for g, w32, w64 in zip(got, trains, trains64):
        own = np.abs(w32 - w64).max()
        assert np.abs(_nhwc(g) - w64).max() <= 2 * own + 1e-5


def test_frozen_stages_gradients_match_jax():
    """frozen_stages=1 at depth 18, train mode, both networks in float64:
    every parameter's gradient against jax.grad's within 1e-6 of its norm
    (the port's frozen parameters get none, which is JAX's zero), and the
    stem's and stage 1's running statistics left as they were while the
    later stages' move."""
    fm = JResNet(depth=18, frozen_stages=1)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 64, 64, 3))
    variables = _f64(_filled(fm, jnp.asarray(x, jnp.float32), seed=3))
    with jax.enable_x64(True):
        outs_shape = jax.eval_shape(fm.apply, variables, jnp.asarray(x))
        weights = [rng.normal(size=o.shape) for o in outs_shape]

        def loss(params):
            outs, _ = fm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               jnp.asarray(x), train=True, mutable=["batch_stats"])
            return sum(jnp.sum(o * w) for o, w in zip(outs, weights))

        jgrads = state_dict_from_flax({"params": _f64(jax.jit(jax.grad(loss))(
            variables["params"]))}, cxt_norm="BN")
    port = _port(ResNet(depth=18, frozen_stages=1), variables).double()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    outs = port(_nchw(x), train=True)
    sum((o * _nchw(w)).sum() for o, w in zip(outs, weights)).backward()
    frozen = ("conv1.", "bn1.", "layer1.")
    # the biases of convs that a train-mode BatchNorm follows have a zero
    # gradient, which both compute as rounding noise: their errors are
    # held to the largest gradient's norm
    scale = max(np.linalg.norm(g.numpy()) for g in jgrads.values())
    for key, p in port.named_parameters():
        want = jgrads[key].numpy()
        if key.startswith(frozen):
            assert p.grad is None and not want.any(), key
            continue
        err = np.linalg.norm(p.grad.numpy() - want)
        assert err < 1e-6 * max(np.linalg.norm(want), 1e-3 * scale), (key, err)
    for key, v in port.state_dict().items():
        if "running" in key:
            assert torch.equal(v, before[key]) == key.startswith(frozen), key


@pytest.mark.parametrize("cls,jcls,depth", [(ResNet, JResNet, 34), (ResNet, JResNet, 101),
                                             (ResNet, JResNet, 152),
                                             (ResNetV1d, JResNetV1d, 101)])
def test_depth_keys_and_shapes(cls, jcls, depth):
    """Depths 34, 101 and 152 (and V1d-101): the port's state dict has the
    key and shape of every leaf of the JAX init's tree (traced by
    jax.eval_shape), by the bridge's mapping, and nothing else."""
    shapes = unfreeze(jax.eval_shape(jcls(depth=depth).init, jax.random.PRNGKey(0),
                                     jnp.zeros((1, 64, 64, 3))))
    want = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes[coll])[0]:
            shape = leaf.shape
            if path[-1].key == "kernel":
                shape = shape[::-1][:2] + shape[:2]  # HWIO -> OIHW
            want[torch_key(tuple(p.key for p in path), cxt_norm="BN")] = tuple(shape)
    with torch.device("meta"):
        port = cls(depth=depth)
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == want


@pytest.mark.parametrize("kw", [dict(depth=18), dict(depth=50, deep_stem=True, avg_down=True)])
def test_reference_state_dict_loads_strictly(kw):
    """The torch oracle's ResNet (tests/torch_oracle.py, the reference's
    module names) loads into the port with strict=True and gives its
    outputs."""
    from torch_oracle import ResNetTorch

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        ref = ResNetTorch(**kw).eval()
        port = (ResNetV1d if kw.get("deep_stem") else ResNet)(depth=kw["depth"])
    port.load_state_dict(ref.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 3, 70, 70)).astype(np.float32))
    with torch.no_grad():
        for g, w in zip(port.eval()(x), ref(x)):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("norm", [None, "BN", "GN"])
def test_dense_block_matches_jax(norm):
    """BasicDenseBlock with each norm, eval and train mode, on 32 input
    channels: out = concat [layer out, input] at every layer."""
    feat = (32, 64, 32)
    fm = JDenseBlock(feat_channels=feat, norm=norm)
    x = np.random.default_rng(7).normal(size=(2, 8, 8, 32)).astype(np.float32)
    variables = _filled(fm, jnp.asarray(x), seed=7)
    port = _port(BasicDenseBlock(feat, norm, in_channels=32), variables, norm=norm)
    for train in (False, True):
        want = fm.apply(variables, jnp.asarray(x), train=train,
                        mutable=["batch_stats"] if train else False)
        want = np.asarray(want[0] if train else want)
        with torch.no_grad():
            got = _nhwc(port(_nchw(x), train=train))
        assert got.shape == (2, 8, 8, 32 + sum(feat))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        np.testing.assert_array_equal(got[..., sum(feat):], x)


@pytest.mark.parametrize("case", ["resnet18", "resnetv1d50", "dense_gn"])
def test_flax_round_trip(case):
    """flax_from_state_dict(template, state_dict_from_flax(v)) == v."""
    fm, norm = {"resnet18": (JResNet(depth=18), "BN"),
                "resnetv1d50": (JResNetV1d(depth=50), "BN"),
                "dense_gn": (JDenseBlock(feat_channels=(32, 32), norm="GN"), "GN")}[case]
    x = jnp.zeros((1, 32, 32, 32 if case == "dense_gn" else 3))
    variables = _filled(fm, x, seed=11)
    back = flax_from_state_dict(variables, state_dict_from_flax(variables, cxt_norm=norm),
                                cxt_norm=norm)
    flat_v = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize("case", ["resnet18_bn", "resnet18_in", "resnetv1d50_gn", "dense_bn",
                                  "dense_none"])
def test_bf16_output_dtypes_match_jax(case):
    """dtype bfloat16: each output's dtype is JAX's (jax.eval_shape of the
    apply): a ResNet's stem norm and a DenseLayer's norms carry no dtype in
    JAX, so their outputs, and what adds to or concatenates with them,
    promote to float32."""
    jcls, pcls, kw, cin = {
        "resnet18_bn": (JResNet, ResNet, dict(depth=18, norm="BN"), 3),
        "resnet18_in": (JResNet, ResNet, dict(depth=18, norm="IN"), 3),
        "resnetv1d50_gn": (JResNetV1d, ResNetV1d, dict(depth=50, norm="GN"), 3),
        "dense_bn": (JDenseBlock, BasicDenseBlock, dict(feat_channels=(32, 32), norm="BN"), 32),
        "dense_none": (JDenseBlock, BasicDenseBlock, dict(feat_channels=(32, 32)), 32)}[case]
    x = jnp.zeros((1, 32, 32, cin), jnp.bfloat16)
    fm = jcls(dtype=jnp.bfloat16, **kw)
    variables = jax.eval_shape(fm.init, jax.random.PRNGKey(0), x)
    want = jax.eval_shape(fm.apply, variables, x)
    want = [str(w.dtype) for w in (want if isinstance(want, tuple) else (want,))]
    extra = {"in_channels": cin} if pcls is BasicDenseBlock else {}
    with torch.random.fork_rng(devices=[]):
        port = pcls(dtype=torch.bfloat16, **kw, **extra)
    with torch.no_grad():
        got = port(torch.zeros(1, cin, 32, 32, dtype=torch.bfloat16))
    got = [str(g.dtype).replace("torch.", "") for g in (got if isinstance(got, tuple) else (got,))]
    assert got == want


def test_dilations_and_strides_match_jax():
    """A dilated ResNet-18 (strides (1, 2, 1, 1), dilations (1, 1, 2, 4)),
    out_indices (1, 3), 3 stages of a deep-stemmed GN net: outputs against
    JAX's."""
    for jcls, kw in ((JResNet, dict(depth=18, strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4),
                                    out_indices=(1, 3))),
                     (JResNet, dict(depth=18, num_stages=3, strides=(1, 2, 2),
                                    dilations=(1, 1, 1), out_indices=(0, 2), deep_stem=True,
                                    norm="GN"))):
        fm = jcls(**kw)
        x = np.random.default_rng(9).normal(size=(1, 32, 32, 3)).astype(np.float32)
        variables = _filled(fm, jnp.asarray(x), seed=9)
        want = jax.jit(fm.apply)(variables, jnp.asarray(x))
        port = _port(ResNet(**kw), variables, norm=kw.get("norm", "BN"))
        with torch.no_grad():
            got = port(_nchw(x))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kw,exc", [(dict(depth=26), KeyError), (dict(num_stages=5), ValueError),
                                    (dict(strides=(1, 2)), ValueError),
                                    (dict(out_indices=(0, 4)), ValueError),
                                    (dict(norm="LN"), ValueError)])
def test_bad_arguments_raise(kw, exc):
    with pytest.raises(exc):
        ResNet(**kw)
