"""The port's bf16 compute against the JAX package at dtype=jnp.bfloat16,
module by module (the layers of SCFlowRefiner(dtype=torch.bfloat16)), then
the pyramid and the lookup on bf16 maps (both backends, K1b's plain
version); flax weights carried over by convert.py.  The refiner, the entry
points and the train step at bf16 are in test_torch_bf16_system.py.

Tolerances.  A single bf16 layer of the port equals the flax layer bit for
bit on the CPU (both round the product once, then add the bias in bf16).
Through a stack of layers the rare 1-ulp flips (a sum that lands on a
rounding tie in another summation order) spread: the tests bound the
relative L2 error and the largest error, in bf16 ulps at the output's
scale, 2^-8 of its largest magnitude (ULP below), stated per test from
the errors measured on these seeds with about a factor 2 to spare."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_tpu.models import ConvGRU as FGRU
from scflow_tpu.models import MotionEncoder as FMotion
from scflow_tpu.models import MultiClassPoseHead as FPoseHead
from scflow_tpu.models import RAFTEncoder as FEncoder
from scflow_tpu.models import XHead as FXHead
from scflow_tpu.models.layers import ConvModule as FConvModule
from scflow_tpu.ops.corr import corr_lookup as j_corr_lookup
from scflow_tpu.ops.corr import correlation_pyramid_flat as j_pyramid
from scflow_tpu.ops.pallas.corr_lookup import corr_lookup_pallas, corr_lookup_pallas_diff
from scflow_tpu_torch.convert import state_dict_from_flax
from scflow_tpu_torch.models.layers import ConvModule
from scflow_tpu_torch.models.motion import ConvGRU, MotionEncoder, XHead
from scflow_tpu_torch.models.pose_head import MultiClassPoseHead
from scflow_tpu_torch.models.raft_encoder import RAFTEncoder
from scflow_tpu_torch.ops.corr import corr_lookup, correlation_pyramid_flat
from scflow_tpu_torch.ops.cuda import corr_lookup as k1

from torch_port_helpers import keep_torch_rng, load_port, no_tf32, np_tree  # noqa: F401

BF, TB = jnp.bfloat16, torch.bfloat16
KEY = jax.random.PRNGKey(0)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _ulp(want) -> float:
    """One bf16 ulp at the largest magnitude of `want`: 2^-8 of it."""
    return float(np.abs(np.asarray(want, np.float32)).max()) * 2.0 ** -8


def assert_bf16_close(got, want, l2_ulps: float, max_ulps: float):
    """Relative L2 error within l2_ulps * 2^-8, every element within
    max_ulps bf16 ulps at want's scale."""
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    d = np.abs(got - want)
    rel_l2 = float(np.linalg.norm(d) / np.linalg.norm(want))
    assert rel_l2 <= l2_ulps * 2.0 ** -8, f"rel L2 {rel_l2} > {l2_ulps} ulps"
    assert float(d.max()) <= max_ulps * _ulp(want), \
        f"max |d| {d.max()} > {max_ulps} ulps of {_ulp(want)}"


def _perturb_stats(variables, rng):
    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "mean":
                tree[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    walk(variables.get("batch_stats", {}))
    return variables


# --------------------------------------------------------------------------
# modules

@pytest.mark.parametrize("norm,train", [("IN", False), ("GN", False), ("BN", False),
                                        ("BN", True)])
def test_conv_module_bf16(norm, train, rng):
    """One layer: bit for bit (flax rounds the product once, then the norm's
    float32 math once); BatchNorm in training updates float32 running
    statistics equal to flax's within float32 rounding."""
    x = rng.normal(size=(2, 9, 10, 32)).astype(np.float32)
    fm = FConvModule(64, 3, stride=2, padding=1, norm=norm, act="relu", dtype=BF)
    variables = _perturb_stats(np_tree(fm.init(KEY, jnp.asarray(x))), rng)
    tm = load_port(ConvModule(32, 64, 3, stride=2, padding=1, norm=norm, dtype=TB),
                   variables, cxt_norm=norm)
    if train:
        want, upd = fm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        tm.train()
        got = tm(nchw(x), train=True)
        stats = upd["batch_stats"]["norm"]
        np.testing.assert_allclose(tm.bn.running_mean.numpy(), np.asarray(stats["mean"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tm.bn.running_var.numpy(), np.asarray(stats["var"]),
                                   rtol=1e-6, atol=1e-7)
        assert tm.bn.running_mean.dtype == tm.bn.running_var.dtype == torch.float32
    else:
        want = fm.apply(variables, jnp.asarray(x))
        with torch.no_grad():
            got = tm(nchw(x))
    assert got.dtype == TB and want.dtype == BF
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    np.testing.assert_array_equal(nhwc(got), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("norm,l2_ulps,max_ulps", [("IN", 8, 10), ("BN", 3, 4)])
def test_raft_encoder_bf16(norm, l2_ulps, max_ulps, rng):
    """Both encoders, 13 conv layers deep (measured: IN rel L2 1.5e-2 = 3.9
    ulps, max 4.3 ulps; BN 4.5e-3 = 1.2 ulps, max 1.5 ulps)."""
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    fm = FEncoder(norm=norm, out_channels=256, dtype=BF)
    variables = _perturb_stats(np_tree(fm.init(KEY, jnp.asarray(x))), rng)
    tm = load_port(RAFTEncoder(256, norm=norm, dtype=TB), variables, cxt_norm=norm)
    with torch.no_grad():
        got = tm(nchw(x))
    want = fm.apply(variables, jnp.asarray(x))
    assert got.dtype == TB and want.dtype == BF
    assert_bf16_close(nhwc(got), want, l2_ulps, max_ulps)


def test_motion_encoder_bf16(rng):
    """bf16 convs; the output concat[bf16 features, float32 flow] promotes
    to float32 in both packages (measured rel L2 0.08 ulps, max 0.3)."""
    corr = rng.normal(size=(2, 8, 8, 324)).astype(np.float32)
    flow = rng.normal(size=(2, 8, 8, 2)).astype(np.float32)
    fm = FMotion(dtype=BF)
    variables = np_tree(fm.init(KEY, jnp.asarray(corr), jnp.asarray(flow)))
    tm = load_port(MotionEncoder(TB), variables)
    with torch.no_grad():
        got = tm(nchw(corr), nchw(flow))
    want = fm.apply(variables, jnp.asarray(corr), jnp.asarray(flow))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert_bf16_close(nhwc(got), want, 0.5, 1)


def test_conv_gru_bf16(rng):
    """h bf16 (tanh of the bf16 context), x float32 (the motion features):
    the gates' convs cast [h, x], h' stays bf16 (measured rel L2 1.3 ulps,
    max 1.7: the elementwise update rounds at each op)."""
    h = jnp.asarray(rng.normal(size=(2, 8, 8, 128)).astype(np.float32)).astype(BF)
    x = rng.normal(size=(2, 8, 8, 256)).astype(np.float32)
    fm = FGRU(128, dtype=BF)
    variables = np_tree(fm.init(KEY, h, jnp.asarray(x)))
    tm = load_port(ConvGRU(128, 256, TB), variables)
    with torch.no_grad():
        got = tm(nchw(np.asarray(h.astype(jnp.float32))).to(TB), nchw(x))
    want = fm.apply(variables, h, jnp.asarray(x))
    assert got.dtype == TB and want.dtype == BF
    assert_bf16_close(nhwc(got), want, 3, 4)


@pytest.mark.parametrize("kind,out", [("flow", 2), ("mask", 1)])
def test_xhead_bf16(kind, out, rng):
    x = jnp.asarray(rng.normal(size=(2, 8, 8, 128)).astype(np.float32)).astype(BF)
    fm = FXHead((256,), out, kind=kind, dtype=BF)
    variables = np_tree(fm.init(KEY, x))
    tm = load_port(XHead(128, 256, out, kind=kind, dtype=TB), variables)
    with torch.no_grad():
        got = tm(nchw(np.asarray(x.astype(jnp.float32))).to(TB))
    want = fm.apply(variables, x)
    assert got.dtype == TB and want.dtype == BF
    assert_bf16_close(nhwc(got), want, 1, 2)


def test_multiclass_pose_head_bf16(rng):
    """GN convs and FC layers in bf16; the rotation and translation linears
    take the bf16 features into their float32 parameters (flax builds them
    without dtype), so the deltas are float32."""
    x = jnp.asarray(rng.normal(size=(3, 16, 16, 224)).astype(np.float32)).astype(BF)
    label = np.array([2, 0, 3])
    fm = FPoseHead(num_class=4, dtype=BF)
    variables = np_tree(fm.init(KEY, x, jnp.asarray(label)))
    for name in ("rotation_pred", "translation_pred"):
        k = variables["params"][name]["kernel"]
        variables["params"][name]["kernel"] = rng.normal(0, 0.05, k.shape).astype(np.float32)
    sd = state_dict_from_flax({"params": {"pose_pred": variables["params"]}})
    tm = MultiClassPoseHead(4, 224, feat_size=(16, 16), dtype=TB).eval()
    tm.load_state_dict({k[len("pose_pred."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        rot, trans = tm(nchw(np.asarray(x.astype(jnp.float32))).to(TB), torch.from_numpy(label))
    rot_f, trans_f = fm.apply(variables, x, jnp.asarray(label))
    assert rot.dtype == trans.dtype == torch.float32
    assert rot_f.dtype == trans_f.dtype == jnp.float32
    assert_bf16_close(rot.numpy(), rot_f, 1, 2)
    assert_bf16_close(trans.numpy(), trans_f, 1, 2)


# --------------------------------------------------------------------------
# the pyramid and the lookup on bf16 maps

def _bf16_levels(rng, rows, sizes):
    """Seeded float32 levels rounded to bf16: (torch bf16, jax bf16)."""
    lv = [torch.from_numpy(rng.normal(size=(rows, s * s)).astype(np.float32)).to(TB)
          for s in sizes]
    return lv, [jnp.asarray(m.float().numpy()).astype(BF) for m in lv]


def _flows(rng):
    return {"random": (3.0 * rng.normal(size=(3, 10, 10, 2))).astype(np.float32),
            "border": rng.uniform(-14, 14, (3, 10, 10, 2)).astype(np.float32),
            "integer": rng.integers(-6, 7, (3, 10, 10, 2)).astype(np.float32)}


def test_correlation_pyramid_bf16(rng):
    """out_dtype bf16 at C = 256: 1/sqrt(C) folded into feat1, one bf16 GEMM
    with float32 accumulation, one rounding; levels pooled in float32 and
    rounded once.  Level 0 equal to JAX's on all but 1e-3 of the entries
    (summation order), each within one bf16 ulp; the pooled levels too."""
    f1 = jnp.asarray(rng.normal(size=(2, 8, 8, 256)).astype(np.float32)).astype(BF)
    f2 = jnp.asarray(rng.normal(size=(2, 8, 8, 256)).astype(np.float32)).astype(BF)
    want = j_pyramid(f1, f2, 4, out_dtype=BF)
    got = correlation_pyramid_flat(torch.from_numpy(np.array(f1.astype(jnp.float32))).to(TB),
                                   torch.from_numpy(np.array(f2.astype(jnp.float32))).to(TB),
                                   4, out_dtype=TB)
    for g, w in zip(got, want):
        assert g.dtype == TB and w.dtype == BF
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        d = np.abs(g - w)
        assert (d > 0).mean() < 1e-3
        assert (d <= np.abs(w) * 2.0 ** -7 + 1e-6).all()


@pytest.mark.parametrize("variant", ["tent", "shift", "bdiag"])
@pytest.mark.parametrize("case", ["random", "border", "integer"])
def test_pallas_plain_versions_on_bf16_levels(variant, case, rng):
    """The 'pallas' backend's plain versions (what the card holds K1, K7
    and K8 to) against the TPU kernel of the variant in interpret mode on
    the same bf16 levels: both upcast the cells and compute in float32
    (atol 1e-5)."""
    lv, jlv = _bf16_levels(rng, 300, (10, 5, 3, 2))
    flow = _flows(rng)[case]
    got = corr_lookup(lv, torch.from_numpy(flow), backend="pallas", variant=variant)
    want = corr_lookup_pallas(jlv, jnp.asarray(flow), radius=4, interpret=True,
                              variant=variant)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["random", "border", "integer"])
def test_xla_backend_on_bf16_levels_rounds_the_weights(case, rng):
    """'xla' against scflow_tpu.ops.corr.corr_lookup at bf16, which rounds
    the tent weights to the map's dtype (atol 1e-5), and differs from the
    'pallas' backend, which does not, wherever a weight is not a bf16."""
    lv, jlv = _bf16_levels(rng, 300, (10, 5, 3, 2))
    flow = _flows(rng)[case]
    sizes = (10, 5, 3, 2)
    got = corr_lookup(lv, torch.from_numpy(flow), backend="xla")
    want = j_corr_lookup([m.reshape(-1, s, s, 1) for m, s in zip(jlv, sizes)],
                         jnp.asarray(flow), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    if case == "random":
        pallas = corr_lookup(lv, torch.from_numpy(flow), backend="pallas")
        assert (pallas - got).abs().max() > 1e-4


@pytest.mark.parametrize("case", ["random", "border", "integer"])
def test_k1b_plain_version_on_bf16_levels(case, rng):
    """K1b's plain version (the 'pallas' backward) against jax.vjp of
    corr_lookup_pallas_diff on the same bf16 levels: level grads bf16, each
    within one bf16 ulp of JAX's (two float32 sums in another order, each
    rounded once; 1e-6 where they cancel to about 0); the flow grad within
    1e-4 of its scale."""
    lv, jlv = _bf16_levels(rng, 300, (10, 5, 3, 2))
    flow = _flows(rng)[case]
    g = rng.normal(size=(3, 10, 10, 4 * 81)).astype(np.float32)
    gp_j, gf_j = jax.vjp(lambda p, f: corr_lookup_pallas_diff(p, f, 4, 256, True, "tent"),
                         tuple(jlv), jnp.asarray(flow))[1](jnp.asarray(g))
    tl = [m.clone().requires_grad_() for m in lv]
    fl = torch.from_numpy(flow).requires_grad_()
    corr_lookup(tl, fl, backend="pallas").backward(torch.from_numpy(g))
    for a, b in zip(tl, gp_j):
        assert a.grad.dtype == TB and b.dtype == BF
        a, b = a.grad.float().numpy(), np.asarray(b.astype(jnp.float32))
        assert (np.abs(a - b) <= np.abs(b) * 2.0 ** -7 + 1e-6).all()
    gf_j = np.asarray(gf_j)
    np.testing.assert_allclose(fl.grad.numpy(), gf_j, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(gf_j).max()))


def test_kernel_wrappers_refuse_other_map_dtypes():
    lv = [torch.zeros((4, s * s), dtype=torch.float16) for s in (2, 1)]
    coords = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        k1._check_inputs(lv, coords)
    with pytest.raises(ValueError, match="float32 coords"):
        k1._check_inputs([m.float() for m in lv], coords.double())
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        k1._check_inputs([lv[0].float(), lv[1].to(TB)], coords)
    assert k1._check_inputs([m.to(TB) for m in lv], coords) == [2, 1]
    assert k1.forward_kernel("shift", TB) is k1.SHIFT_KERNEL_BF16
    assert k1.bwd_kernel(torch.float32) is k1.BWD_KERNEL
