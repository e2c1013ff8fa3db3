"""The network modules' options, each against its flax module on the same
numpy-seeded inputs, with flax weights carried across by
convert.state_dict_from_flax: the encoders' net types and norms, the
motion encoder's net types and corr widths, the Conv GRU and fused gates,
XHead layer widths, both pose heads and rotation modes, the quaternion
delta and the 'linear' depth transform, and the non-square pyramid and
lookup (the JAX package's own route, outside its kernels).

atol 2e-4 on module outputs, as tests/test_torch_models.py (the two
packages' float32 convolutions sum in different orders); 1e-5 on the
geometry; 1e-4 on the lookup (tests/test_torch_corr.py's bound).  Each
combination the JAX package cannot run raises in the port, and each test
of one shows JAX failing too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_tpu.geometry import rotation as jrot
from scflow_tpu.geometry.se3 import apply_delta_pose as j_apply_delta_pose
from scflow_tpu.models import ConvGRU as FGRU
from scflow_tpu.models import MotionEncoder as FMotion
from scflow_tpu.models import RAFTEncoder as FEncoder
from scflow_tpu.models import XHead as FXHead
from scflow_tpu.models.pose_head import MultiClassPoseHead as FMulti
from scflow_tpu.models.pose_head import SingleClassPoseHead as FSingle
from scflow_tpu.ops import corr as jcorr
from scflow_tpu_torch import geometry as tg
from scflow_tpu_torch.convert import state_dict_from_flax
from scflow_tpu_torch.models.motion import ConvGRU, MotionEncoder, XHead
from scflow_tpu_torch.models.pose_head import (MultiClassPoseHead, SingleClassPoseHead,
                                               build_pose_head)
from scflow_tpu_torch.models.raft_encoder import RAFTEncoder
from scflow_tpu_torch.ops.corr import corr_lookup, correlation_pyramid_flat

from torch_port_helpers import keep_torch_rng, lecun_variables, load_port, no_tf32  # noqa: F401

ATOL = 2e-4


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _stats(variables, rng):
    """Non-trivial BatchNorm running statistics and norm scales."""
    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "mean":
                tree[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
            elif k in ("var", "scale"):
                tree[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    for coll in variables.values():
        walk(coll)
    return variables


@pytest.mark.parametrize("net_type,norm", [
    ("Basic", None), ("Basic", "GN"), ("Small", "BN"), ("Small", "IN"), ("Small", None),
    ("Large", "IN")])
def test_encoder_net_types_and_norms(net_type, norm, rng, no_tf32):
    """Eval mode; 'Small' with BN also in training mode (batch statistics,
    and the running ones it updates, norm3's and the downsample's
    included)."""
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    fm = FEncoder(net_type=net_type, norm=norm, out_channels=64)
    variables = _stats(lecun_variables(fm, 1, jnp.asarray(x)), rng)
    tm = load_port(RAFTEncoder(64, norm, net_type=net_type), variables, cxt_norm=norm)
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    want = np.asarray(jax.jit(fm.apply)(variables, jnp.asarray(x)))
    assert got.shape == want.shape == (2,) + ((16, 16) if net_type == "Large" else (8, 8)) + (64,)
    np.testing.assert_allclose(got, want, atol=ATOL)
    if norm == "BN":
        want, upd = jax.jit(lambda v, a: fm.apply(v, a, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
        with torch.no_grad():
            got = nhwc(tm(nchw(x), train=True))
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
        sd = state_dict_from_flax({"batch_stats": jax.tree_util.tree_map(np.asarray, upd)
                                   ["batch_stats"]}, cxt_norm="BN")
        for k, v in sd.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(tm.state_dict()[k].numpy(), v.numpy(), atol=1e-5,
                                           err_msg=k)


def test_small_encoder_rejects_group_norm():
    """flax's GroupNorm (32 groups) fails on the 'Small' net's 8-plane
    stage, and so does the port's."""
    fm = FEncoder(net_type="Small", norm="GN")
    with pytest.raises(ValueError, match="groups"):
        jax.eval_shape(fm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    with pytest.raises(ValueError):
        RAFTEncoder(64, "GN", net_type="Small")


@pytest.mark.parametrize("net_type,radius", [("Small", 3), ("Basic", 2), ("Basic", 5),
                                             ("Large", 4)])
def test_motion_encoder_net_types_and_radii(net_type, radius, rng, no_tf32):
    """Corr width 4 (2r+1)^2; 'Small' has its own widths (82 out)."""
    corr = rng.normal(size=(2, 8, 8, 4 * (2 * radius + 1) ** 2)).astype(np.float32)
    flow = rng.normal(size=(2, 8, 8, 2)).astype(np.float32)
    fm = FMotion(net_type=net_type)
    variables = lecun_variables(fm, 2, jnp.asarray(corr), jnp.asarray(flow))
    tm = load_port(MotionEncoder(None, net_type, 4, radius), variables)
    with torch.no_grad():
        got = nhwc(tm(nchw(corr), nchw(flow)))
    want = np.asarray(jax.jit(fm.apply)(variables, jnp.asarray(corr), jnp.asarray(flow)))
    assert got.shape[-1] == tm.out_channels == fm.out_channels
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("net_type,fuse", [("Conv", False), ("Conv", True), ("SeqConv", True)])
def test_conv_gru_types_and_fused_gates(net_type, fuse, rng, no_tf32):
    """Fused gates run z and r as one convolution on the same parameter
    tree: the unfused module's weights load into the fused one."""
    h = np.tanh(rng.normal(size=(2, 8, 8, 96))).astype(np.float32)
    x = rng.normal(size=(2, 8, 8, 146)).astype(np.float32)
    unfused = FGRU(96, net_type=net_type)
    variables = lecun_variables(unfused, 3, jnp.asarray(h), jnp.asarray(x))
    fm = FGRU(96, net_type=net_type, fuse_gates=fuse)
    tm = load_port(ConvGRU(96, 146, None, net_type, fuse), variables)
    with torch.no_grad():
        got = nhwc(tm(nchw(h), nchw(x)))
    want = np.asarray(jax.jit(fm.apply)(variables, jnp.asarray(h), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_conv_gru_rejects_unknown_type():
    """The JAX GRU reads any name but 'Conv' as 'SeqConv' (ROADMAP §3); the
    port raises."""
    with pytest.raises(ValueError, match="GRU net_type"):
        ConvGRU(96, 146, net_type="Seqconv")


def test_xhead_layer_widths(rng, no_tf32):
    x = rng.normal(size=(2, 8, 8, 96)).astype(np.float32)
    fm = FXHead((64, 32), 5, kind="mask")
    variables = lecun_variables(fm, 4, jnp.asarray(x))
    tm = load_port(XHead(96, (64, 32), 5, kind="mask"), variables)
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jax.jit(fm.apply)(variables, jnp.asarray(x))),
                               atol=ATOL)


@pytest.mark.parametrize("head,mode", [("Multi", "quaternion"), ("Single", "ortho6d"),
                                       ("Single", "quaternion")])
def test_pose_heads_and_rotation_modes(head, mode, rng, no_tf32):
    """Per-sample labels differ; SingleClassPoseHead ignores them.  Output
    kernels non-zero, the biases the identity of the mode (JAX's init)."""
    x = rng.normal(size=(3, 8, 8, 192)).astype(np.float32)
    label = np.array([2, 0, 3])
    fm = FMulti(num_class=4, rotation_mode=mode) if head == "Multi" else FSingle(
        rotation_mode=mode)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(fm.init)(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(label)))
    for name in ("rotation_pred", "translation_pred"):
        k = variables["params"][name]["kernel"]
        variables["params"][name]["kernel"] = rng.normal(0, 0.05, k.shape).astype(np.float32)
    sd = state_dict_from_flax({"params": {"pose_pred": variables["params"]}})
    cfg = {"type": f"{head}ClassPoseHead", "rotation_mode": mode, "num_class": 4}
    tm = build_pose_head(cfg, 21, 192, (8, 8)).eval()
    assert isinstance(tm, MultiClassPoseHead if head == "Multi" else SingleClassPoseHead)
    tm.load_state_dict({k[len("pose_pred."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        rot, trans = tm(nchw(x), torch.from_numpy(label))
    rot_f, trans_f = jax.jit(fm.apply)(variables, jnp.asarray(x), jnp.asarray(label))
    assert rot.shape == rot_f.shape == (3, 4 if mode == "quaternion" else 6)
    np.testing.assert_allclose(rot.numpy(), np.asarray(rot_f), atol=ATOL)
    np.testing.assert_allclose(trans.numpy(), np.asarray(trans_f), atol=ATOL)


def test_pose_head_cfg_rejects_unknown_names():
    """An unknown head type or rotation mode is a KeyError in both
    packages (the JAX decoder's _build_pose_head, and _ID_BIAS at the
    head's first call)."""
    from scflow_tpu.models.scflow_decoder import _SCFlowUpdate

    with pytest.raises(KeyError):
        _SCFlowUpdate(pose_head_cfg={"type": "PoseHead"})._build_pose_head()
    with pytest.raises(KeyError):
        build_pose_head({"type": "PoseHead"}, 21, 192, (8, 8))
    x, label = jnp.zeros((1, 8, 8, 192)), jnp.zeros((1,), jnp.int32)
    with pytest.raises(KeyError):
        jax.eval_shape(FMulti(rotation_mode="euler").init, jax.random.PRNGKey(0), x, label)
    with pytest.raises(KeyError):
        build_pose_head({"type": "MultiClassPoseHead", "rotation_mode": "euler"}, 21, 192,
                        (8, 8))


def test_rotmat_from_quat(rng):
    q = rng.normal(size=(16, 4)).astype(np.float32)
    q[0] = [0, 0, 0, 1]
    got = tg.rotmat_from_quat(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, np.asarray(jrot.rotmat_from_quat(jnp.asarray(q))), atol=1e-6)
    np.testing.assert_allclose(got[0], np.eye(3), atol=0)


@pytest.mark.parametrize("rot_dim,transform", [(4, "exp"), (6, "linear"), (4, "linear")])
def test_apply_delta_pose_quaternion_and_linear(rot_dim, transform, rng):
    """The quaternion delta and the 'linear' depth transform against JAX,
    values and the gradients of both packages' autodiff."""
    n = 8
    d_rot = rng.normal(size=(n, rot_dim)).astype(np.float32)
    d_t = (0.1 * rng.normal(size=(n, 3))).astype(np.float32)
    R = np.asarray(jrot.rotmat_from_ortho6d(jnp.asarray(rng.normal(size=(n, 6)),
                                                        jnp.float32)))
    t = np.stack([rng.normal(size=n), rng.normal(size=n), rng.uniform(500, 900, n)],
                 -1).astype(np.float32)

    def jax_loss(dr, dt):
        Rj, tj = j_apply_delta_pose(dr, dt, jnp.asarray(R), jnp.asarray(t),
                                    depth_transform=transform)
        return jnp.sum(Rj * jnp.arange(9.0).reshape(3, 3)) + jnp.sum(tj) / 100.0

    want = jax.value_and_grad(jax_loss, argnums=(0, 1))(jnp.asarray(d_rot), jnp.asarray(d_t))
    dr_t = torch.from_numpy(d_rot).requires_grad_()
    dt_t = torch.from_numpy(d_t).requires_grad_()
    Rt, tt = tg.apply_delta_pose(dr_t, dt_t, torch.from_numpy(R), torch.from_numpy(t),
                                 depth_transform=transform)
    loss = (Rt * torch.arange(9.0).reshape(3, 3)).sum() + tt.sum() / 100.0
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want[0]), rtol=1e-5)
    np.testing.assert_allclose(dr_t.grad.numpy(), np.asarray(want[1][0]), atol=1e-5)
    np.testing.assert_allclose(dt_t.grad.numpy(), np.asarray(want[1][1]), atol=1e-5, rtol=1e-5)


def test_apply_delta_pose_rejects_unknown_transform():
    """JAX reads any name but 'exp' as 'linear' (ROADMAP §3); the port
    raises."""
    d_rot, d_t = jnp.asarray([[1.0, 0, 0, 0, 1, 0]]), jnp.asarray([[0.0, 0.0, 0.5]])
    R, t = jnp.eye(3)[None], jnp.asarray([[0.0, 0.0, 700.0]])
    _, t_typo = j_apply_delta_pose(d_rot, d_t, R, t, depth_transform="Exp")
    _, t_lin = j_apply_delta_pose(d_rot, d_t, R, t, depth_transform="linear")
    np.testing.assert_array_equal(np.asarray(t_typo), np.asarray(t_lin))
    with pytest.raises(ValueError, match="depth_transform"):
        tg.apply_delta_pose(torch.tensor([[1.0, 0, 0, 0, 1, 0]]), torch.tensor([[0.0, 0, 0.5]]),
                            torch.eye(3)[None], torch.tensor([[0.0, 0, 700]]),
                            depth_transform="Exp")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_square_pyramid_and_lookup(dtype, rng, no_tf32):
    """The 1/8 maps of a 256x192 crop (32x24): JAX builds its 4-D pyramid and
    its dispatch falls back from 'pallas' to the XLA lookup; the port keeps
    the levels flat and takes its 'xla' formulation whatever the backend.
    Values and the gradients into both feature maps and the flow (JAX's
    autodiff of the XLA tent, with its subgradients at integer centres)."""
    n, h, w, c = 1, 32, 24, 16
    f1, f2 = (rng.normal(size=(n, h, w, c)).astype(np.float32) for _ in range(2))
    flow = (3.0 * rng.normal(size=(n, h, w, 2))).astype(np.float32)
    flow[:, ::3] = np.round(flow[:, ::3])  # integer centres too
    g = rng.normal(size=(n, h, w, 4 * 49)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    tdt = torch.bfloat16 if dtype == "bfloat16" else None

    def jax_loss(a, b, fl):
        pyr = jcorr.correlation_pyramid(a, b, 4, out_dtype=jdt)
        return jnp.sum(jcorr.corr_lookup_dispatch(pyr, fl, 3, backend="pallas") * g), pyr

    # bf16 models hand the pyramid bf16 features (the encoders' dtype)
    (want, pyr), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(f1, jdt), jnp.asarray(f2, jdt), jnp.asarray(flow))
    a, b = (torch.from_numpy(v).to(tdt or torch.float32).requires_grad_() for v in (f1, f2))
    fl = torch.from_numpy(flow).requires_grad_()
    levels = correlation_pyramid_flat(a, b, 4, out_dtype=tdt)
    for got_l, want_l in zip(levels, pyr):
        assert got_l.dtype == (torch.bfloat16 if tdt else torch.float32)
        np.testing.assert_allclose(got_l.detach().float().numpy(),
                                   np.asarray(want_l, np.float32).reshape(got_l.shape),
                                   atol=1e-5, rtol=1e-5)
    out = corr_lookup(levels, fl, 3, backend="pallas")
    loss = (out * torch.from_numpy(g)).sum()
    loss.backward()
    scale = np.abs(np.asarray(grads[0], np.float32)).max()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4)
    for got_g, want_g in zip((a.grad, b.grad, fl.grad), grads):
        want_g = np.asarray(want_g, np.float32)
        atol = 1e-4 * max(1.0, np.abs(want_g).max()) if tdt is None else 2e-2 * scale
        np.testing.assert_allclose(got_g.float().numpy(), want_g, atol=atol)
    with pytest.raises(ValueError, match="square"):
        corr_lookup(levels, fl, 3, backend="pallas", variant="shift")


def _bf16_case(case, rng):
    """(flax module, port module, inputs (numpy NHWC), port input dtypes) of
    one bf16 option case; h is the bf16 hidden state (tanh of the bf16
    context), x the float32 motion features."""
    from test_torch_bf16 import BF, TB

    if case.startswith("encoder"):
        _, net_type, norm = case.split("-")
        norm = None if norm == "none" else norm
        x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
        return (FEncoder(net_type=net_type, norm=norm, out_channels=64, dtype=BF),
                RAFTEncoder(64, norm, net_type=net_type, dtype=TB), (x,), (None,), norm)
    if case == "motion-Small-r3":
        corr = rng.normal(size=(2, 8, 8, 4 * 49)).astype(np.float32)
        flow = rng.normal(size=(2, 8, 8, 2)).astype(np.float32)
        return (FMotion(net_type="Small", dtype=BF), MotionEncoder(TB, "Small", 4, 3),
                (corr, flow), (None, None), None)
    _, net_type, fuse = case.split("-")
    h = np.asarray(jnp.asarray(np.tanh(rng.normal(size=(2, 8, 8, 96)))).astype(BF)
                   .astype(jnp.float32))
    x = rng.normal(size=(2, 8, 8, 146)).astype(np.float32)
    return (FGRU(96, net_type=net_type, fuse_gates=fuse == "fused", dtype=BF),
            ConvGRU(96, 146, TB, net_type, fuse == "fused"), (h, x), (TB, None), None)


@pytest.mark.parametrize("case", [
    "encoder-Small-IN", "encoder-Small-none", "encoder-Basic-none", "motion-Small-r3",
    "gru-Conv-unfused", "gru-Conv-fused", "gru-SeqConv-fused"])
def test_options_bf16(case, rng, no_tf32):
    """The options' modules at dtype=bfloat16 against flax at bfloat16.  The
    bound is JAX's own bf16-to-fp32 distance d on the same inputs and
    weights: the port's bf16 output within 2 d of JAX's (relative L2, and
    the largest element within twice JAX's largest plus the float32 ATOL).
    The two packages round independently where their float32 sums differ
    in order (InstanceNorm's statistics), so they can sit about as far
    apart as each from fp32 (the 'Small' IN encoder: measured 4.8-10 ulps
    apart, d 11.5 ulps); with no norm or BN they agree bit for bit.  The
    fused gates cast [h, x], the concatenated kernels and biases to bf16
    themselves, as the JAX module's _conv2d does."""
    from test_torch_bf16 import BF, TB

    fm, tm, inputs, tdts, norm = _bf16_case(case, rng)
    jin = tuple(jnp.asarray(a).astype(BF) if d is TB else jnp.asarray(a)
                for a, d in zip(inputs, tdts))
    variables = _stats(lecun_variables(fm, 4, *jin), rng)
    tm = load_port(tm, variables, cxt_norm=norm)
    with torch.no_grad():
        got = tm(*(nchw(a).to(d or torch.float32) for a, d in zip(inputs, tdts)))
    want = jax.jit(fm.apply)(variables, *jin)
    want32 = np.asarray(jax.jit(fm.clone(dtype=None).apply)(variables, *map(jnp.asarray, inputs)))
    assert got.dtype == getattr(torch, str(want.dtype))
    got, want = nhwc(got.float()), np.asarray(want.astype(jnp.float32))

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    d = rel(want, want32)
    assert d > 0  # bf16 moved JAX's output: the bound is not vacuous
    assert rel(got, want) <= 2 * d, (rel(got, want), d)
    assert np.abs(got - want).max() <= 2 * np.abs(want - want32).max() + ATOL
