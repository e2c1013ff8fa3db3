"""The SCFlow decoder's and refiner's options against the JAX package on the
same numpy-seeded inputs and weights (flax variables carried across by
convert.state_dict_from_flax), at 64^2, batch 2, 2-3 iterations: radius
2/3/5, mask_flow / mask_corr / detach_mask, init_flow with a nonzero
invalid_flow_num, the 'Small' net with the Conv GRU, seperate_encoder with
GN and no-norm encoders, the quaternion and SingleClass heads, the 'linear'
depth transform, and the option set that chip_smoke.py runs on the card
(forward, and gradients from PyTorch's initialisation).

Bounds: every decoder output within rtol 2e-3, atol 2e-3
(tests/test_torch_train.py's decoder-output bound; float32 convolutions
sum in different orders and 2-3 iterations feed the poses back); the
option set's gradients per leaf within relative L2 2e-2, the train-step
tests' bound (tests/test_torch_train.py, from PyTorch's initialisation).  Every
combination the JAX package cannot run raises in the port; those where
JAX reads a name as another (an unknown GRU type or depth transform)
raise too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_tpu.models.scflow_decoder import SCFlowDecoder as FDecoder
from scflow_tpu_torch.convert import state_dict_from_flax
from scflow_tpu_torch.models.pose_head import ID_BIAS
from scflow_tpu_torch.models.scflow_decoder import SCFlowDecoder
from scflow_tpu_torch.refiners.scflow import SCFlowRefiner

from torch_port_helpers import (flax_from_port, keep_torch_rng, lecun_variables,  # noqa: F401
                                load_port, no_tf32, scflow_init_args, scflow_options_pair)

N, IMG, NCLASS = 2, 64, 3
TOL = dict(rtol=2e-3, atol=2e-3)
# the option set of chip_smoke.py's scflow_options phase
OPTION_SET = dict(seperate_encoder=True, radius=3, mask_flow=True, mask_corr=True,
                  detach_mask=False, gru_fuse_gates=True, depth_transform="linear",
                  pose_head_cfg=dict(type="MultiClassPoseHead", num_class=NCLASS,
                                     rotation_mode="quaternion"))


def _scene(seed=0, hole=False):
    """Poses, depth and intrinsics of N objects at about 400 mm; with hole,
    a quarter of each depth map is empty (the pose-induced flow there is
    invalid_flow_num)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    R = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                  2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                  2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                 -1).reshape(N, 3, 3).astype(np.float32)
    t = np.stack([rng.normal(size=N) * 5, rng.normal(size=N) * 5,
                  rng.uniform(380, 420, N)], -1).astype(np.float32)
    depth = (t[:, 2, None, None] + rng.uniform(-20, 20, (N, IMG, IMG))).astype(np.float32)
    if hole:
        depth[:, :IMG // 2, :IMG // 2] = 0.0
    K = np.tile(np.array([[[120.0, 0, IMG / 2], [0, 120.0, IMG / 2], [0, 0, 1]]], np.float32),
                (N, 1, 1))
    return R, t, depth, K, np.array([1, 2], np.int32)


def _features(net_type="Basic", cxt=128, seed=1):
    rng = np.random.default_rng(seed)
    h, hc = IMG // 8, {"Basic": 128, "Small": 96}[net_type]
    f1, f2 = (rng.normal(size=(N, h, h, 64)).astype(np.float32) for _ in range(2))
    return (f1, f2, np.tanh(rng.normal(size=(N, h, h, hc))).astype(np.float32),
            np.maximum(rng.normal(size=(N, h, h, cxt)), 0).astype(np.float32))


def _head_init(head, rng, mode="ortho6d", perturb=0.02):
    """JAX's identity bias on the rotation output, small random output
    kernels (lecun_variables zeroes biases and draws large kernels)."""
    for name in ("rotation_pred", "translation_pred"):
        head[name]["kernel"] = rng.normal(0, perturb, head[name]["kernel"].shape).astype(
            np.float32)
    b = np.asarray(ID_BIAS[mode], np.float32)
    head["rotation_pred"]["bias"] = np.tile(b, head["rotation_pred"]["bias"].size // b.size)


def _decoder_pair(iters=2, seed=0, net_type="Basic", cxt=128, **kw):
    """(flax decoder, variables, port decoder, inputs) with the same weights."""
    fdec = FDecoder(net_type=net_type, iters=iters, **kw)
    R, t, depth, K, label = _scene(seed, hole=True)
    inputs = (*_features(net_type, cxt, seed + 1), R, t, depth, K, label)
    variables = lecun_variables(fdec, seed, *map(jnp.asarray, inputs))
    mode = (kw.get("pose_head_cfg") or {}).get("rotation_mode", "ortho6d")
    _head_init(variables["params"]["update"]["pose_pred"], np.random.default_rng(seed), mode)
    with torch.random.fork_rng(devices=[]):
        port = SCFlowDecoder(num_class=21, image_size=(IMG, IMG), iters=iters, net_type=net_type,
                             cxt_channels=cxt, **kw)
    return fdec, variables, load_port(port, variables), inputs


def _run_decoder(fdec, variables, port, inputs, init_flow=None, invalid=0.0):
    kw = dict(init_flow=None if init_flow is None else jnp.asarray(init_flow),
              invalid_flow_num=invalid)
    want = jax.jit(lambda v, *a: fdec.apply(v, *a, lookup_backend="xla", **kw))(
        variables, *map(jnp.asarray, inputs))
    t = [torch.from_numpy(np.asarray(a)) for a in inputs]
    nchw = [x.permute(0, 3, 1, 2) for x in t[:4]]
    with torch.no_grad():
        got = port(*nchw, *t[4:], init_flow=None if init_flow is None else
                   torch.from_numpy(init_flow), invalid_flow_num=invalid, lookup_backend="pallas")
    return got, {k: np.asarray(v) for k, v in want.items()}


def _close(got, want, what=""):
    assert set(got) == set(want), what
    for k, w in want.items():
        assert got[k].shape == w.shape, (what, k)
        np.testing.assert_allclose(got[k].numpy(), w, err_msg=f"{what} {k}", **TOL)


@pytest.mark.parametrize("radius", [2, 3, 5])
def test_decoder_radius(radius, no_tf32):
    """The motion encoder's corr width 4 (2r+1)^2 and the lookup at radius r
    (the kernels' plain versions, 'pallas', against JAX's XLA lookup)."""
    fdec, variables, port, inputs = _decoder_pair(radius=radius, seed=radius)
    assert port.encoder.corr_net[0].conv.in_channels == 4 * (2 * radius + 1) ** 2
    _close(*_run_decoder(fdec, variables, port, inputs), f"radius {radius}")


@pytest.mark.parametrize("mask_flow,mask_corr", [(True, False), (False, True), (True, True)])
def test_decoder_mask_options(mask_flow, mask_corr, no_tf32):
    """The carried mask multiplies the flow the motion encoder reads and/or
    the lookup's output (detach_mask acts on gradients: the option set's
    gradient test)."""
    fdec, variables, port, inputs = _decoder_pair(mask_flow=mask_flow, mask_corr=mask_corr,
                                                  seed=7)
    _close(*_run_decoder(fdec, variables, port, inputs), f"{mask_flow} {mask_corr}")


def test_decoder_init_flow_and_invalid_flow_num(no_tf32):
    """A full-resolution warm start (downsampled to 1/8 and divided by 8)
    and invalid_flow_num 400 where a quarter of the depth is empty, in the
    tap reprojection and in the dense flow_from_pose."""
    fdec, variables, port, inputs = _decoder_pair(seed=8)
    init = (2.0 * np.random.default_rng(9).normal(size=(N, IMG, IMG, 2))).astype(np.float32)
    got, want = _run_decoder(fdec, variables, port, inputs, init_flow=init, invalid=400.0)
    assert (want["flow_from_pose"] == 400.0).mean() > 0.2
    _close(got, want, "init_flow")


def test_decoder_small_net_conv_gru_single_class_linear(no_tf32):
    """The 'Small' decoder (h 96, context 64, motion encoder 82 out) with the
    Conv GRU, fused gates, the SingleClassPoseHead and the 'linear' depth
    transform."""
    fdec, variables, port, inputs = _decoder_pair(
        seed=10, net_type="Small", cxt=64, gru_type="Conv", gru_fuse_gates=True,
        depth_transform="linear", pose_head_cfg=dict(type="SingleClassPoseHead"))
    assert port.pose_pred.rotation_pred.out_features == 6
    _close(*_run_decoder(fdec, variables, port, inputs), "Small")


def _refiner_inputs(seed=0):
    R, t, depth, K, label = _scene(seed)
    rng = np.random.default_rng(seed + 1)
    render, real = (rng.uniform(0, 1, (N, IMG, IMG, 3)).astype(np.float32) for _ in range(2))
    return render, real, R, t, depth, K, label


def _run_refiner(fmodel, variables, port, inputs, **kw):
    f = jax.jit(lambda v, *a: fmodel.apply(v, *a, lookup_backend="xla"))
    want = {k: np.asarray(v) for k, v in f(variables, *map(jnp.asarray, inputs)).items()}
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in inputs), lookup_backend="pallas", **kw)
    return got, want


@pytest.mark.parametrize("kw", [
    dict(seperate_encoder=True, encoder_norm="GN", cxt_norm=None, encoder_out_channels=128),
    dict(net_type="Small", h_channels=96, cxt_channels=64, encoder_norm=None, cxt_norm="BN",
         pose_head_cfg=dict(type="SingleClassPoseHead", rotation_mode="quaternion")),
    dict(cxt_channels=64, encoder_norm="BN", cxt_norm="IN", num_levels=4, radius=2)])
def test_refiner_options(kw, no_tf32):
    """Whole refiners: a separate real encoder (two passes) with GN and a
    norm-free context; the 'Small' net with a norm-free encoder and a
    SingleClass quaternion head; a 64-wide context (which JAX infers) with
    BatchNorm feature encoders (their doubled batch's statistics in
    training; eval mode here) at radius 2."""
    fmodel, variables, port = scflow_options_pair(IMG, 2, seed=11, **kw)
    if kw.get("seperate_encoder"):
        assert any(k.startswith("real_encoder.") for k in port.state_dict())
    _close(*_run_refiner(fmodel, variables, port, _refiner_inputs(12)), str(kw))


def test_option_set_forward(no_tf32):
    """chip_smoke.py's option set: separate encoders, radius 3, both masks,
    the mask not detached, fused gates, the 'linear' transform and the
    quaternion head, 3 iterations, init_flow given."""
    fmodel, variables, port = scflow_options_pair(IMG, 3, seed=13, **OPTION_SET)
    inputs = _refiner_inputs(14)
    init = (np.random.default_rng(15).normal(size=(N, IMG, IMG, 2))).astype(np.float32)
    f = jax.jit(lambda v, *a: fmodel.apply(v, *a[:-1], init_flow=a[-1], lookup_backend="xla"))
    want = {k: np.asarray(v) for k, v in f(variables, *map(jnp.asarray, inputs + (init,))).items()}
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in inputs), init_flow=torch.from_numpy(init),
                   lookup_backend="pallas")
    assert want["delta_rotations"].shape[-1] == 4
    assert np.abs(want["translations"][-1] - inputs[3]).max() > 0.5  # the poses moved
    _close(got, want, "option set")


def test_option_set_bf16_matches_jax_bf16(monkeypatch, no_tf32):
    """The option set at dtype=bfloat16 (fused gates casting [h, x] and their
    concatenated weights to bf16, the bf16 mask carried and multiplied into
    corr and flow, radius 3) against flax at bfloat16 on the same weights, 3
    iterations, lookup 'pallas' on both sides (the port's K1 bf16 plain
    version; JAX's kernel in interpret mode).  The bound is that of
    tests/test_torch_bf16_system.py::test_refiner_bf16_matches_jax_bf16:
    every iteration's pose within twice JAX's own bf16-to-fp32 distance,
    plus the fp32 parity tolerance (rotations 2e-3, translations 2e-2 mm),
    of JAX's fp32 pose.  Poses come back float32 in both packages."""
    from test_torch_train import _interpret_lookup

    _interpret_lookup(monkeypatch)
    fmodel, variables, port = scflow_options_pair(IMG, 3, seed=13, **OPTION_SET)
    with torch.random.fork_rng(devices=[]):
        port16 = SCFlowRefiner(num_class=NCLASS, image_size=(IMG, IMG), iters=3,
                               dtype=torch.bfloat16, **OPTION_SET)
    port16.load_state_dict(port.state_dict(), strict=True)
    port16.eval()
    inputs = _refiner_inputs(14)
    j32, j16 = (jax.jit(lambda v, *a, m=m: m.apply(v, *a, pose_only=True,
                                                   lookup_backend="pallas"))(
        variables, *map(jnp.asarray, inputs)) for m in (fmodel, fmodel.clone(dtype=jnp.bfloat16)))
    with torch.no_grad():
        t16 = port16(*(torch.from_numpy(a) for a in inputs), pose_only=True,
                     lookup_backend="pallas")
    assert t16["rotations"].dtype == t16["translations"].dtype == torch.float32
    for key, tol in (("rotations", 2e-3), ("translations", 2e-2)):
        assert str(j16[key].dtype) == "float32"
        ref = np.asarray(j32[key])
        jax_dist = float(np.abs(np.asarray(j16[key]) - ref).max())
        port_dist = float(np.abs(t16[key].numpy() - ref).max())
        assert jax_dist > 0  # bf16 moved the poses: the bound is not vacuous
        assert port_dist <= 2 * jax_dist + tol, (key, port_dist, jax_dist)


def _loss_terms(out, gt_R, gt_t):
    """A scalar of every output the train step's losses read: poses, the
    predicted flow and the masks, weighted per iteration as the sequence
    loss is."""
    T = out["rotations"].shape[0]
    total = 0.0
    for i in range(T):
        w = 0.8 ** (T - 1 - i)
        total = total + w * (abs(out["rotations"][i] - gt_R).mean()
                             + abs(out["translations"][i] - gt_t).mean() / 10.0
                             + abs(out["flow_from_pred"][i]).mean()
                             + abs(out["masks"][i] - 0.5).mean())
    return total


def test_option_set_gradients(no_tf32):
    """Gradients of every parameter through the option set's training
    forward (BatchNorm on batch statistics, the undetached mask, the fused
    gates, the quaternion head), from PyTorch's initialisation carried to
    flax by the weight bridge's mapping, per leaf within relative L2 2e-2,
    skipping leaves whose gradient is below 1e-5 of the global norm (as
    tests/test_torch_train.py)."""
    kw = dict(OPTION_SET)
    fmodel, template, _ = scflow_options_pair(IMG, 2, seed=16, **kw)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(16)
        port = SCFlowRefiner(num_class=NCLASS, image_size=(IMG, IMG), iters=2, **kw)
        head = port.decoder.pose_pred
        with torch.no_grad():
            for lin in (head.rotation_pred, head.translation_pred):
                lin.weight.normal_(0.0, 0.005)
    variables = flax_from_port(template, port.state_dict())
    inputs = _refiner_inputs(17)
    gt_R, gt_t = inputs[2], inputs[3] + np.float32(5.0)

    def jax_loss(params):
        out, _ = fmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              *map(jnp.asarray, inputs), train=True, lookup_backend="xla",
                              mutable=["batch_stats"])
        return _loss_terms(out, jnp.asarray(gt_R), jnp.asarray(gt_t))

    want_loss, jgrads = jax.jit(jax.value_and_grad(jax_loss))(variables["params"])
    want = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    port.train()
    out = port(*(torch.from_numpy(a) for a in inputs), train=True, lookup_backend="pallas")
    loss = _loss_terms(out, torch.from_numpy(gt_R), torch.from_numpy(gt_t))
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


@pytest.mark.parametrize("kw,jax_fails", [
    (dict(num_levels=3), True),  # the 1/4-scale decoder meets 1/8 maps
    (dict(net_type="Large"), True),  # no decoder widths (JAX: KeyError)
    (dict(net_type="Small"), True),  # 'Basic' h_channels against the 96-wide GRU
    (dict(gru_type="conv"), False),  # JAX runs 'SeqConv'
    (dict(depth_transform="Exp"), False),  # JAX runs 'linear'
    (dict(unroll=1), False),
    (dict(scan_unroll=0), False),
])
def test_refiner_rejects(kw, jax_fails):
    """Each combination JAX cannot run raises at construction (JAX fails at
    its first trace), and each name JAX reads as another raises too."""
    from scflow_tpu.refiners import SCFlowRefiner as FlaxRefiner

    if jax_fails:
        with pytest.raises(Exception):
            jax.eval_shape(FlaxRefiner(iters=1, **kw).init, jax.random.PRNGKey(0),
                           *scflow_init_args(1, IMG))
    with pytest.raises((ValueError, TypeError)):
        SCFlowRefiner(num_class=NCLASS, image_size=(IMG, IMG), **kw)
