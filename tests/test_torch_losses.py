"""The train step's pieces against the JAX package on seeded numpy inputs:
gt-flow geometry and its mask filter, nearest points, the flow, mask and
point-matching losses, the flax-style BatchNorm in training mode, the
resize, the loss bank, the OneCycle schedule and one AdamW + clip update.

Tolerances: fp32 elementwise maths at rtol/atol 1e-5 (1e-4 where a
matmul's order of summation enters); the mask filter and the nearest
points compare discrete results exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from scflow_tpu.geometry import flow as jflow
from scflow_tpu.geometry.se3 import apply_delta_pose as j_apply_delta_pose
from scflow_tpu.losses import basic as jbasic
from scflow_tpu.losses import point_matching as jpm
from scflow_tpu.ops.knn import nn_points as j_nn_points
from scflow_tpu.ops.resize import interpolate_bilinear as j_interpolate
from scflow_tpu.render.meshbank import make_synthetic_bank as j_bank
from scflow_tpu.runtime import build_optimizer as j_build_optimizer
from scflow_tpu.runtime.optim import onecycle_lr as j_onecycle
from scflow_tpu_torch import geometry as tg
from scflow_tpu_torch.losses import basic as tbasic
from scflow_tpu_torch.losses import point_matching as tpm
from scflow_tpu_torch.models.layers import BatchNorm
from scflow_tpu_torch.ops.knn import nn_points
from scflow_tpu_torch.ops.resize import interpolate_bilinear
from scflow_tpu_torch.render.meshbank import make_synthetic_bank
from scflow_tpu_torch.runtime.optim import build_optimizer, onecycle_lr

from torch_port_helpers import keep_torch_rng  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _poses(rng, n):
    from scipy.spatial.transform import Rotation

    R = Rotation.random(n, rng).as_matrix().astype(np.float32)
    t = np.stack([rng.normal(size=n) * 10, rng.normal(size=n) * 10,
                  rng.uniform(380, 450, n)], -1).astype(np.float32)
    return R, t


@pytest.fixture(scope="module")
def flow_case():
    """A blob of depth under a ref pose, a nearby gt pose and a gt mask."""
    rng = np.random.default_rng(3)
    n, h = 2, 48
    R, t = _poses(rng, n)
    R2, t2 = _poses(np.random.default_rng(4), n)
    R2 = (0.9 * R + 0.1 * R2).astype(np.float32)  # near, not orthonormal: fine for flow
    t2 = (t + rng.normal(size=(n, 3)) * [3.0, 3.0, 10.0]).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:h]
    blob = ((yy - 20) ** 2 + (xx - 26) ** 2) < 15 ** 2
    depth = np.where(blob, 400.0 + 0.3 * yy + 0.2 * xx, 0.0)[None].repeat(n, 0).astype(np.float32)
    K = np.tile(np.array([[[90.0, 0, 24], [0, 90.0, 24], [0, 0, 1]]], np.float32), (n, 1, 1))
    gt_mask = (((yy - 22) ** 2 + (xx - 23) ** 2) < 14 ** 2)[None].repeat(n, 0).astype(np.float32)
    return R, t, R2, t2, depth, K, gt_mask


def test_flow_from_pose_and_depth(flow_case):
    R, t, R2, t2, depth, K, _ = flow_case
    want = np.asarray(jflow.flow_from_pose_and_depth(*map(jnp.asarray, (R, t, R2, t2, depth, K))))
    got = tg.flow_from_pose_and_depth(*map(_t, (R, t, R2, t2, depth, K))).numpy()
    assert (want == 400.0).any() and (want != 400.0).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_filter_flow_by_mask(flow_case):
    """Exact: the sampled mask is compared with 0.9, so the result is
    discrete; the port samples in the JAX package's order of operations."""
    R, t, R2, t2, depth, K, gt_mask = flow_case
    flow = np.asarray(jflow.flow_from_pose_and_depth(*map(jnp.asarray, (R, t, R2, t2, depth, K))))
    want = np.asarray(jflow.filter_flow_by_mask(jnp.asarray(flow), jnp.asarray(gt_mask), 400.0))
    got = tg.filter_flow_by_mask(_t(flow), _t(gt_mask), 400.0).numpy()
    kept = want != 400.0
    assert kept.any() and (kept != (flow != 400.0)).any()  # the filter removed pixels
    np.testing.assert_array_equal(got, want)


def test_apply_delta_pose_detach_depth_for_xy(rng):
    """Values, and the gradient into dz with v_z detached in x/y."""
    R, t = _poses(rng, 3)
    d_rot = (np.array([1.0, 0, 0, 0, 1.0, 0]) + 0.05 * rng.normal(size=(3, 6))).astype(np.float32)
    d_t = (0.1 * rng.normal(size=(3, 3))).astype(np.float32)
    w = rng.normal(size=(3, 3)).astype(np.float32)
    for detach in (False, True):
        def f(dt):
            return jnp.sum(j_apply_delta_pose(jnp.asarray(d_rot), dt, jnp.asarray(R), jnp.asarray(t),
                                              detach_depth_for_xy=detach)[1] * w)
        g_want = np.asarray(jax.grad(f)(jnp.asarray(d_t)))
        dt = _t(d_t).requires_grad_()
        R_got, t_got = tg.apply_delta_pose(_t(d_rot), dt, _t(R), _t(t), detach_depth_for_xy=detach)
        (t_got * _t(w)).sum().backward()
        np.testing.assert_allclose(dt.grad.numpy(), g_want, rtol=1e-5, atol=1e-5)
    R_want, t_want = j_apply_delta_pose(jnp.asarray(d_rot), jnp.asarray(d_t), jnp.asarray(R),
                                        jnp.asarray(t))
    np.testing.assert_allclose(R_got.detach().numpy(), np.asarray(R_want), atol=1e-6)
    np.testing.assert_allclose(t_got.detach().numpy(), np.asarray(t_want), rtol=1e-6)


def test_nn_points(rng):
    query = rng.normal(size=(2, 50, 3)).astype(np.float32)
    ref = rng.normal(size=(2, 40, 3)).astype(np.float32)
    valid = rng.random((2, 40)) > 0.3
    i_want, d_want = j_nn_points(jnp.asarray(query), jnp.asarray(ref), jnp.asarray(valid))
    i_got, d_got = nn_points(_t(query), _t(ref), _t(valid))
    np.testing.assert_array_equal(i_got.numpy(), np.asarray(i_want))
    assert valid[np.arange(2)[:, None], i_got.numpy()].all()
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_want), rtol=1e-4, atol=1e-5)


def test_raft_and_l1_losses(rng):
    pred = (5 * rng.normal(size=(2, 16, 16, 2))).astype(np.float32)
    gt = (5 * rng.normal(size=(2, 16, 16, 2))).astype(np.float32)
    gt[0, :4] = 400.0  # invalid flow
    valid = (rng.random((2, 16, 16)) > 0.4).astype(np.float32)
    want = jbasic.raft_loss(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(valid), 400.0)
    np.testing.assert_allclose(float(tbasic.raft_loss(_t(pred), _t(gt), _t(valid), 400.0)),
                               float(want), rtol=1e-5)
    mask = rng.random((2, 16, 16)).astype(np.float32)
    occ = (gt.sum(-1) < 400.0).astype(np.float32)
    # unmasked on both sides: JAX's `valid` is ignored
    want = jbasic.l1_loss(jnp.asarray(mask), jnp.asarray(occ), jnp.asarray(valid))
    np.testing.assert_allclose(float(tbasic.l1_loss(_t(mask), _t(occ))), float(want), rtol=1e-6)


@pytest.mark.parametrize("disentangle_z,loss_type", [(True, 1), (False, 2)])
def test_disentangle_point_matching_loss(rng, disentangle_z, loss_type):
    """Classes 0-2 with class 1 symmetric (nearest-point matched), on the
    subsampled bank; value and gradients into the predicted pose."""
    bank = j_bank(3, kind="sphere", size=120.0, subdivisions=2).subsample(60)
    tbank = make_synthetic_bank(3, kind="sphere", size=120.0, subdivisions=2).subsample(60)
    np.testing.assert_array_equal(tbank.verts, bank.verts)
    sym = jpm.sym_mask_from_types({"cls_2": {"z": 0}}, 3)
    np.testing.assert_array_equal(tpm.sym_mask_from_types({"cls_2": {"z": 0}}, 3), np.asarray(sym))
    gt_R, gt_t = _poses(rng, 4)
    pred_R, _ = _poses(np.random.default_rng(7), 4)
    pred_R = (0.8 * gt_R + 0.2 * pred_R).astype(np.float32)
    pred_t = (gt_t + rng.normal(size=(4, 3)) * [4.0, 4.0, 12.0]).astype(np.float32)
    labels = np.array([0, 1, 2, 1], np.int32)
    bank_args = (bank.verts, bank.vert_valid, np.asarray(sym), bank.diameters)
    kw = dict(loss_type=loss_type, disentangle_z=disentangle_z, loss_weight=10.0)

    def f(r, tt):
        return jpm.disentangle_point_matching_loss(r, tt, jnp.asarray(gt_R), jnp.asarray(gt_t),
                                                   jnp.asarray(labels),
                                                   *map(jnp.asarray, bank_args), **kw)

    want, (gr_want, gt_want) = jax.value_and_grad(f, (0, 1))(jnp.asarray(pred_R), jnp.asarray(pred_t))
    r, tt = _t(pred_R).requires_grad_(), _t(pred_t).requires_grad_()
    got = tpm.disentangle_point_matching_loss(r, tt, _t(gt_R), _t(gt_t), _t(labels),
                                              *map(_t, bank_args), **kw)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(gr_want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt_want), rtol=1e-4, atol=1e-6)


def test_batchnorm_training_matches_flax(rng):
    """Batch statistics with the single-pass variance, and flax's running
    update (momentum 0.9, the biased batch variance)."""
    x = (rng.normal(size=(4, 6, 5, 7)) * 2.0 + 3.0).astype(np.float32)  # NHWC
    scale, bias = rng.normal(size=7).astype(np.float32), rng.normal(size=7).astype(np.float32)
    mean0, var0 = rng.normal(size=7).astype(np.float32), rng.uniform(0.5, 2, 7).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    y_want, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    m = BatchNorm(7)
    m.load_state_dict({"weight": _t(scale), "bias": _t(bias), "running_mean": _t(mean0),
                       "running_var": _t(var0), "num_batches_tracked": torch.tensor(0)})
    y = m(_t(x).permute(0, 3, 1, 2), train=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)
    y_eval = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5).apply(
        {"params": variables["params"], "batch_stats": upd["batch_stats"]}, jnp.asarray(x))
    np.testing.assert_allclose(m(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y_eval), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scale", [8, 4])
def test_interpolate_bilinear(rng, scale):
    x = rng.normal(size=(3, 8, 6, 2)).astype(np.float32)
    want = np.asarray(j_interpolate(jnp.asarray(x), scale))
    np.testing.assert_allclose(interpolate_bilinear(_t(x), scale).numpy(), want, atol=1e-6)


@pytest.mark.parametrize("anneal", ["linear", "cos"])
def test_onecycle_lr_matches_optax(anneal):
    """The schedule at every step, the phase boundary included.  optax
    computes in fp32, the port in fp64: atol 5e-11 (1.25e-7 of max_lr)
    covers fp32's rounding of the schedule's small tail values."""
    total = 1000
    want = j_onecycle(4e-4, total, pct_start=0.05, anneal_strategy=anneal)
    got = onecycle_lr(4e-4, total, pct_start=0.05, anneal_strategy=anneal)
    steps = np.arange(total + 5)
    np.testing.assert_allclose([got(int(s)) for s in steps],
                               np.asarray(jax.vmap(want)(jnp.asarray(steps))), rtol=1e-6,
                               atol=5e-11)


@pytest.mark.parametrize("clipped", [False, True])
def test_adamw_clip_update_matches_optax(rng, clipped):
    """Two updates of the shipped optimizer (AdamW 4e-4, betas (0.9, 0.999),
    eps 1e-8, wd 1e-4, global-norm clip 10, OneCycle) on the same grads.
    Gradients large enough that Adam's g/|g| is well away from rounding."""
    params = {"a": rng.normal(size=(5, 4)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    gscale = 8.0 if clipped else 0.5
    grads = [{k: (gscale * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    opt = dict(type="AdamW", lr=4e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    lr_cfg = dict(policy="OneCycle", max_lr=4e-4, total_steps=100, pct_start=0.05,
                  anneal_strategy="linear")
    tx, _ = j_build_optimizer(opt, lr_cfg, grad_clip=10.0)
    state = tx.init(jax.tree_util.tree_map(jnp.asarray, params))
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    ps = [torch.nn.Parameter(_t(params[k])) for k in ("a", "b")]
    ttx, _ = build_optimizer(ps, opt, lr_cfg, grad_clip=10.0)
    for step, g in enumerate(grads):
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        for p, k in zip(ps, ("a", "b")):
            p.grad = _t(g[k])
        norm = ttx.step(step)
        want_norm = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in g.values()))
        assert (want_norm > 10.0) == clipped
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
    for p, k in zip(ps, ("a", "b")):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_j[k]), rtol=1e-6, atol=1e-7)


def test_build_optimizer_refuses_what_is_not_ported():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(NotImplementedError):
        build_optimizer(p, dict(type="SGD"))
    with pytest.raises(NotImplementedError):
        build_optimizer(p, dict(type="AdamW"), frozen_prefixes=["render_encoder"])
    with pytest.raises(ValueError):
        onecycle_lr(1e-3, 100, anneal_strategy="step")
