"""The RAFT path's small pieces in the port against the JAX package on the
same inputs: unfold3x3 and convex_upsample (ops/upsample.py), the
axis-angle conversions near 0 and pi, filter_flow_by_depth and cal_epe
(geometry.py).  Tolerances are stated in each test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_tpu.geometry import flow as jflow
from scflow_tpu.geometry import rotation as jrot
from scflow_tpu.ops import upsample as jup
from scflow_tpu_torch import geometry
from scflow_tpu_torch.ops.upsample import convex_upsample, unfold3x3

from torch_port_helpers import keep_torch_rng  # noqa: F401


def test_unfold3x3_tap_order():
    """Bit for bit, and tap t = ky * 3 + kx as F.unfold orders it."""
    x = np.random.default_rng(0).normal(size=(2, 5, 7, 3)).astype(np.float32)
    got = unfold3x3(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jup.unfold3x3(jnp.asarray(x))))
    ref = torch.nn.functional.unfold(torch.from_numpy(x).permute(0, 3, 1, 2), 3, padding=1)
    np.testing.assert_array_equal(got.permute(0, 4, 3, 1, 2).reshape(2, 27, 35).numpy(),
                                  ref.numpy())


@pytest.mark.parametrize("channels,multiplier", [(2, 8.0), (1, 1.0), (2, None)])
def test_convex_upsample_matches_jax(channels, multiplier):
    """Flow (multiplier = scale, also by default) and occlusion (1.0): the
    same softmax and contraction in float32, within 1e-5 of the output's
    scale.  JAX's function runs jitted, as the JAX package runs it."""
    rng = np.random.default_rng(channels)
    x = rng.normal(size=(2, 4, 6, channels)).astype(np.float32) * 3
    mask = rng.normal(size=(2, 4, 6, 9 * 64)).astype(np.float32) * 2
    want = np.asarray(jax.jit(jup.convex_upsample, static_argnums=(2, 3))(
        jnp.asarray(x), jnp.asarray(mask), 8, multiplier))
    got = convex_upsample(torch.from_numpy(x), torch.from_numpy(mask), 8, multiplier).numpy()
    assert got.shape == want.shape == (2, 32, 48, channels)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_convex_upsample_bf16_mask_promotes_as_jax():
    """A bf16 mask on a float32 flow gives float32, a bf16 occlusion bf16;
    values within one bf16 ulp of the output's scale of JAX's."""
    rng = np.random.default_rng(3)
    mask = rng.normal(size=(1, 3, 3, 576)).astype(np.float32)
    for x, dt in ((rng.normal(size=(1, 3, 3, 2)).astype(np.float32), torch.float32),
                  (rng.uniform(size=(1, 3, 3, 1)).astype(np.float32), torch.bfloat16)):
        xt = torch.from_numpy(x).to(dt)
        want = jup.convex_upsample(jnp.asarray(xt.float().numpy()).astype(jnp.dtype(
            "bfloat16" if dt == torch.bfloat16 else "float32")),
            jnp.asarray(mask).astype(jnp.bfloat16), 8, 8.0 if dt == torch.float32 else 1.0)
        got = convex_upsample(xt, torch.from_numpy(mask).to(torch.bfloat16), 8,
                              8.0 if dt == torch.float32 else 1.0)
        assert str(want.dtype) == str(got.dtype).replace("torch.", "")
        w = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), w, atol=2 ** -7 * np.abs(w).max())


def _rotvecs():
    """Axis-angle vectors at 0, tiny, ordinary, and near and at pi."""
    rng = np.random.default_rng(0)
    axes = rng.normal(size=(7, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.array([0.0, 1e-7, 1e-3, 0.7, 2.5, np.pi - 1e-3, np.pi])
    return (axes * angles[:, None]).astype(np.float32)


def test_rotmat_from_axis_angle_matches_jax():
    """Rodrigues in JAX's form, including theta = 0: atol 1e-6."""
    r = _rotvecs()
    want = np.asarray(jrot.rotmat_from_axis_angle(jnp.asarray(r)))
    got = geometry.rotmat_from_axis_angle(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got[0], np.eye(3), atol=0)


def test_axis_angle_from_rotmat_matches_jax_near_0_and_pi():
    """The inverse, on JAX's branches: the small-angle scale 0.5 where sin
    theta <= 1e-6, theta / (2 sin theta) elsewhere; near pi both packages
    lose the vector the same way.  atol 1e-5 over the batch; away from pi
    the round trip returns the vector (atol 1e-4)."""
    R = np.array(jrot.rotmat_from_axis_angle(jnp.asarray(_rotvecs())))
    want = np.asarray(jrot.axis_angle_from_rotmat(jnp.asarray(R)))
    got = geometry.axis_angle_from_rotmat(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got[:5], _rotvecs()[:5], atol=1e-4)


def _flows(n=2, h=12, w=16, seed=0):
    rng = np.random.default_rng(seed)
    flow = rng.normal(size=(n, h, w, 2)).astype(np.float32) * 3
    flow[0, :2] = 400.0  # already invalid
    d0 = rng.uniform(300, 310, (n, h, w)).astype(np.float32)
    d1 = rng.uniform(300, 310, (n, h, w)).astype(np.float32)
    d0[:, :, :3] = 0.0
    d1[:, 5:8] = 500.0  # inconsistent where the flow lands here
    mask = (rng.random((n, h, w)) > 0.3).astype(np.float32)
    return flow, d0, d1, mask


def test_filter_flow_by_depth_matches_jax():
    """The same invalidated pixels (the documented OR), flow values equal."""
    flow, d0, d1, _ = _flows()
    want = np.asarray(jflow.filter_flow_by_depth(jnp.asarray(flow), jnp.asarray(d1),
                                                 jnp.asarray(d0)))
    got = geometry.filter_flow_by_depth(*map(torch.from_numpy, (flow, d1, d0))).numpy()
    assert 0.05 < (want == 400.0).mean() < 0.95
    np.testing.assert_array_equal(got == 400.0, want == 400.0)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "total_mean", "none"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_cal_epe_matches_jax(reduction, with_mask):
    """Every key and shape of the three reductions, rtol 1e-6."""
    flow, _, _, mask = _flows(seed=1)
    pred = flow + np.random.default_rng(2).normal(size=flow.shape).astype(np.float32) * 2
    m = mask if with_mask else None
    want = jflow.cal_epe(jnp.asarray(flow), jnp.asarray(pred),
                         None if m is None else jnp.asarray(m), reduction=reduction)
    got = geometry.cal_epe(torch.from_numpy(flow), torch.from_numpy(pred),
                           None if m is None else torch.from_numpy(m), reduction=reduction)
    if reduction == "none":
        want, got = {"err": want}, {"err": got}
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6, atol=1e-7, err_msg=k)
    with pytest.raises(ValueError):
        geometry.cal_epe(torch.from_numpy(flow), torch.from_numpy(pred), None, reduction="sum")
