"""Each network module of the port against its flax module, with the flax
weights carried across by state_dict_from_flax.  atol 2e-4 is the bound
tests/test_convert_torch.py uses between the flax modules and the torch
oracle (different conv summation orders in fp32)."""

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
from scflow_tpu_torch.convert import state_dict_from_flax
from scflow_tpu_torch.models.layers import ConvModule
from scflow_tpu_torch.models.motion import ConvGRU, MotionEncoder, XHead
from scflow_tpu_torch.models.pose_head import MultiClassPoseHead
from scflow_tpu_torch.models.raft_encoder import RAFTEncoder

from torch_port_helpers import keep_torch_rng, load_port, no_tf32, np_tree  # noqa: F401

ATOL = 2e-4
KEY = jax.random.PRNGKey(0)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _perturb_stats(variables, rng):
    """Non-trivial BatchNorm running statistics, so eval-mode BN is tested
    with more than the identity."""
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


@pytest.mark.parametrize("norm", ["BN", "IN", "GN"])
def test_conv_module(norm, rng, no_tf32):
    x = rng.normal(size=(2, 9, 10, 32)).astype(np.float32)
    fm = FConvModule(64, 3, stride=2, padding=1, norm=norm, act="relu")
    variables = _perturb_stats(np_tree(fm.init(KEY, jnp.asarray(x))), rng)
    tm = load_port(ConvModule(32, 64, 3, stride=2, padding=1, norm=norm),
                   variables, cxt_norm=norm)
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(fm.apply(variables, jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("norm", ["IN", "BN"])
def test_raft_encoder(norm, rng, no_tf32):
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    fm = FEncoder(norm=norm, out_channels=256)
    variables = _perturb_stats(np_tree(fm.init(KEY, jnp.asarray(x))), rng)
    tm = load_port(RAFTEncoder(256, norm=norm), variables, cxt_norm=norm)
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(fm.apply(variables, jnp.asarray(x))), atol=ATOL)


def test_motion_encoder(rng, no_tf32):
    corr = rng.normal(size=(2, 8, 8, 324)).astype(np.float32)
    flow = rng.normal(size=(2, 8, 8, 2)).astype(np.float32)
    fm = FMotion()
    variables = np_tree(fm.init(KEY, jnp.asarray(corr), jnp.asarray(flow)))
    tm = load_port(MotionEncoder(), variables)
    with torch.no_grad():
        got = nhwc(tm(nchw(corr), nchw(flow)))
    want = fm.apply(variables, jnp.asarray(corr), jnp.asarray(flow))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_conv_gru(rng, no_tf32):
    h = rng.normal(size=(2, 8, 8, 128)).astype(np.float32)
    x = rng.normal(size=(2, 8, 8, 256)).astype(np.float32)
    fm = FGRU(128)
    variables = np_tree(fm.init(KEY, jnp.asarray(h), jnp.asarray(x)))
    tm = load_port(ConvGRU(128, 256), variables)
    with torch.no_grad():
        got = nhwc(tm(nchw(h), nchw(x)))
    np.testing.assert_allclose(got, np.asarray(fm.apply(variables, jnp.asarray(h), jnp.asarray(x))),
                               atol=ATOL)


@pytest.mark.parametrize("kind,out", [("flow", 2), ("mask", 1)])
def test_xhead(kind, out, rng, no_tf32):
    x = rng.normal(size=(2, 8, 8, 128)).astype(np.float32)
    fm = FXHead((256,), out, kind=kind)
    variables = np_tree(fm.init(KEY, jnp.asarray(x)))
    tm = load_port(XHead(128, 256, out, kind=kind), variables)
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(fm.apply(variables, jnp.asarray(x))), atol=ATOL)


def test_multiclass_pose_head(rng, no_tf32):
    """Labels differ within the batch (the per-sample gather) and the output
    kernels are non-zero (the zero init would hide the NCHW flatten)."""
    x = rng.normal(size=(3, 16, 16, 224)).astype(np.float32)
    label = np.array([2, 0, 3])
    fm = FPoseHead(num_class=4)
    variables = np_tree(fm.init(KEY, jnp.asarray(x), jnp.asarray(label)))
    for name in ("rotation_pred", "translation_pred"):
        k = variables["params"][name]["kernel"]
        variables["params"][name]["kernel"] = rng.normal(0, 0.05, k.shape).astype(np.float32)
    # the bridge names pose-head modules by their place under `pose_pred`
    sd = state_dict_from_flax({"params": {"pose_pred": variables["params"]}})
    tm = MultiClassPoseHead(4, 224, feat_size=(16, 16)).eval()
    tm.load_state_dict({k[len("pose_pred."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        rot, trans = tm(nchw(x), torch.from_numpy(label))
    rot_f, trans_f = fm.apply(variables, jnp.asarray(x), jnp.asarray(label))
    np.testing.assert_allclose(rot.numpy(), np.asarray(rot_f), atol=ATOL)
    np.testing.assert_allclose(trans.numpy(), np.asarray(trans_f), atol=ATOL)


def test_pose_head_identity_init():
    """Zero output kernels with an identity-rotation bias: the first update
    is the identity, as in the reference."""
    head = MultiClassPoseHead(3, 224, feat_size=(16, 16)).eval()
    with torch.no_grad():
        rot, trans = head(torch.randn(2, 224, 16, 16), torch.tensor([0, 2]))
    np.testing.assert_array_equal(rot.numpy(), np.tile([1, 0, 0, 0, 1, 0], (2, 1)))
    np.testing.assert_array_equal(trans.numpy(), np.zeros((2, 3)))
