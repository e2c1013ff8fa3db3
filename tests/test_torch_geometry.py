"""The port's geometry and resize helpers against the JAX package's, on the
same numpy inputs.  Inputs are unit-scale (depths and translations near 1),
so the stated atol of 1e-5 is about a hundred float32 ulps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_tpu.geometry import camera as jcam
from scflow_tpu.geometry import flow as jflow
from scflow_tpu.geometry.rotation import rotmat_from_ortho6d as j_ortho6d
from scflow_tpu.geometry.se3 import apply_delta_pose as j_delta
from scflow_tpu.ops.resize import interp_taps as j_taps
from scflow_tpu_torch import geometry as tg
from scflow_tpu_torch.ops.resize import interp_taps

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _pose_inputs(rng, n=4):
    K = np.tile(np.array([[[1.5, 0, 0.4], [0, 1.4, 0.6], [0, 0, 1]]], np.float32), (n, 1, 1))
    R = np.asarray(j_ortho6d(jnp.asarray(rng.normal(size=(n, 6)).astype(np.float32))))
    t = np.concatenate([rng.uniform(-0.2, 0.2, (n, 2)), rng.uniform(0.8, 1.5, (n, 1))],
                       1).astype(np.float32)
    return K, R, t


def test_rotmat_from_ortho6d(rng):
    o6d = rng.normal(size=(7, 6)).astype(np.float32)
    np.testing.assert_allclose(tg.rotmat_from_ortho6d(_t(o6d)).numpy(),
                               np.asarray(j_ortho6d(jnp.asarray(o6d))), atol=ATOL)


def test_apply_delta_pose(rng):
    _, R, t = _pose_inputs(rng)
    d_rot = (np.array([1, 0, 0, 0, 1, 0], np.float32)
             + 0.1 * rng.normal(size=(4, 6))).astype(np.float32)
    d_trans = (0.1 * rng.normal(size=(4, 3))).astype(np.float32)
    R_j, t_j = j_delta(jnp.asarray(d_rot), jnp.asarray(d_trans), jnp.asarray(R),
                       jnp.asarray(t), depth_transform="exp")
    R_p, t_p = tg.apply_delta_pose(_t(d_rot), _t(d_trans), _t(R), _t(t))
    np.testing.assert_allclose(R_p.numpy(), np.asarray(R_j), atol=ATOL)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), atol=ATOL)


def test_coords_grid():
    np.testing.assert_array_equal(tg.coords_grid(5, 7).numpy(),
                                  np.asarray(jcam.coords_grid(5, 7)))


def _lift_inputs(rng):
    K, R, t = _pose_inputs(rng)
    depth = rng.uniform(0.9, 1.6, (4, 6, 5)).astype(np.float32)
    depth[:, 0, :2] = 0.0  # empty pixels
    gx, gy = np.meshgrid(np.array([0, 1, 3, 4, 6], np.float32) * 0.1,
                         np.array([0, 2, 3, 5, 7, 8], np.float32) * 0.1, indexing="xy")
    pix = np.stack([gx, gy], -1)
    return depth, K, R, t, pix


def test_lift_depth_to_object_points_at(rng):
    depth, K, R, t, pix = _lift_inputs(rng)
    p_j, v_j = jcam.lift_depth_to_object_points_at(*map(jnp.asarray, (depth, K, R, t, pix)))
    p_p, v_p = tg.lift_depth_to_object_points_at(*map(_t, (depth, K, R, t, pix)))
    np.testing.assert_array_equal(v_p.numpy(), np.asarray(v_j))
    np.testing.assert_allclose(p_p.numpy(), np.asarray(p_j), atol=ATOL)


def test_flow_from_object_points_at(rng):
    depth, K, R, t, pix = _lift_inputs(rng)
    points, valid = jcam.lift_depth_to_object_points_at(*map(jnp.asarray, (depth, K, R, t, pix)))
    _, R2, t2 = _pose_inputs(np.random.default_rng(1))
    f_j = jflow.flow_from_object_points_at(points, valid, jnp.asarray(R2), jnp.asarray(t2),
                                           jnp.asarray(K), jnp.asarray(pix), 0.0)
    f_p = tg.flow_from_object_points_at(_t(points), torch.from_numpy(np.array(valid)),
                                        _t(R2), _t(t2), _t(K), _t(pix))
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_j), atol=ATOL)


@pytest.mark.parametrize("n_in,n_out", [(256, 32), (128, 16), (100, 13), (7, 1)])
def test_interp_taps(n_in, n_out):
    for got, want in zip(interp_taps(n_in, n_out), j_taps(n_in, n_out, True)):
        np.testing.assert_array_equal(got, want)
