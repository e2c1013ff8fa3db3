"""The port's pose from flow (refiners/flow_pose.py) against the JAX
package's refiners/flow_pose.py: the batched device path on a gt flow and
the host path (numpy lift, cv2 RANSAC-EPnP) on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from torch_port_helpers import keep_torch_rng  # noqa: F401

IMG, N = 64, 2


@pytest.fixture(scope="module")
def flow_scene():
    """Depth rendered at reference poses (the port's renderer, 3-class bank),
    the gt flow to a moved pose, and the intrinsics."""
    from scflow_tpu_torch.geometry import flow_from_pose_and_depth
    from scflow_tpu_torch.refiners.system import RenderAssets, render_and_normalize
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    rng = np.random.default_rng(0)
    ref_R = Rotation.random(N, rng).as_matrix().astype(np.float32)
    ref_t = np.array([[3.0, -2.0, 400.0], [-4.0, 5.0, 430.0]], np.float32)
    dR = Rotation.from_euler("xyz", rng.normal(size=(N, 3)) * 4, degrees=True).as_matrix()
    gt_R = np.einsum("nij,njk->nik", dR, ref_R).astype(np.float32)
    gt_t = ref_t + np.array([[2, -1, 8], [-1, 2, -6]], np.float32)
    k = np.tile(np.array([[[120.0, 0, IMG / 2], [0, 120.0, IMG / 2], [0, 0, 1]]], np.float32),
                (N, 1, 1))
    labels = torch.tensor([0, 2])
    assets = RenderAssets.from_bank(make_synthetic_bank(3), device="cpu")
    _, depth, _ = render_and_normalize(assets, torch.from_numpy(ref_R), torch.from_numpy(ref_t),
                                       torch.from_numpy(k), labels, (IMG, IMG), chunk=16)
    flow = flow_from_pose_and_depth(*map(torch.from_numpy, (ref_R, ref_t, gt_R, gt_t)), depth,
                                    torch.from_numpy(k))
    assert (depth > 0).float().mean() > 0.1
    return dict(ref_R=ref_R, ref_t=ref_t, gt_R=gt_R, gt_t=gt_t, k=k, depth=depth.numpy(),
                flow=flow.numpy())


def _args(s):
    return s["flow"], s["depth"], s["ref_R"], s["ref_t"], s["k"]


def test_solve_poses_from_flow_device_recovers_the_gt_pose(flow_scene):
    """On the gt flow, with an occlusion map that drops a band (occ_thresh
    0.5) and ranks the rest by a seeded confidence, both packages recover
    the gt pose, rotation within 1e-3 and translation 0.2 mm."""
    from scflow_tpu.refiners.flow_pose import solve_poses_from_flow_device as j_solve
    from scflow_tpu_torch.refiners.flow_pose import solve_poses_from_flow_device

    s = flow_scene
    occ = np.random.default_rng(2).uniform(0.6, 1.0, (N, IMG, IMG)).astype(np.float32)
    occ[:, :, :20] = 0.2  # occluded: dropped by occ_thresh 0.5
    kw = dict(num_points=256, num_hypotheses=32)
    Rj, tj, okj = j_solve(*(jnp.asarray(a) for a in _args(s)), occlusion=jnp.asarray(occ), **kw)
    R, t, ok = solve_poses_from_flow_device(*map(torch.from_numpy, _args(s)),
                                            occlusion=torch.from_numpy(occ), **kw)
    assert bool(ok.all()) and bool(np.asarray(okj).all())
    for Rx, tx in ((R.numpy(), t.numpy()), (np.asarray(Rj), np.asarray(tj))):
        assert np.abs(Rx - s["gt_R"]).max() < 1e-3
        assert np.abs(tx - s["gt_t"]).max() < 0.2


def test_flow_only_selection_recovers_the_gt_pose(flow_scene):
    """Without an occlusion map (the flow-only model) and num_points above
    the valid pixel count, every valid pixel is selected whichever score
    ranks them (the port's own fixed draw, flow_only_score, not JAX's
    PRNGKey(7) uniform), so the result does not hang on the draw: the gt
    pose within 1e-3 / 0.2 mm, and the same with the score replaced."""
    from scflow_tpu_torch.refiners import flow_pose

    s = flow_scene
    kw = dict(num_points=IMG * IMG, num_hypotheses=32)
    assert (s["depth"] > 0).sum(axis=(1, 2)).max() < IMG * IMG
    R, t, ok = flow_pose.solve_poses_from_flow_device(*map(torch.from_numpy, _args(s)), **kw)
    assert bool(ok.all())
    assert np.abs(R.numpy() - s["gt_R"]).max() < 1e-3
    assert np.abs(t.numpy() - s["gt_t"]).max() < 0.2
    score = flow_pose.flow_only_score(IMG, IMG)
    assert score.shape == (IMG, IMG) and torch.equal(score, flow_pose.flow_only_score(IMG, IMG))


def test_solve_poses_from_flow_device_keeps_the_reference_on_failure(flow_scene):
    """No valid pixel (occlusion 0 everywhere): ok False and the reference
    pose, in both packages."""
    from scflow_tpu_torch.refiners.flow_pose import solve_poses_from_flow_device

    s = flow_scene
    occ = torch.zeros((N, IMG, IMG))
    R, t, ok = solve_poses_from_flow_device(*map(torch.from_numpy, _args(s)), occlusion=occ,
                                            num_points=64, num_hypotheses=8)
    assert not bool(ok.any())
    np.testing.assert_array_equal(R.numpy(), s["ref_R"])
    np.testing.assert_array_equal(t.numpy(), s["ref_t"])


@pytest.mark.parametrize("sample", [None, dict(num=300, mode="topk"),
                                    dict(num=300, mode="random")])
def test_solve_poses_from_flow_host_matches_jax(flow_scene, sample):
    """The host path (numpy lift, cv2 RANSAC-EPnP) of both packages on the
    same inputs gives the same poses (atol 1e-5; one cv2 underneath), and
    recovers the gt pose; the port takes tensors as well."""
    from scflow_tpu.refiners.flow_pose import solve_poses_from_flow as j_solve
    from scflow_tpu_torch.refiners.flow_pose import solve_poses_from_flow

    s = flow_scene
    occ = np.random.default_rng(1).uniform(0.3, 1.0, (N, IMG, IMG)).astype(np.float32)
    Rj, tj, okj = j_solve(*_args(s), occlusion=occ, sample_points=sample)
    R, t, ok = solve_poses_from_flow(*map(torch.from_numpy, _args(s)),
                                     occlusion=torch.from_numpy(occ), sample_points=sample)
    np.testing.assert_array_equal(ok, okj)
    assert ok.all()
    np.testing.assert_allclose(R, Rj, atol=1e-5)
    np.testing.assert_allclose(t, tj, atol=1e-3)
    assert np.abs(t - s["gt_t"]).max() < 1.0 and np.abs(R - s["gt_R"]).max() < 1e-2
