"""The port's serving pipeline (scflow_tpu_torch/serving.py) against the JAX
package's (scflow_tpu/serving.py): project_bboxes, crop_resize_patches and
the adapted intrinsics on random inputs, and make_serving_fn (slim and not)
and make_raft_serving_fn (host and device PnP) on the scene of
tests/test_serving.py (two spheres composited into a 128x160 frame, 64^2
patches, 2 iterations), the renders on the brute-force path in both ('auto'
on the CPU).

Bounds: boxes 1e-3 px (the projection's rounding), patches 1e-5 and K'
rtol 1e-6 (float32 tent products summed in another order); poses at the
slice tests' tolerances (rotations atol 2e-3, translations rtol 2e-3 +
2e-2 mm), masks atol 1e-3; the RAFT outputs at tests/test_torch_raft_system.py's
(flow 2e-3 px + 2e-3 of its scale, occlusion 2e-4, depth 1e-3 where both
renders cover; with the flow head zeroed, the device PnP's poses the
reference poses, which JAX's float32 PnP misses).  Serving is the crop, then the infer entry point: both are
checked against the infer fn on the same patches, bit for bit."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_tpu import serving as jserving
from scflow_tpu.refiners import system as jsystem
from scflow_tpu.render.meshbank import make_synthetic_bank as j_bank
from scflow_tpu.render.renderer import Renderer as JRenderer
from scflow_tpu_torch import serving
from scflow_tpu_torch.refiners.system import (RenderAssets, make_raft_infer_fn,
                                              make_scflow_infer_fn)
from scflow_tpu_torch.render.meshbank import make_synthetic_bank

from torch_port_helpers import keep_torch_rng, no_tf32, raft_pair, scflow_pair  # noqa: F401

IMG, ITERS, NCLASS, HW = 64, 2, 2, (128, 160)
POSE = dict(atol=2e-3)
TRANS = dict(rtol=2e-3, atol=2e-2)
PNP = dict(occ_thresh=0.5, num_points=200, reprojection_error=3.0, num_hypotheses=16)


@pytest.fixture(scope="module")
def scene():
    """tests/test_serving.py's scene: both spheres rendered at gt poses and
    composited over grey, the reference poses jittered."""
    from scipy.spatial.transform import Rotation

    jb = j_bank(NCLASS, kind="sphere", subdivisions=2, size=70.0)
    K = np.tile(np.array([[[150.0, 0, 80], [0, 150.0, 64], [0, 0, 1]]], np.float32), (2, 1, 1))
    gt_R = Rotation.random(2, random_state=1).as_matrix().astype(np.float32)
    gt_t = np.array([[15, 0, 500], [-20, 5, 560]], np.float32)
    labels = np.array([0, 1], np.int32)
    frame = JRenderer(bank=jb, image_size=HW, chunk=16)(gt_R, gt_t, K, labels)
    imgs, masks = np.asarray(frame["images"]), np.asarray(frame["masks"])
    img = np.full(HW + (3,), 0.4, np.float32)
    for i in range(2):
        img[masks[i] > 0] = imgs[i][masks[i] > 0]
    args = dict(frames=img[None], frame_idx=np.zeros(2, np.int32), ref_rotations=gt_R,
                ref_translations=gt_t + np.array([[3, -3, 10], [-4, 2, -8]], np.float32),
                K=K, labels=labels)
    ra = jsystem.RenderAssets.from_bank(jb)
    pa = RenderAssets.from_bank(make_synthetic_bank(NCLASS, kind="sphere", subdivisions=2,
                                                    size=70.0), device="cpu")
    return dict(args=args, j_render=ra, render=pa)


def _j(args):
    return [jnp.asarray(args[k]) for k in ("frames", "frame_idx", "ref_rotations",
                                           "ref_translations", "K", "labels")]


def _t(args):
    return [torch.from_numpy(np.asarray(args[k])) for k in ("frames", "frame_idx",
                                                            "ref_rotations",
                                                            "ref_translations", "K", "labels")]


def test_project_bboxes_and_crop_match_jax():
    """Random poses, intrinsics, boxes partly outside the frame, 3 frames."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(0)
    p, frames = 5, rng.random((3, 40, 56, 3)).astype(np.float32)
    bank = make_synthetic_bank(NCLASS, kind="sphere", subdivisions=1, size=50.0)
    R = Rotation.random(p, random_state=2).as_matrix().astype(np.float32)
    t = np.stack([rng.normal(size=p) * 30, rng.normal(size=p) * 20,
                  rng.uniform(300, 600, p)], -1).astype(np.float32)
    K = np.tile(np.array([[[60.0, 0, 28], [0, 62.0, 20], [0, 0, 1]]], np.float32), (p, 1, 1))
    K[:, 0, 2] += rng.normal(size=p).astype(np.float32) * 4
    labels = rng.integers(0, NCLASS, p).astype(np.int32)
    boxes = serving.project_bboxes(torch.from_numpy(bank.verts), torch.from_numpy(bank.vert_valid),
                                   *(torch.from_numpy(a) for a in (R, t, K, labels)))
    want = jserving.project_bboxes(jnp.asarray(bank.verts), jnp.asarray(bank.vert_valid),
                                   *(jnp.asarray(a) for a in (R, t, K, labels)))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want), atol=1e-3)
    boxes = np.concatenate([np.asarray(want)[:3], [[-10.0, -6, 20, 30], [40, 30, 70, 52]]])
    fidx = np.array([0, 2, 1, 1, 2], np.int32)
    for out_size, margin in ((16, 1.1), (24, 1.0)):
        patches, new_k = serving.crop_resize_patches(
            torch.from_numpy(frames), torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(fidx), torch.from_numpy(K), out_size, margin)
        jp, jk = jserving.crop_resize_patches(jnp.asarray(frames), jnp.asarray(boxes, jnp.float32),
                                              jnp.asarray(fidx), jnp.asarray(K), out_size, margin)
        assert patches.shape == (p, out_size, out_size, 3)
        np.testing.assert_allclose(patches.numpy(), np.asarray(jp), rtol=0, atol=1e-5)
        np.testing.assert_allclose(new_k.numpy(), np.asarray(jk), rtol=1e-6, atol=1e-4)
        assert (patches[3].numpy() == 0).any()  # the box leaving the frame fades to black


@pytest.fixture(scope="module")
def scflow_models():
    return scflow_pair(NCLASS, IMG, ITERS)


@pytest.mark.parametrize("slim", [True, False])
def test_serving_fn_matches_jax(scene, scflow_models, slim, no_tf32):
    """make_serving_fn on the composited frame: the poses (and with
    slim=False the masks) of JAX's serve fn; and exactly
    make_scflow_infer_fn on the patches and K' crop_resize_patches gives."""
    fmodel, variables, port = scflow_models
    jserve = jserving.make_serving_fn(fmodel, scene["j_render"], scene["j_render"].verts,
                                      scene["j_render"].vert_valid, image_size=IMG, slim=slim)
    want = {k: np.asarray(v) for k, v in jserve(variables, *_j(scene["args"])).items()}
    pa = scene["render"]
    serve = serving.make_serving_fn(port, pa, pa.verts, pa.vert_valid, image_size=IMG, slim=slim,
                                    device="cpu")
    got = serve(*_t(scene["args"]))
    assert set(got) == set(want) == ({"rotations", "translations"} | (set() if slim
                                                                       else {"masks"}))
    np.testing.assert_allclose(got["rotations"].numpy(), want["rotations"], **POSE)
    np.testing.assert_allclose(got["translations"].numpy(), want["translations"], **TRANS)
    moved = np.abs(want["translations"] - scene["args"]["ref_translations"]).max()
    assert moved > 0.1, moved
    if not slim:
        np.testing.assert_allclose(got["masks"].numpy(), want["masks"], atol=1e-3)
        return
    frames, fidx, R, t, K, labels = _t(scene["args"])
    boxes = serving.project_bboxes(pa.verts, pa.vert_valid, R, t, K, labels)
    patches, new_k = serving.crop_resize_patches(frames, boxes, fidx, K, IMG)
    infer = make_scflow_infer_fn(port, pa, image_size=(IMG, IMG), slim=True, device="cpu")
    ref = infer(dict(real_images=patches,  # the default norm: (x - 0) / 1
                     ref_rotations=R, ref_translations=t, k=new_k, labels=labels))
    for k in ("rotations", "translations"):
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)


@pytest.fixture(scope="module")
def raft_models():
    return raft_pair(IMG, ITERS, seed=7)


def _check_raft(got, want):
    for k in ("new_k", "ref_rotations", "ref_translations"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, atol=1e-4, err_msg=k)
    both = (got["rendered_depths"].numpy() > 0) & (want["rendered_depths"] > 0)
    assert both.mean() > 0.05
    np.testing.assert_allclose(got["rendered_depths"].numpy()[both],
                               want["rendered_depths"][both], atol=1e-3)
    for k, tol in (("flow", 2e-3 + 2e-3 * np.abs(want["flow"]).max()), ("occlusion", 2e-4)):
        assert np.abs(got[k].numpy() - want[k]).max() <= tol, k


def test_raft_serving_fn_host_matches_jax(scene, raft_models, no_tf32):
    """pnp_backend='host': what the host PnP reads (flow, occlusion, the
    render's depth, K' and the reference poses), of JAX's keys."""
    fmodel, variables, port = raft_models
    ra, pa = scene["j_render"], scene["render"]
    jserve = jserving.make_raft_serving_fn(fmodel, ra, ra.verts, ra.vert_valid, image_size=IMG)
    want = {k: np.asarray(v) for k, v in jserve(variables, *_j(scene["args"])).items()}
    got = serving.make_raft_serving_fn(port, pa, pa.verts, pa.vert_valid, image_size=IMG,
                                       device="cpu")(*_t(scene["args"]))
    assert set(got) == set(want) == {"flow", "occlusion", "rendered_depths", "new_k",
                                     "ref_rotations", "ref_translations"}
    _check_raft(got, want)


def test_raft_serving_fn_device_pnp_matches_jax(scene, raft_models, no_tf32):
    """pnp_backend='device' with the flow head's output zeroed in both
    packages (chip_smoke.py's workflow gate: RANSAC turns the packages'
    1e-6 differences in a random flow into other poses, while zero flow
    gives exact correspondences, so the pose is the reference pose): JAX's
    keys, flow, occlusion, render and K', the same pnp_ok, and the port's
    poses the reference poses (2e-6 here).  JAX's are not: its float32 DLT
    null vectors are noise (ROADMAP §3, the port solves them in float64),
    0.31 in a rotation entry and 169 mm off on this scene.  The serve fn is
    the crop, then make_raft_infer_fn."""
    from scflow_tpu.runtime.convert_torch import convert_state_dict_to_variables

    from torch_port_helpers import np_tree

    fmodel, variables, port = raft_models
    port = copy.deepcopy(port)
    with torch.no_grad():
        port.decoder.flow_pred.predict_layer.weight.zero_()
        port.decoder.flow_pred.predict_layer.bias.zero_()
    variables = np_tree(convert_state_dict_to_variables(
        {k: v.numpy() for k, v in port.state_dict().items()}, variables))
    ra, pa = scene["j_render"], scene["render"]
    jserve = jserving.make_raft_serving_fn(fmodel, ra, ra.verts, ra.vert_valid, image_size=IMG,
                                           pnp_backend="device", pnp_cfg=PNP)
    want = {k: np.asarray(v) for k, v in jserve(variables, *_j(scene["args"])).items()}
    got = serving.make_raft_serving_fn(port, pa, pa.verts, pa.vert_valid, image_size=IMG,
                                       pnp_backend="device", pnp_cfg=PNP,
                                       device="cpu")(*_t(scene["args"]))
    assert set(got) == set(want)
    assert np.abs(want["flow"]).max() == 0 and got["flow"].abs().max() == 0
    _check_raft(got, want)
    np.testing.assert_array_equal(got["pnp_ok"].numpy(), want["pnp_ok"])
    assert want["pnp_ok"].all()
    np.testing.assert_allclose(got["rotations"].numpy(), scene["args"]["ref_rotations"],
                               atol=1e-5)
    np.testing.assert_allclose(got["translations"].numpy(), scene["args"]["ref_translations"],
                               atol=1e-3)
    assert np.abs(want["rotations"] - scene["args"]["ref_rotations"]).max() > 0.1
    frames, fidx, R, t, K, labels = _t(scene["args"])
    patches, new_k = serving.crop_resize_patches(
        frames, serving.project_bboxes(pa.verts, pa.vert_valid, R, t, K, labels), fidx, K, IMG)
    ref = make_raft_infer_fn(port, pa, image_size=(IMG, IMG), pnp_backend="device", pnp_cfg=PNP,
                             device="cpu")(dict(real_images=patches, ref_rotations=R,
                                                ref_translations=t, k=new_k, labels=labels))
    for k in ("rotations", "translations", "occlusion"):
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)


def test_serving_fns_refuse_the_cpu_without_asking_and_misplaced_banks(scene, scflow_models,
                                                                       monkeypatch):
    _, _, port = scflow_models
    pa = scene["render"]
    with pytest.raises(ValueError, match="points_bank is on cpu"):
        serving.make_serving_fn(port, pa, pa.verts, pa.vert_valid, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (serving.make_serving_fn, serving.make_raft_serving_fn):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(port, pa, pa.verts, pa.vert_valid)
