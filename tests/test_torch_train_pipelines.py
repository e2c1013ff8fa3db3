"""The train pipeline's transforms against the JAX package's: cv2's uint8
BGR<->HSV conversions and box filter (imops' numpy replacements) on every
HSV/BGR input and on odd-sized random patches, bit for bit; RandomHSV,
RandomNoise and RandomSmooth, PoseJitter (with its fallback) and
ProjectKeypoints under equal seeds of Python's `random` and numpy's global
RNG; and the shipped train pipeline (configs/refine_datasets/ycbv_real.py)
on the synthetic BOP set through SuperviseTrainDataset, every array
equal."""

import copy
import random
from pathlib import Path

import cv2
import numpy as np
import pytest

from scflow_tpu.config import Config as JConfig
from scflow_tpu.datasets import build_dataset as j_build_dataset
from scflow_tpu.datasets.pipelines import color as jcolor
from scflow_tpu.datasets.pipelines import geometry as jgeometry
from scflow_tpu.datasets.pipelines import jitter as jjitter
from scflow_tpu_torch.config import Config
from scflow_tpu_torch.datasets.pipelines import color, geometry, jitter
from scflow_tpu_torch.datasets.pipelines.imops import bgr2hsv, blur, hsv2bgr
from scflow_tpu_torch.registry import build_dataset

from synthetic_bop import build_synthetic_bop
from torch_port_helpers import keep_torch_rng  # noqa: F401
from torch_train_helpers import assert_same, keep_global_rngs, seed_all  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(5, 9, 3), (37, 41, 3), (64, 63, 3), (101, 77, 3)]


@pytest.fixture(scope="module")
def bop(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_pipelines")
    info = build_synthetic_bop(root / "data", num_images=2, render_images=True)
    return root / "data", info


def _all_triples(width: int):
    """Every uint8 triple, as images of rows `width` pixels wide (16 images;
    the few triples that do not fill a row go into a last row of its own)."""
    a = np.arange(256, dtype=np.uint8)
    for hi in range(0, 256, 16):
        flat = np.stack(np.meshgrid(a[hi:hi + 16], a, a, indexing="ij"), -1).reshape(-1, 3)
        n = len(flat) - len(flat) % width
        yield flat[:n].reshape(-1, width, 3)
        if n < len(flat):
            yield flat[None, n:]


@pytest.mark.parametrize("ours,code,widths", [
    (bgr2hsv, cv2.COLOR_BGR2HSV, (1024,)), (hsv2bgr, cv2.COLOR_HSV2BGR, (1024, 31))],
    ids=["bgr2hsv", "hsv2bgr"])
def test_hsv_conversions_equal_cv2_on_every_input(ours, code, widths):
    """cv2 takes a row's pixels in blocks of 32 through its vector code and
    the rest of the row through its scalar code, which round apart in
    HSV2BGR: rows of 1024 pixels hold only the first kind, rows of 31 only
    the second.  BGR2HSV's fixed point is the same in both: every input in
    the first kind, a random 2^18 of them in the second."""
    for width in widths:
        for img in _all_triples(width):
            np.testing.assert_array_equal(ours(img), cv2.cvtColor(img, code))
    img = np.random.default_rng(0).integers(0, 256, (2**18 // 31, 31, 3), dtype=np.uint8)
    np.testing.assert_array_equal(ours(img), cv2.cvtColor(img, code))


@pytest.mark.parametrize("k", [1, 3, 5, 7, 17])
def test_blur_equals_cv2(k):
    rng = np.random.default_rng(k)
    for shape in SHAPES + [(40, 33)]:
        if min(shape[:2]) <= k // 2:
            continue
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(blur(img, k), cv2.blur(img, (k, k)), err_msg=str(shape))


def _patches(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s, dtype=np.uint8) for s in SHAPES]


def _run_both(port, jax, patches, seed, key="img"):
    outs = []
    for t in (jax, port):
        seed_all(seed)
        outs.append(t({key: [p.copy() for p in patches]})[key])
    return outs


def test_random_hsv_matches_jax_on_each_clip_branch():
    """Factors a, b, c above and below 1 (the clip branches) all occur over
    the seeds; with p < 1 some patches pass unchanged."""
    branches = set()
    for seed in range(12):
        kw = dict(h_ratio=0.2, s_ratio=0.5, v_ratio=0.5, p=0.8 if seed % 3 == 0 else 1.0)
        want, got = _run_both(color.RandomHSV(**kw), jcolor.RandomHSV(**kw), _patches(seed), seed)
        assert_same(got, want, f"seed {seed}")
        seed_all(seed)
        for _ in SHAPES:
            if random.random() > kw["p"]:
                continue
            branches |= {(i, random.uniform(-1, 1) >= 0) for i in range(3)}
    assert branches == {(i, up) for i in range(3) for up in (False, True)}


def test_random_smooth_matches_jax_for_each_kernel_size():
    sizes = set()
    for seed in range(8):
        want, got = _run_both(color.RandomSmooth(max_kernel_size=5.0),
                              jcolor.RandomSmooth(max_kernel_size=5.0), _patches(seed), seed)
        assert_same(got, want, f"seed {seed}")
        seed_all(seed)
        for _ in SHAPES:
            random.random()
            sizes.add(random.choice([1, 3, 5]))
    assert sizes == {1, 3, 5}
    t = color.RandomSmooth(max_kernel_size=5.0, p=0.5, patch_level=False)
    jt = jcolor.RandomSmooth(max_kernel_size=5.0, p=0.5, patch_level=False)
    for seed in range(4):
        img = _patches(seed)[2]
        seed_all(seed)
        want = jt({"img": img.copy()})["img"]
        seed_all(seed)
        np.testing.assert_array_equal(t({"img": img.copy()})["img"], want)


def test_random_noise_matches_jax():
    for seed in range(4):
        want, got = _run_both(color.RandomNoise(noise_ratio=0.1, p=0.7),
                              jcolor.RandomNoise(noise_ratio=0.1, p=0.7), _patches(seed), seed)
        assert_same(got, want, f"seed {seed}")


def _poses(n, seed):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    R = Rotation.random(n, random_state=seed).as_matrix().astype(np.float32)
    t = np.stack([rng.normal(size=n) * 30, rng.normal(size=n) * 30,
                  rng.uniform(500, 700, n)], -1).astype(np.float32)
    return R, t


@pytest.mark.parametrize("caps", [dict(angle_limit=45, translation_limit=200, add_limit=1.0),
                                  dict(angle_limit=45, translation_limit=200, add_limit=0.15),
                                  dict(angle_limit=1e-3, max_attempts=5),
                                  dict()],
                         ids=["shipped", "tight_add", "fallback", "no_caps"])
def test_pose_jitter_matches_jax(bop, caps):
    """Equal seeds: the construction's vertex subsets, the jittered poses and
    the three errors; caps no draw meets return the pose unjittered with
    zero errors (the fallback)."""
    data, info = bop
    kw = dict(jitter_angle_dis=(0, 15), jitter_x_dis=(0, 15), jitter_y_dis=(0, 15),
              jitter_z_dis=(0, 50), jitter_pose_field=["gt_rotations", "gt_translations"],
              jittered_pose_field=["ref_rotations", "ref_translations"], **caps)
    if "add_limit" in caps:
        kw.update(mesh_dir=str(data / "models_eval"), mesh_diameter=info["diameters"])
    R, t = _poses(6, 1)
    labels = np.array([0, 1, 1, 0, 1, 0])
    outs = []
    for cls in (jjitter.PoseJitter, jitter.PoseJitter):
        seed_all(3)
        tr = cls(**kw)
        outs.append((tr.mesh_vertices, tr(dict(gt_rotations=R.copy(), gt_translations=t.copy(),
                                               labels=labels))))
    (jverts, want), (verts, got) = outs
    assert_same(verts, jverts)
    assert_same(got, want)
    moved = np.abs(got["ref_rotations"] - R).max()
    if "max_attempts" in caps:
        assert moved == 0 and not got["init_rot_error"].any() and not got["init_add_error"].any()
    else:
        assert moved > 1e-3 and (got["init_rot_error"] <= caps.get("angle_limit", 180)).all()
        assert (got["init_add_error"] <= caps.get("add_limit", 0.0)).all()


def test_rot_error_matches_jax():
    R, _ = _poses(4, 2)
    for a, b in zip(R, R[::-1]):
        assert jitter.rot_error_deg(a, b) == jjitter.rot_error_deg(a, b)


def test_project_keypoints_matches_jax():
    R, t = _poses(3, 4)
    rng = np.random.default_rng(4)
    results = dict(gt_keypoints_3d=rng.normal(0, 40, (3, 8, 3)).astype(np.float32),
                   gt_rotations=R, gt_translations=t,
                   k=np.tile(np.array([[[572.4, 0, 320], [0, 573.5, 240], [0, 0, 1]]],
                                      np.float32), (3, 1, 1)))
    want = jgeometry.ProjectKeypoints()(copy.deepcopy(results))
    got = geometry.ProjectKeypoints(clip_border=True)(copy.deepcopy(results))
    assert got["gt_keypoints_2d"].shape == (3, 8, 2)
    assert_same(got, want)


def test_shipped_train_pipeline_matches_jax(bop):
    """SuperviseTrainDataset with configs/refine_datasets/ycbv_real.py's
    train pipeline (mesh paths pointed at the synthetic set): each sample of
    the two packages under equal seeds, every array equal."""
    data, info = bop
    out = []
    for config, build in ((JConfig, j_build_dataset), (Config, build_dataset)):
        shipped = config.fromfile(str(ROOT / "configs" / "refine_datasets" / "ycbv_real.py"))
        pipeline = [dict(t, mesh_dir=str(data / "models_eval"), mesh_diameter=info["diameters"])
                    if t["type"] == "PoseJitter" else
                    dict(t, mesh_dir=str(data / "models_eval")) if "mesh_dir" in t else dict(t)
                    for t in shipped.data["train"]["pipeline"]]
        cfg = dict(shipped.data["train"], data_root=str(data / "train_real"),
                   gt_annots_root=str(data / "train_real"),
                   image_list=str(data / "image_lists" / "train.txt"),
                   keypoints_json=str(data / "keypoints.json"), pipeline=pipeline,
                   class_names=("obj_a", "obj_b"), meshes_eval=str(data / "models_eval"),
                   mesh_diameter=info["diameters"], mesh_symmetry={})
        seed_all(5)
        ds = build(cfg)
        out.append([ds[i] for i in range(len(ds))] + [ds[0]])
    want, got = out
    assert [t["type"] for t in shipped.data["train"]["pipeline"]][5:8] == [
        "RandomHSV", "RandomNoise", "RandomSmooth"]
    assert got[0]["img"].shape == (1, 256, 256, 3)
    assert_same(got, want)
