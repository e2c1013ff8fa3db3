"""The port's data layer against the JAX package's on the synthetic BOP set
of tests/synthetic_bop.py (3 rendered images, 2 classes) and the test
pipeline of tests/test_e2e_cli.py (the shipped ycbv_real.py pipeline at
64^2): one RefineDataset and one RefineTestDataset sample per image, every
array and meta equal (the port reads the PNGs and resizes without cv2, bit
for bit); the keep and target RemapPose modes, equal but for the poses,
which the port solves by least squares where JAX calls EPnP
(tests/test_torch_workflow_imops.py states the distance); evaluate's
ADD(-S)/REP/AUC on the same results to 1e-9, and format_results' BOP files
equal once parsed; LoadMasks and the crop/resize/pad of masks (cv2's
nearest rule) equal JAX's."""

import copy
import json
import random

import numpy as np
import pytest

from scflow_tpu.config import Config as JConfig
from scflow_tpu.datasets import build_dataset as j_build_dataset
from scflow_tpu_torch.config import Config
from scflow_tpu_torch.registry import build_dataset

from synthetic_bop import build_synthetic_bop
from test_e2e_cli import CONFIG_TMPL
from torch_port_helpers import keep_torch_rng  # noqa: F401


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root = tmp_path_factory.mktemp("workflow_data")
    info = build_synthetic_bop(root / "data", num_images=3, render_images=True)
    path = root / "cfg.py"
    path.write_text(CONFIG_TMPL.format(root=str(root / "data"), diameters=info["diameters"],
                                       work_dir=str(root / "work"),
                                       model_type="SCFlowRefiner",
                                       decoder_type="SCFlowDecoder"))
    return root, str(path)


def _datasets(cfg_path, **override):
    """(JAX's, the port's) data.test dataset with `override` merged into its
    dict, each built after seeding numpy's and Python's global RNGs alike
    (ComputeBbox draws its mesh points from numpy's at construction)."""
    out = []
    for config, build in ((JConfig, j_build_dataset), (Config, build_dataset)):
        cfg = copy.deepcopy(dict(config.fromfile(cfg_path).data["test"]))
        cfg.update(override)
        np.random.seed(0)
        random.seed(0)
        out.append(build(cfg))
    return out


def _equal(got, want, path="", skip=()):
    if path.split("/")[-1] in skip:
        return
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}/{k}", skip)
    elif isinstance(want, (list, tuple)) and not (
            want and isinstance(want[0], (int, float, str))):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{path}/{i}", skip)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("kind", ["RefineDataset", "RefineTestDataset"])
def test_samples_match_jax(synthetic, kind):
    _, cfg_path = synthetic
    jds, pds = _datasets(cfg_path, type=kind)
    assert len(pds) == len(jds) == 3
    for i in range(len(jds)):
        want, got = jds[i], pds[i]
        assert got["img"].shape[1:] == (64, 64, 3) and np.abs(got["img"]).max() > 0
        _equal(got, want, f"{kind}[{i}]")


def _pipeline_with(cfg_path, remap):
    pipeline = copy.deepcopy(list(Config.fromfile(cfg_path).data["test"]["pipeline"]))
    for i, t in enumerate(pipeline):
        if t["type"] == "RemapPose":
            pipeline[i] = dict(type="RemapPose", **remap)
    return pipeline


@pytest.mark.parametrize("remap", [dict(keep_intrinsic=True),
                                   dict(keep_intrinsic=False,
                                        dst_k=[[140.0, 0, 32], [0, 140.0, 32], [0, 0, 1]])],
                         ids=["keep", "target"])
def test_remap_modes_match_jax_but_for_the_solve(synthetic, remap):
    _, cfg_path = synthetic
    jds, pds = _datasets(cfg_path, pipeline=_pipeline_with(cfg_path, remap))
    poses = ("ref_rotations", "ref_translations", "gt_rotations", "gt_translations")
    for i in range(len(jds)):
        want, got = jds[i], pds[i]
        _equal(got, want, skip=poses)
        for k in poses:
            atol = 0.15 if "rotations" in k else 50.0
            np.testing.assert_allclose(got["annots"][k], want["annots"][k], atol=atol, err_msg=k)


def _results(dataset, seed=0):
    """Per-image predictions near the GT poses (1-3 degrees, 2-10 mm), with
    a second, worse detection of class 1 in image 0 (matched by best ADD)
    and class 2 missing from image 1 (an unmatched GT object)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    out = []
    for i, path in enumerate(dataset.img_files):
        seq, name = path.rsplit("/", 3)[1], path.rsplit("/", 1)[1]
        objs = dataset.gt_seq_pose_annots[seq].objects(int(name.split(".")[0]))
        labels, rots, trans = [], [], []
        for oi, obj in enumerate(objs["obj_ids"]):
            if i == 1 and obj == 2:
                continue
            copies = 2 if (i == 0 and obj == 1) else 1
            for c in range(copies):
                scale = 1.0 + 4.0 * c
                dR = Rotation.from_rotvec(rng.normal(size=3) * np.radians(2) * scale).as_matrix()
                labels.append(int(obj) - 1)
                rots.append((dR @ objs["rotations"][oi]).astype(np.float32))
                trans.append((objs["translations"][oi] + rng.normal(size=3) * 6 * scale)
                             .astype(np.float32))
        out.append(dict(pred=dict(labels=np.asarray(labels), rotations=np.stack(rots),
                                  translations=np.stack(trans),
                                  scores=np.ones(len(labels), np.float32)),
                        img_metas=dict(img_path=path)))
    return out


def test_evaluate_and_format_results_match_jax(synthetic, tmp_path):
    _, cfg_path = synthetic
    jds, pds = _datasets(cfg_path, mesh_symmetry={"cls_2": {"z": 0}})
    results = _results(jds)
    metric = {"add": [0.05, 0.10, 0.20, 0.50], "rep": [2, 5, 10, 20], "auc": []}
    want = jds.evaluate(results, metric=metric)
    got = pds.evaluate(results, metric=metric)
    assert set(got) == set(want) and len(want) == 3 * 9
    assert 0 < want["average/add_10"] < 1  # neither all nor nothing
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-9, k
    jds.format_results(results, str(tmp_path / "jax"), time=0.5)
    pds.format_results(results, str(tmp_path / "port"), time=0.5)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.json"))
    assert [str(f) for f in files] == ["000001/scene_gt.json"]
    for f in files:
        assert json.loads((tmp_path / "port" / f).read_text()) == \
            json.loads((tmp_path / "jax" / f).read_text())


def test_masks_load_and_transform_as_jax(synthetic):
    """LoadMasks on the set's mask_visib PNGs (written by cv2), then Crop,
    Resize and Pad of the masks field: every mask equal to JAX's."""
    from scflow_tpu.datasets.pipelines import Crop as JCrop, LoadMasks as JLoadMasks
    from scflow_tpu.datasets.pipelines import Pad as JPad, Resize as JResize
    from scflow_tpu_torch.datasets.pipelines import Crop, LoadMasks, Pad, Resize

    root, _ = synthetic
    paths = sorted(str(p) for p in (root / "data" / "train_real" / "000001" / "mask_visib")
                   .glob("000000_*.png"))
    boxes = np.array([[10, 5, 70, 60], [60, 20, 150, 100]], np.float32)[:len(paths)]
    outs = []
    for load, crop, resize, pad in ((JLoadMasks, JCrop, JResize, JPad),
                                    (LoadMasks, Crop, Resize, Pad)):
        res = dict(img=np.zeros((120, 160, 3), np.uint8), img_shape=(120, 160, 3),
                   gt_mask_path=paths, labels=np.arange(len(paths)), ref_bboxes=boxes.copy(),
                   bbox_fields=["ref_bboxes"], mask_fields=["gt_masks"])
        res = load()(res)
        res = crop(size_range=(1.1, 1.1), clip_border=False, pad_val=128)(res)
        res = resize(img_scale=64, keep_ratio=True)(res)
        res = pad(size=(64, 64), center=True, pad_val=dict(img=(128, 128, 128), mask=0))(res)
        outs.append(res["gt_masks"])
    assert len(outs[1]) == len(paths) == 2
    for want, got in zip(*outs):
        assert got.masks.shape == want.masks.shape == (1, 64, 64) and want.masks.any()
        np.testing.assert_array_equal(got.masks, want.masks)
