"""The PBR recipes' data layer against the JAX package's: every dataset config
of configs/refine_datasets/ (ycbv_real, ycbv_pbr, ycbv_mixpbr,
ycbv_mix20real) loaded by each package's Config, its data paths moved onto
a synthetic YCB-V-layout set (tests/synthetic_bop.py's frames at 160x120
and 21 classes: a PNG train_real split and a JPEG train_pbr split written
by cv2, visib_fract on both sides of 0.2, a background directory of JPEG
and PNG files), built by each registry: the same census and length, and
equal samples under equal seeds (ycbv_pbr with RandomBackground at p=1;
ycbv_mixpbr's ConcatDataset at its 1:2 ratios, indices from both
parts)."""

import json
import shutil

import cv2
import numpy as np
import pytest

from scflow_tpu.config import Config as JConfig
from scflow_tpu.datasets import build_dataset as j_build_dataset
from scflow_tpu_torch.config import Config
from scflow_tpu_torch.registry import build_dataset

from synthetic_bop import build_synthetic_bop
from torch_port_helpers import keep_torch_rng  # noqa: F401
from torch_train_helpers import assert_same, keep_global_rngs, seed_all  # noqa: F401

CONFIGS = ("ycbv_real", "ycbv_pbr", "ycbv_mixpbr", "ycbv_mix20real")
NCLASS, IMAGES = 21, 4


@pytest.fixture(autouse=True)
def seeded():
    seed_all(0)


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    """root/ycbv in the shipped configs' layout, and root/coco."""
    root = tmp_path_factory.mktemp("pbr_data")
    ycbv = root / "ycbv"
    build_synthetic_bop(ycbv, num_images=IMAGES, num_class=NCLASS)
    (ycbv / "keypoints").mkdir()
    shutil.copy(ycbv / "keypoints.json", ycbv / "keypoints" / "bbox.json")
    real, pbr = ycbv / "train_real" / "000001", ycbv / "train_pbr" / "000001"
    (pbr / "rgb").mkdir(parents=True)
    shutil.copytree(real / "mask_visib", pbr / "mask_visib")
    for name in ("scene_gt.json", "scene_camera.json"):
        shutil.copy(real / name, pbr / name)
    info = json.loads((real / "scene_gt_info.json").read_text())
    for img_id, objs in info.items():  # visib_fract on both sides of 0.2
        for o, obj in enumerate(objs):
            obj["visib_fract"] = [0.05, 0.19, 0.2, 0.6][(int(img_id) + o) % 4]
    (pbr / "scene_gt_info.json").write_text(json.dumps(info))
    for i in range(IMAGES):
        img = cv2.imread(str(real / "rgb" / f"{i:06d}.png"), cv2.IMREAD_UNCHANGED)
        cv2.imwrite(str(pbr / "rgb" / f"{i:06d}.jpg"), img)
    lists = ycbv / "image_lists"
    real_list = [f"000001/rgb/{i:06d}.png" for i in range(IMAGES)]
    (lists / "train_real.txt").write_text("\n".join(real_list))
    (lists / "train_real_20.txt").write_text(real_list[0])
    (lists / "train_pbr.txt").write_text(
        "\n".join(f"000001/rgb/{i:06d}.jpg" for i in range(IMAGES)))
    coco = root / "coco"
    coco.mkdir()
    rng = np.random.default_rng(5)
    for i, (h, w) in enumerate([(90, 120), (64, 48)]):
        cv2.imwrite(str(coco / f"{i:012d}.jpg"), rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        cv2.imwrite(str(coco / f"{i:012d}.png"), rng.integers(0, 256, (w, h, 3)).astype(np.uint8))
    return root


def _relocate(obj, root):
    """A plain copy of a config value with the shipped data paths moved
    under root."""
    if isinstance(obj, dict):
        return {k: _relocate(v, root) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_relocate(v, root) for v in obj)
    if isinstance(obj, str):
        return obj.replace("data/ycbv", str(root / "ycbv")).replace("data/coco",
                                                                   str(root / "coco"))
    return obj


def _train_cfgs(name, root, background_p=None):
    """(JAX's, the port's) data.train of configs/refine_datasets/<name>.py."""
    out = []
    for config in (JConfig, Config):
        cfg = _relocate(config.fromfile(f"configs/refine_datasets/{name}.py").data["train"],
                        root)
        if background_p is not None:
            for t in cfg["pipeline"]:
                if t["type"] == "RandomBackground":
                    t["p"] = background_p
        out.append(cfg)
    return out


def _build(cfgs):
    out = []
    for cfg, build in zip(cfgs, (j_build_dataset, build_dataset)):
        seed_all(0)
        out.append(build(cfg))
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_every_dataset_config_builds(dataset_root, name):
    jcfg, pcfg = _train_cfgs(name, dataset_root)
    types = [t["type"] for t in (pcfg.get("pipeline") or pcfg["dataset_configs"][1]["pipeline"])]
    assert ("RandomBackground" in types) == (name != "ycbv_real") and (
        name == "ycbv_real" or types.index("RandomBackground") == 5)
    jds, pds = _build((jcfg, pcfg))
    assert len(pds) == len(jds) > 0
    parts = getattr(pds, "datasets", [pds])
    for jp, pp in zip(getattr(jds, "datasets", [jds]), parts):
        assert pp.total_sample_num == jp.total_sample_num


def _compare_items(jds, pds, indices):
    for i in indices:
        seed_all(100 + i)
        want = jds[i]
        seed_all(100 + i)
        got = pds[i]
        assert_same(got, want, f"[{i}]")


def test_pbr_samples_match_jax(dataset_root):
    """JPEG frames, the min_visib_fract 0.2 filter, RandomBackground at p=1."""
    jds, pds = _build(_train_cfgs("ycbv_pbr", dataset_root, background_p=1.0))
    assert "min_visib_fract" not in _train_cfgs("ycbv_real", dataset_root)[1]
    store = next(iter(pds.gt_seq_pose_annots.values()))
    fract = store.info["visib_fract"]
    assert (fract < 0.2).any() and (fract >= 0.2).any()
    _compare_items(jds, pds, range(IMAGES))
    seed_all(3)
    sample = pds.getitem(0)
    assert sample is not None and sample["img"].shape[-1] == 3


def test_mixpbr_concat_matches_jax(dataset_root):
    jds, pds = _build(_train_cfgs("ycbv_mixpbr", dataset_root))
    assert pds.ratios == [1.0, 2.0] and pds.dataset_length == jds.dataset_length
    assert pds.dataset_length[1] == 2 * len(pds.datasets[1])
    _compare_items(jds, pds, [0, IMAGES - 1, IMAGES, len(pds) - 1])
