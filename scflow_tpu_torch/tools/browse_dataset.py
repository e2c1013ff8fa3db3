"""Visual QA of the data pipeline: augmented samples written with their
pose overlays (the port's copy of the JAX package's
tools/browse_dataset.py, the reference's browse_dataset.py and
browse_dataset_patch.py merged; images are written, not shown).

    python -m scflow_tpu_torch.cli browse configs/refine_models/scflow.py \
        [--split train|val|test] [--num 8] [--out-dir work_dirs/browse] \
        [--skip-types RandomHSV RandomNoise ...] [--device cpu]

Each object patch of the first --num samples of data.<split>: denormalised
(the config's normalize_mean/std), RGB -> BGR, the object's axes drawn at
its reference pose (else its ground truth; visualize.imshow_pose_axis),
written as a PNG (imops.imwrite) sample_{i:04d}_{j}.png, its path printed.
--skip-types drops those transforms from the pipeline; a skipped
PoseJitter-style transform (one that names jitter_pose_field and
jittered_pose_field) becomes a CopyFields from the one to the other, so
the reference pose is the ground truth.  The pipeline is host numpy: the
device is resolved (the card unless --device cpu) and nothing runs on
it."""

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Write augmented samples with pose overlays")
    p.add_argument("config")
    p.add_argument("--split", default="train", choices=["train", "val", "test"])
    p.add_argument("--num", type=int, default=8)
    p.add_argument("--out-dir", default="work_dirs/browse")
    p.add_argument("--skip-types", nargs="*", default=[])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card); the pipeline and the drawing are "
                        "host numpy")
    return p.parse_args(argv)


def skip_transforms(pipeline, skip_types):
    """The pipeline without the transforms of skip_types; a skipped
    PoseJitter-style transform still seeds its output pose fields for the
    transforms after it: CopyFields(jitter_pose_field -> jittered_pose_field),
    ref = gt."""
    out = []
    for t in pipeline:
        if t.get("type") not in skip_types:
            out.append(t)
        elif "jittered_pose_field" in t and "jitter_pose_field" in t:
            out.append(dict(type="CopyFields", src=list(t["jitter_pose_field"]),
                            dst=list(t["jittered_pose_field"])))
    return out


def main(argv=None) -> list:
    """Returns the written paths."""
    args = parse_args(argv)
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.datasets.pipelines.imops import imwrite
    from scflow_tpu_torch.device import resolve_device
    from scflow_tpu_torch.registry import build_dataset
    from scflow_tpu_torch.visualize import imshow_pose_axis

    resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    dcfg = dict(cfg.data[args.split])
    if args.skip_types:
        dcfg["pipeline"] = skip_transforms(dcfg["pipeline"], args.skip_types)
    dataset = build_dataset(dcfg)
    os.makedirs(args.out_dir, exist_ok=True)

    mean = np.asarray(cfg.get("normalize_mean", [0, 0, 0]), np.float32)
    std = np.asarray(cfg.get("normalize_std", [255, 255, 255]), np.float32)
    paths = []
    for i in range(min(args.num, len(dataset))):
        sample = dataset[i]
        imgs = np.asarray(sample["img"])  # (n, H, W, 3) normalised RGB
        annots = sample["annots"]
        for j in range(len(imgs)):
            img = (imgs[j] * std + mean)[..., ::-1]  # denormalise, RGB -> BGR
            img = np.clip(img, 0, 255).astype(np.uint8)
            rot_key = "ref_rotations" if "ref_rotations" in annots else "gt_rotations"
            trans_key = rot_key.replace("rotations", "translations")
            vis = imshow_pose_axis(img, annots["k"][j], annots[rot_key][j],
                                   annots[trans_key][j])
            out_path = os.path.join(args.out_dir, f"sample_{i:04d}_{j}.png")
            imwrite(out_path, vis)
            print(out_path)
            paths.append(out_path)
    return paths
