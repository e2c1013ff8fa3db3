"""Per-mesh 3D keypoints -> the json that RemapPose and the datasets read
(the port's copy of the JAX package's tools/collect_3d_keypoints.py,
reference tools/collect_3d_keypoints.py): modes 'bbox' (the axis-aligned
box's corners), 'obb' (the oriented box's, by SVD of the centred
vertices), 'fps' (farthest point sampling from vertex 0).

    python -m scflow_tpu_torch.cli keypoints data/ycbv/models_eval \
        --out data/ycbv/keypoints/bbox.json [--mode bbox|obb|fps] [--num 8]

Host numpy only, like the JAX tool, so it takes no --device."""

import argparse
import glob
import json
import os

import numpy as np


def bbox_corners(verts):
    mn, mx = verts.min(0), verts.max(0)
    return np.array(
        [[x, y, z] for x in (mn[0], mx[0]) for y in (mn[1], mx[1]) for z in (mn[2], mx[2])],
        np.float32,
    )


def obb_corners(verts):
    mean = verts.mean(0)
    centered = verts - mean
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    local = centered @ vt.T
    mn, mx = local.min(0), local.max(0)
    corners_local = np.array(
        [[x, y, z] for x in (mn[0], mx[0]) for y in (mn[1], mx[1]) for z in (mn[2], mx[2])],
        np.float32,
    )
    return corners_local @ vt + mean


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Collect per-mesh 3D keypoints into a json")
    p.add_argument("mesh_dir")
    p.add_argument("--out", required=True)
    p.add_argument("--mode", choices=["bbox", "obb", "fps"], default="bbox")
    p.add_argument("--num", type=int, default=8)
    return p.parse_args(argv)


def main(argv=None) -> list:
    """Writes the json (one list of [x, y, z] per mesh, in the sorted
    order of mesh_dir/*.ply) and returns it."""
    args = parse_args(argv)
    from scflow_tpu_torch.ops.fps import farthest_point_sample
    from scflow_tpu_torch.render.ply import load_ply

    paths = sorted(glob.glob(os.path.join(args.mesh_dir, "*.ply")))
    if not paths:
        raise FileNotFoundError(f"no meshes in {args.mesh_dir}")
    all_kps = []
    for path in paths:
        v = load_ply(path).vertices
        if args.mode == "bbox":
            kp = bbox_corners(v)[: args.num]
        elif args.mode == "obb":
            kp = obb_corners(v)[: args.num]
        else:
            kp = v[farthest_point_sample(v, args.num)]
        all_kps.append(kp.tolist())
        print(f"{os.path.basename(path)}: {len(kp)} keypoints")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(all_kps, f)
    print(f"wrote {args.out}")
    return all_kps
