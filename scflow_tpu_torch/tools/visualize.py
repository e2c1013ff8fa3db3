"""Predicted poses drawn on the test images (the port's copy of the JAX
package's tools/visualize.py: the reference's imshow_pose_* overlays,
silhouettes from the port's renderer).

    python -m scflow_tpu_torch.cli visualize configs/refine_models/scflow.py \
        --checkpoint CKPT.pth [--num 6] [--out-dir work_dirs/vis] [--device cpu]

For each of the first --num images of data.test: its objects collated and
padded to a power-of-two bucket (eval_loop.pad_batch(_bucket(n))), refined
by the config's infer call (apis.make_infer_from_cfg; a RAFT config with
host PnP solves its poses on the host), the predicted poses rendered by
render_batch with its default arguments (the brute-force 'xla' path: no
kernel), and per object a two-panel PNG img{i:04d}_obj{j}.png (imops.imwrite):
left the reference pose's axes, right the rendered mask's contour (green)
and the predicted pose's axes, on the denormalised BGR patch; each path
printed.  The checkpoint is a .pth in the reference's layout (the port's
save_params writes one); a JAX orbax directory raises ValueError.  On the
card each image launches the infer call's kernels (SCFlow: 1 K2 and 8 K1;
RAFT: 1 K2 and 12 K1) and the silhouette render none."""

import argparse
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Draw predicted poses on test images")
    p.add_argument("config")
    p.add_argument("--checkpoint", required=True, help="a .pth (cli train's, or save_params')")
    p.add_argument("--num", type=int, default=6)
    p.add_argument("--out-dir", default="work_dirs/vis")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card); 'cpu' runs the plain versions")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns {'paths': the written files, 'poses': per image (R, t) of
    its objects, 'seconds': {'load', 'infer', 'render', 'draw'} summed over
    the images, 'images': how many}."""
    args = parse_args(argv)
    import torch

    from scflow_tpu_torch.apis import (build_render_assets, load_eval_checkpoint,
                                       make_infer_from_cfg)
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.datasets.loader import collate_batch
    from scflow_tpu_torch.datasets.pipelines.imops import imwrite
    from scflow_tpu_torch.device import resolve_device
    from scflow_tpu_torch.refiners.build import build_refiner_from_config
    from scflow_tpu_torch.registry import build_dataset
    from scflow_tpu_torch.render.renderer import render_batch
    from scflow_tpu_torch.runtime.eval_loop import _bucket, fetch, pad_batch
    from scflow_tpu_torch.visualize import imshow_pose_axis, imshow_pose_contour

    dev = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    image_size = tuple(cfg.model["renderer"].get("image_size", (256, 256)))
    with torch.random.fork_rng(devices=[]):  # the weights all come from the file
        model = build_refiner_from_config(cfg.model)
    load_eval_checkpoint(args.checkpoint, model)  # an orbax directory raises here
    model.to(dev)
    render_assets, _ = build_render_assets(cfg.model, device=dev)
    infer, pose_from_output = make_infer_from_cfg(cfg, model, render_assets, image_size,
                                                  device=dev)

    dataset = build_dataset(cfg.data["test"])
    os.makedirs(args.out_dir, exist_ok=True)
    mean = np.asarray(cfg.get("normalize_mean", [0, 0, 0]), np.float32)
    std = np.asarray(cfg.get("normalize_std", [255, 255, 255]), np.float32)
    seconds = dict(load=0.0, infer=0.0, render=0.0, draw=0.0)
    paths, poses = [], []
    count = min(args.num, len(dataset))
    for i in range(count):
        t0 = time.perf_counter()
        batch = collate_batch([dataset[i]])
        batch.pop("img_metas")
        batch.pop("per_img_patch_num")
        n = batch["labels"].shape[0]
        t1 = time.perf_counter()
        out = fetch(infer(pad_batch(batch, _bucket(n))))
        if pose_from_output is None:
            R = np.asarray(out["rotations"])[:n]
            t = np.asarray(out["translations"])[:n]
        else:
            R, t = pose_from_output(out, batch, n)
        t2 = time.perf_counter()
        # the predicted poses' silhouettes, for the contours
        h, w = image_size

        def on_dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a)[:n], dtype=dtype, device=dev)

        with torch.no_grad():
            rend = render_batch(
                render_assets.verts, render_assets.faces, render_assets.face_valid,
                render_assets.colors, render_assets.normals, render_assets.vert_valid,
                on_dev(R), on_dev(t), on_dev(batch["k"]), on_dev(batch["labels"], torch.long),
                h, w)
        masks = rend["masks"].cpu().numpy()
        t3 = time.perf_counter()
        for j in range(n):
            img = (np.asarray(batch["real_images"])[j] * std + mean)[..., ::-1]
            img = np.clip(img, 0, 255).astype(np.uint8)
            vis = imshow_pose_contour(img, masks[j], color=(0, 255, 0))
            vis = imshow_pose_axis(vis, batch["k"][j], R[j], t[j])
            ref_vis = imshow_pose_axis(img, batch["k"][j], np.asarray(batch["ref_rotations"])[j],
                                       np.asarray(batch["ref_translations"])[j])
            panel = np.concatenate([ref_vis, vis], axis=1)
            out_path = os.path.join(args.out_dir, f"img{i:04d}_obj{j}.png")
            imwrite(out_path, panel)
            print(out_path)
            paths.append(out_path)
        t4 = time.perf_counter()
        poses.append((np.asarray(R), np.asarray(t)))
        for k, dt in (("load", t1 - t0), ("infer", t2 - t1), ("render", t3 - t2),
                      ("draw", t4 - t3)):
            seconds[k] += dt
    return {"paths": paths, "poses": poses, "seconds": seconds, "images": count}
