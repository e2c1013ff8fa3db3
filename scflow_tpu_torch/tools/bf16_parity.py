"""bf16 ADD-parity protocol at eval scale (the port's copy of the JAX
package's tools/bf16_parity.py): does serving in bf16 keep the ADD(-S)
table of fp32 on trained weights?

    python -m scflow_tpu_torch.cli bf16-parity [--root DIR] [--num-images 125]
        [--num-class 8] [--sym-classes 2,5,8] [--ckpt-levels 1500,4500]
        [--tolerance 1e-3] [--skip-train] [--device cpu]

Protocol, all through the port's user-facing commands, each in a process
of its own (python -m scflow_tpu_torch.cli ...):
  1. build a synthetic BOP set (datasets/synthetic.py; default 125 images
     x 8 classes = 1,000 poses per checkpoint, 3 of the classes symmetric
     so the ADD-S nearest-neighbour path is exercised; PoseJitter makes the
     refinement task) and a flagship-shape config: 256^2 crops, 8 GRU
     iterations, SCFlowRefiner;
  2. `cli train` to the last checkpoint level, saving at each level
     (work/checkpoints/iter_N.pth, runtime/checkpoint.py's layout);
  3. per checkpoint, `cli test --eval --out` twice: fp32 and
     `--cfg-options model.dtype=bf16` (the serving dtype);
  4. compare the ADD metric tables (every entry's |delta| must stay under
     --tolerance, 1e-3 = 0.1%), recompute per-pose ADD(-S) from the --out
     files and count the threshold crossings (poses whose pass/fail flips
     between the dtypes), state the table's resolution (1/poses per class
     entry), and report the per-pose rotation and translation divergence
     (mean/p95/max).

Writes ROOT/report.json, prints PROTOCOL PASS or FAIL and exits 1 on FAIL.
--device goes to every command (default: the card)."""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]

CONFIG_TMPL = '''
dataset_root = r"{root}"
CLASS_NAMES = {class_names}
symmetry_types = {sym_types}
mesh_diameter = {diameters}
image_scale = 256
normalize_mean = [0.0, 0.0, 0.0]
normalize_std = [255.0, 255.0, 255.0]

train_pipeline = [
    dict(type="LoadImages", color_type="unchanged"),
    dict(type="LoadMasks"),
    dict(type="PoseJitter", jitter_angle_dis=(0, 10), jitter_x_dis=(0, 8),
         jitter_y_dis=(0, 8), jitter_z_dis=(0, 20), angle_limit=45,
         translation_limit=200, add_limit=1.0,
         mesh_dir=dataset_root + "/models_eval", mesh_diameter=mesh_diameter,
         jitter_pose_field=["gt_rotations", "gt_translations"],
         jittered_pose_field=["ref_rotations", "ref_translations"]),
    dict(type="ComputeBbox", mesh_dir=dataset_root + "/models_eval", clip_border=False),
    dict(type="Crop", size_range=(1.0, 1.25), crop_bbox_field="ref_bboxes",
         clip_border=False, pad_val=128),
    dict(type="Resize", img_scale=image_scale, keep_ratio=True),
    dict(type="Pad", size=(image_scale, image_scale), center=True,
         pad_val=dict(img=(128, 128, 128), mask=0)),
    dict(type="RemapPose", keep_intrinsic=False),
    dict(type="Normalize", mean=normalize_mean, std=normalize_std, to_rgb=True),
    dict(type="ToTensor", stack_keys=[]),
    dict(type="Collect",
         annot_keys=["ref_rotations", "ref_translations", "gt_rotations",
                     "gt_translations", "gt_masks", "init_add_error",
                     "init_rot_error", "init_trans_error", "k", "labels"],
         meta_keys=("img_path", "ori_shape", "ori_k", "img_shape",
                    "img_norm_cfg", "scale_factor", "transform_matrix",
                    "ori_gt_rotations", "ori_gt_translations")),
]
test_pipeline = [
    dict(type="LoadImages", color_type="unchanged"),
    dict(type="ComputeBbox", mesh_dir=dataset_root + "/models_eval",
         clip_border=False, filter_invalid=False),
    dict(type="Crop", size_range=(1.1, 1.1), crop_bbox_field="ref_bboxes",
         clip_border=False, pad_val=128),
    dict(type="Resize", img_scale=image_scale, keep_ratio=True),
    dict(type="Pad", size=(image_scale, image_scale), center=True,
         pad_val=dict(img=(128, 128, 128), mask=0)),
    dict(type="RemapPose", keep_intrinsic=False),
    dict(type="Normalize", mean=normalize_mean, std=normalize_std, to_rgb=True),
    dict(type="ToTensor", stack_keys=[]),
    dict(type="Collect",
         annot_keys=["ref_rotations", "ref_translations", "gt_rotations",
                     "gt_translations", "labels", "k", "ori_k",
                     "transform_matrix"],
         meta_keys=("img_path", "ori_shape", "img_shape", "img_norm_cfg",
                    "scale_factor", "keypoints_3d", "geometry_transform_mode",
                    "transform_matrix", "ori_k")),
]

data = dict(
    samples_per_gpu=2,
    workers_per_gpu=2,
    test_samples_per_gpu=1,
    train=dict(
        type="SuperviseTrainDataset",
        data_root=dataset_root + "/train_real",
        gt_annots_root=dataset_root + "/train_real",
        image_list=dataset_root + "/image_lists/train.txt",
        keypoints_json=dataset_root + "/keypoints.json",
        pipeline=train_pipeline, class_names=CLASS_NAMES, keypoints_num=8,
        sample_num=1, mesh_symmetry=symmetry_types,
        meshes_eval=dataset_root + "/models_eval", mesh_diameter=mesh_diameter,
    ),
    test=dict(
        type="RefineDataset",
        data_root=dataset_root + "/train_real",
        ref_annots_root=dataset_root + "/initial_poses",
        image_list=dataset_root + "/image_lists/train.txt",
        keypoints_json=dataset_root + "/keypoints.json",
        pipeline=test_pipeline, class_names=CLASS_NAMES, keypoints_num=8,
        mesh_symmetry=symmetry_types,
        meshes_eval=dataset_root + "/models_eval", mesh_diameter=mesh_diameter,
    ),
)

model = dict(
    type="SCFlowRefiner",
    cxt_channels=128, h_channels=128, seperate_encoder=False, max_flow=400.0,
    filter_invalid_flow=True,
    filter_invalid_flow_by_mask=True,
    encoder=dict(type="RAFTEncoder", in_channels=3, out_channels=256,
                 net_type="Basic", norm_cfg=dict(type="IN")),
    cxt_encoder=dict(type="RAFTEncoder", in_channels=3, out_channels=256,
                     net_type="Basic", norm_cfg=dict(type="BN")),
    decoder=dict(
        type="SCFlowDecoder", net_type="Basic", num_levels=4, radius=4,
        iters=8, detach_flow=True, detach_mask=True, detach_pose=True,
        detach_depth_for_xy=True, mask_flow=False, mask_corr=False,
        unroll=False,  # scan decoder: 6x faster train compile, same params
        pose_head_cfg=dict(type="MultiClassPoseHead", num_class={num_class},
                           in_channels=224, rotation_mode="ortho6d"),
        gru_type="SeqConv"),
    flow_loss_cfg=dict(type="SequenceLoss", gamma=0.8,
                       loss_func_cfg=dict(type="RAFTLoss", loss_weight=0.1,
                                          max_flow=400.0)),
    pose_loss_cfg=dict(type="SequenceLoss", gamma=0.8,
                       loss_func_cfg=dict(
                           type="DisentanglePointMatchingLoss",
                           symmetry_types=symmetry_types,
                           mesh_diameter=mesh_diameter,
                           mesh_path=dataset_root + "/models_eval",
                           loss_type="l1", disentangle_z=True,
                           loss_weight=10.0)),
    mask_loss_cfg=dict(type="SequenceLoss", gamma=0.8,
                       loss_func_cfg=dict(type="L1Loss", loss_weight=10.0)),
    train_cfg=dict(),
    test_cfg=dict(iters=8, sample_points=dict(num=500, mode="topk")),
    renderer=dict(mesh_dir=dataset_root + "/models_1024",
                  image_size=(image_scale, image_scale),
                  shader_type="Phong", background_color=(0.5, 0.5, 0.5)),
)

optimizer = dict(type="AdamW", lr=4e-4, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=1e-4)
optimizer_config = dict(grad_clip=dict(max_norm=10.0))
lr_config = dict(policy="OneCycle", max_lr=4e-4, total_steps={total_steps},
                 pct_start=0.05, anneal_strategy="linear")
evaluation = dict(interval=1000000, metric={{"add": [0.05, 0.1, 0.2, 0.5]}},
                  save_best="average/add_10", rule="greater")
runner = dict(type="IterBasedRunner", max_iters={max_iters})
checkpoint_config = dict(interval={ckpt_interval}, by_epoch=False, max_keep=-1)
log_config = dict(interval=100, hooks=[dict(type="TextLoggerHook")])
work_dir = r"{work_dir}"
'''


def run(cmd, extra_env=None):
    env = dict(os.environ)
    env.update(extra_env or {})
    print("+", " ".join(cmd), flush=True)
    r = subprocess.run(cmd, cwd=str(REPO), env=env, text=True)
    if r.returncode != 0:
        sys.exit(f"command failed ({r.returncode}): {' '.join(cmd)}")


def rot_angle_deg(Ra, Rb):
    """Geodesic angle between rotation-matrix batches (degrees)."""
    tr = np.einsum("nij,nij->n", Ra, Rb)
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


def pose_divergence(out_a, out_b) -> dict:
    """Per-pose rotation (degrees) and translation (mm) distance between
    two --out files of the same images: poses, mean, p95 and max."""
    ra = json.loads(Path(out_a).read_text())
    rb = json.loads(Path(out_b).read_text())
    if len(ra) != len(rb):
        raise ValueError(f"{out_a} holds {len(ra)} images, {out_b} {len(rb)}")
    rots, trans = [], []
    for a, b in zip(ra, rb):
        Ra = np.asarray(a["pred"]["rotations"], np.float64)
        Rb = np.asarray(b["pred"]["rotations"], np.float64)
        ta = np.asarray(a["pred"]["translations"], np.float64)
        tb = np.asarray(b["pred"]["translations"], np.float64)
        rots.append(rot_angle_deg(Ra, Rb))
        trans.append(np.linalg.norm(ta - tb, axis=-1))
    rots = np.concatenate(rots)
    trans = np.concatenate(trans)

    def pct(x, q):
        return float(np.percentile(x, q))

    return dict(poses=int(rots.size), rot_mean_deg=float(rots.mean()),
                rot_p95_deg=pct(rots, 95), rot_max_deg=float(rots.max()),
                trans_mean_mm=float(trans.mean()), trans_p95_mm=pct(trans, 95),
                trans_max_mm=float(trans.max()))


def per_pose_add(results_path, data_root, verts_by_class, sym_ids):
    """Per-pose ADD(-S) errors recomputed from the --out result dicts and the
    synthetic scene_gt (models_eval vertices; ADD-S, the mean distance from
    each ground-truth point to its nearest predicted one, for the
    symmetric classes, the reference's eval_pose_error semantics).
    Returns aligned [(img_id, label, err), ...]."""
    results = json.loads(Path(results_path).read_text())
    scene_gt = json.loads(
        (Path(data_root) / "train_real" / "000001" / "scene_gt.json").read_text())
    errs = []
    for r in results:
        img_id = int(Path(r["img_metas"]["img_path"]).stem)
        gts = {g["obj_id"]: g for g in scene_gt[str(img_id)]}
        labels = np.asarray(r["pred"]["labels"])
        Rp = np.asarray(r["pred"]["rotations"], np.float64)
        tp = np.asarray(r["pred"]["translations"], np.float64)
        for i, lab in enumerate(labels):
            g = gts[int(lab) + 1]
            Rg = np.asarray(g["cam_R_m2c"], np.float64).reshape(3, 3)
            tg = np.asarray(g["cam_t_m2c"], np.float64)
            v = verts_by_class[int(lab)]
            a = v @ Rp[i].T + tp[i]
            b = v @ Rg.T + tg
            if int(lab) in sym_ids:
                e = np.sqrt(((b[:, None] - a[None]) ** 2).sum(-1)).min(1).mean()
            else:
                e = np.linalg.norm(a - b, axis=-1).mean()
            errs.append((img_id, int(lab), float(e)))
    return errs


def threshold_crossings(err_a, err_b, diameters, thresholds) -> dict:
    """Poses whose ADD pass/fail flips between the two dtypes at each
    threshold: the per-pose evidence behind an unchanged table (a 0.0
    table delta with no crossing is exact agreement)."""
    cross = {str(t): 0 for t in thresholds}
    for (ia, la, ea), (ib, lb, eb) in zip(err_a, err_b):
        if (ia, la) != (ib, lb):
            raise ValueError(f"result lists misaligned: {(ia, la)} against {(ib, lb)}")
        d = diameters[la]
        for t in thresholds:
            if (ea < t * d) != (eb < t * d):
                cross[str(t)] += 1
    return cross


def latest_eval_json(work_dir) -> dict:
    evals = sorted(Path(work_dir).glob("eval_*.json"), key=lambda p: p.stat().st_mtime)
    if not evals:
        raise FileNotFoundError(f"no eval json in {work_dir}")
    return json.loads(evals[-1].read_text())


def cli(command: str, *args) -> list:
    return [sys.executable, "-m", "scflow_tpu_torch.cli", command, *args]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="bf16 ADD-parity protocol on trained weights")
    p.add_argument("--root", default="/tmp/bf16_parity")
    p.add_argument("--num-images", type=int, default=125)
    p.add_argument("--num-class", type=int, default=8)
    p.add_argument("--sym-classes", default="2,5,8",
                   help="1-based class ids treated as symmetric (the ADD-S "
                        "nearest-neighbour path)")
    p.add_argument("--ckpt-levels", default="1500,4500",
                   help="comma-separated train-iter checkpoint levels")
    p.add_argument("--tolerance", type=float, default=1e-3,
                   help="max |delta| on any metric-table entry (0.1%%)")
    p.add_argument("--skip-train", action="store_true",
                   help="reuse existing checkpoints under --root")
    p.add_argument("--device", default=None,
                   help="torch device of every command (default: the card); 'cpu' runs "
                        "the plain versions")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """The protocol; returns 0 on PASS and raises SystemExit(1) on FAIL."""
    args = parse_args(argv)
    root = Path(args.root)
    levels = [int(x) for x in args.ckpt_levels.split(",")]
    work_dir = root / "work"
    device = ["--device", args.device] if args.device else []

    data_root = root / "data"
    if not (data_root / "keypoints.json").exists():
        from scflow_tpu_torch.datasets.synthetic import build_synthetic_bop

        print(f"building synthetic BOP set: {args.num_images} images x "
              f"{args.num_class} classes", flush=True)
        info = build_synthetic_bop(data_root, num_images=args.num_images,
                                   num_class=args.num_class, render_images=True,
                                   device=args.device)
        (root / "diameters.json").write_text(json.dumps(info["diameters"]))
    diameters = json.loads((root / "diameters.json").read_text())

    sym_1based = [int(x) for x in args.sym_classes.split(",") if int(x) <= args.num_class]
    sym_types = {f"cls_{i}": {} for i in sym_1based}
    sym_ids = {i - 1 for i in sym_1based}  # 0-based labels

    cfg_path = root / "cfg.py"
    names = tuple(f"obj_{i}" for i in range(args.num_class))
    cfg_path.write_text(CONFIG_TMPL.format(
        root=data_root, class_names=repr(names), diameters=diameters,
        num_class=args.num_class, work_dir=work_dir, sym_types=repr(sym_types),
        max_iters=max(levels), total_steps=max(levels) + 100,
        ckpt_interval=int(np.gcd.reduce(levels))))

    # vertex banks for the per-pose ADD (the synthesis of the set's
    # models_eval; at most 400 vertices keep ADD-S's O(V^2) cheap)
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    bank = make_synthetic_bank(args.num_class, size=60.0)
    verts_by_class = []
    for c in range(args.num_class):
        v = bank.verts[c][bank.vert_valid[c]].astype(np.float64)
        if len(v) > 400:
            v = v[np.linspace(0, len(v) - 1, 400).astype(int)]
        verts_by_class.append(v)

    if not args.skip_train:
        run(cli("train", str(cfg_path), *device))

    report = {"config": vars(args), "checkpoints": {}}
    ok = True
    for level in levels:
        ckpt = work_dir / "checkpoints" / f"iter_{level}.pth"
        if not ckpt.exists():
            raise FileNotFoundError(f"missing checkpoint {ckpt}")
        outs = {}
        for dtype in ("fp32", "bf16"):
            out_json = root / f"out_{level}_{dtype}.json"
            cmd = cli("test", str(cfg_path), "--checkpoint", str(ckpt), "--eval",
                      "--out", str(out_json), *device)
            if dtype == "bf16":
                cmd += ["--cfg-options", "model.dtype=bf16"]
            run(cmd)
            outs[dtype] = dict(results=str(out_json), metrics=latest_eval_json(work_dir))
        table_a, table_b = outs["fp32"]["metrics"], outs["bf16"]["metrics"]
        deltas = {k: abs(table_a[k] - table_b[k]) for k in table_a if k in table_b}
        worst = max(deltas, key=deltas.get)
        div = pose_divergence(outs["fp32"]["results"], outs["bf16"]["results"])
        thresholds = (0.05, 0.1, 0.2, 0.5)
        err_a = per_pose_add(outs["fp32"]["results"], data_root, verts_by_class, sym_ids)
        err_b = per_pose_add(outs["bf16"]["results"], data_root, verts_by_class, sym_ids)
        cross = threshold_crossings(err_a, err_b, diameters, thresholds)
        n_poses = len(err_a)
        n_per_class = n_poses // args.num_class
        entry = dict(
            fp32_table=table_a, bf16_table=table_b,
            max_table_delta=deltas[worst], worst_entry=worst,
            table_entries=len(deltas), divergence=div,
            threshold_crossings=cross, poses=n_poses, sym_classes_1based=sym_1based,
            resolution_per_class_entry=1.0 / max(n_per_class, 1),
            resolution_average_entry=1.0 / max(n_poses, 1),
            passed=deltas[worst] < args.tolerance)
        ok = ok and entry["passed"]
        report["checkpoints"][str(level)] = entry
        print(f"[ckpt {level}] max ADD-table delta {deltas[worst]:.2e} "
              f"({worst}) over {len(deltas)} entries across "
              f"{div['poses']} poses; threshold crossings "
              f"{cross} of {n_poses} poses "
              f"(entry resolution 1/{n_per_class} per class, "
              f"1/{n_poses} average); rot divergence mean/p95/max "
              f"{div['rot_mean_deg']:.2f}/{div['rot_p95_deg']:.2f}/"
              f"{div['rot_max_deg']:.2f} deg -> "
              f"{'PASS' if entry['passed'] else 'FAIL'}", flush=True)

    report["passed"] = ok
    report["tolerance"] = args.tolerance
    (root / "report.json").write_text(json.dumps(report, indent=2))
    print(f"report: {root / 'report.json'}")
    print("PROTOCOL", "PASS" if ok else "FAIL", flush=True)
    if not ok:
        sys.exit(1)
    return 0
