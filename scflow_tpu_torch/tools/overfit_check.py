"""Learning check: overfit one synthetic batch (the port's copy of the JAX
package's tools/overfit_check.py).

    python -m scflow_tpu_torch.cli overfit [--steps 2000] [--every 200]
        [--lookup-backend xla|pallas] [--save W.pth] [--device cpu]

8 samples of 3 subdivided 80 mm cubes at 128^2, their real images rendered
at the ground-truth pose, reference poses 8 degrees and 6/6/18 mm off; an
SCFlowRefiner of 4 iterations trained on that one batch with AdamW (lr
4e-4, weight decay 1e-4, clip 10) through make_scflow_train_step, and
every `every` steps refined by make_scflow_infer_fn, printing the
train-batch ADD / diameter.  The JAX tool expects it to fall from about
0.18 (the injected pose noise) below 0.01 within 2000 steps: the render ->
recurrence -> loss -> optimizer chain learns pose refinement.

The train step keeps JAX's default lookup, 'xla' (its tensor form: on the
card only the render launches a kernel, K2); 'pallas' runs the lookup's
kernels, K1 forward and K1b backward (1 K2, 4 K1, 4 K1b per step), the
route cli train takes.  Each evaluation launches 1 K2 and 4 K1."""

import argparse
import time

import numpy as np
import torch
from scipy.spatial.transform import Rotation

H, NCLASS, BATCH, ITERS = 128, 3, 8, 4
OPTIMIZER = dict(type="AdamW", lr=4e-4, weight_decay=1e-4)
GRAD_CLIP = 10.0


def make_bank():
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    return make_synthetic_bank(NCLASS, kind="cube", size=80.0, subdivisions=2)


def make_model(image: int = H, iters: int = ITERS):
    """SCFlowRefiner(iters, detach_depth_for_xy=True) with a 3-class
    MultiClassPoseHead, PyTorch's initialisation from seed 0 (the global
    RNG is left as it was)."""
    from scflow_tpu_torch.refiners.scflow import SCFlowRefiner

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return SCFlowRefiner(num_class=NCLASS, image_size=(image, image), iters=iters,
                             detach_depth_for_xy=True,
                             pose_head_cfg=dict(type="MultiClassPoseHead", num_class=NCLASS,
                                                in_channels=224))


def make_batch(seed: int, render_assets, batch: int = BATCH, image: int = H) -> dict:
    """The tool's batch from `seed`: ground-truth poses 550-700 mm away,
    reference poses jittered by normal(0, 8) degree euler angles and
    normal(0, (6, 6, 18)) mm, real images rendered at the ground truth
    (render_and_normalize, its default 'xla' backend) with their masks;
    tensors on render_assets' device."""
    from scflow_tpu_torch.refiners.system import render_and_normalize

    r = np.random.default_rng(seed)
    gt_R = Rotation.random(batch, seed).as_matrix().astype(np.float32)
    gt_t = np.stack([r.normal(size=batch) * 15, r.normal(size=batch) * 15,
                     r.uniform(550, 700, batch)], -1).astype(np.float32)
    dR = Rotation.from_euler("xyz", r.normal(size=(batch, 3)) * 8,
                             degrees=True).as_matrix().astype(np.float32)
    ref_R = np.einsum("nij,njk->nik", dR, gt_R)
    ref_t = gt_t + r.normal(size=(batch, 3)).astype(np.float32) * np.array([6, 6, 18], np.float32)
    f, c = 280.0 * image / H, image / 2.0  # the tool's camera, scaled to `image`
    K = np.tile(np.array([[[f, 0, c], [0, f, c], [0, 0, 1]]], np.float32), (batch, 1, 1))
    labels = r.integers(0, NCLASS, batch).astype(np.int32)
    dev = render_assets.verts.device

    def t(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    real, _, gt_masks = render_and_normalize(render_assets, t(gt_R), t(gt_t), t(K),
                                             t(labels, torch.int64), (image, image),
                                             (0.0, 0.0, 0.0), (255.0,) * 3)
    return dict(real_images=real, ref_rotations=t(ref_R), ref_translations=t(ref_t),
                gt_rotations=t(gt_R), gt_translations=t(gt_t), labels=t(labels, torch.int64),
                k=t(K), gt_masks=gt_masks)


def add_err(bank, R, t, gt_R, gt_t, labels) -> np.ndarray:
    """Per-sample ADD over the bank's vertices, divided by the diameter."""
    labels = np.asarray(labels)
    pts, valid = bank.verts[labels], bank.vert_valid[labels]
    a = np.einsum("nij,nvj->nvi", np.asarray(R), pts) + np.asarray(t)[:, None]
    b = np.einsum("nij,nvj->nvi", np.asarray(gt_R), pts) + np.asarray(gt_t)[:, None]
    d = np.linalg.norm(a - b, axis=-1)
    d = (d * valid).sum(1) / valid.sum(1)
    return d / bank.diameters[labels]


def _host(batch: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in batch.items()}


def run(steps: int = 2000, every: int = 200, lookup_backend: str = "xla", device=None,
        image: int = H, batch_size: int = BATCH, iters: int = ITERS, on_step=None,
        log=None) -> dict:
    """Overfit make_batch(7) for `steps` steps on `device` (None: the card),
    refining the batch after every `every`-th step (image, batch_size and
    iters shrink the tool's sizes, for a run on the CPU); on_step(i, logs),
    if given, runs after step i (0-based) and before its evaluation (a
    caller counts each step's kernel launches there); log takes each
    printed line (default: print).  Returns
    {'init': the initial ADD/d, 'curve': [{'step', 'loss_pose',
    'loss_flow', 'loss', 'add'}, ...], 'losses': every step's loss,
    'model', 'first_step_s', 'ms_per_step' (the later steps, evaluations
    excluded; host clock, synchronised)}."""
    from scflow_tpu_torch.device import resolve_device
    from scflow_tpu_torch.refiners.system import (RenderAssets, loss_assets_from_bank,
                                                  make_scflow_infer_fn, make_scflow_train_step)
    from scflow_tpu_torch.runtime.optim import build_optimizer
    from scflow_tpu_torch.runtime.train_state import TrainState

    log = log or (lambda line: print(line, flush=True))
    dev = resolve_device(device)
    bank = make_bank()
    ra = RenderAssets.from_bank(bank, device=dev)
    la = loss_assets_from_bank(bank, {}, device=dev)
    model = make_model(image, iters).to(dev)
    batch = make_batch(7, ra, batch_size, image)
    host = _host(batch)
    tx, _ = build_optimizer(model, dict(OPTIMIZER), None, GRAD_CLIP)
    state = TrainState(model, tx)
    step = make_scflow_train_step(model, ra, la, image_size=(image, image),
                                  lookup_backend=lookup_backend, device=dev)
    infer = make_scflow_infer_fn(model, ra, image_size=(image, image), device=dev)
    a0 = add_err(bank, host["ref_rotations"], host["ref_translations"], host["gt_rotations"],
                 host["gt_translations"], host["labels"])
    log(f"init ADD/d {a0.mean():.4f}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    curve, losses, first_s, later_s = [], [], None, 0.0
    sync()
    t0 = time.perf_counter()
    for i in range(steps):
        state, logs = step(state, batch)
        losses.append(logs["loss"])
        if i == 0:
            sync()
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
        if on_step is not None:
            on_step(i, logs)
        if (i + 1) % every == 0:
            sync()
            later_s += time.perf_counter() - t0
            out = infer(batch)
            a = add_err(bank, out["rotations"].cpu().numpy(), out["translations"].cpu().numpy(),
                        host["gt_rotations"], host["gt_translations"], host["labels"])
            point = dict(step=i + 1, loss_pose=float(logs["loss_pose"]),
                         loss_flow=float(logs["loss_flow"]), loss=float(logs["loss"]),
                         add=float(a.mean()))
            curve.append(point)
            log(f"step {i + 1}: pose {point['loss_pose']:.3f} flow {point['loss_flow']:.3f} "
                f"| train-batch ADD {point['add']:.4f}")
            sync()
            t0 = time.perf_counter()
    sync()
    later_s += time.perf_counter() - t0
    return dict(init=float(a0.mean()), curve=curve,
                losses=[float(x) for x in losses], model=model, first_step_s=first_s,
                ms_per_step=1e3 * later_s / max(steps - 1, 1))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Overfit one synthetic batch (learning check)")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--every", type=int, default=200, help="refine the batch every N steps")
    p.add_argument("--lookup-backend", default="xla", choices=("xla", "pallas"),
                   help="the train step's corr lookup (JAX's default 'xla'; 'pallas': "
                        "the K1/K1b kernels)")
    p.add_argument("--save", default=None, help="write the trained weights to this .pth")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card); 'cpu' runs the plain versions")
    args = p.parse_args(argv)
    res = run(args.steps, args.every, args.lookup_backend, args.device)
    if args.save:
        from scflow_tpu_torch.runtime.checkpoint import save_params

        save_params(args.save, res["model"], {"iter": args.steps, "tool": "overfit"})
        print(f"saved {args.save}", flush=True)
    return res
