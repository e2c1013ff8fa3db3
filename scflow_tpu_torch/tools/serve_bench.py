"""Serving throughput benchmark (BASELINE config 5; the port's copy of the
JAX package's tools/serve_bench.py): multi-object batched refinement with
the crop on the device, optionally bf16, data-parallel over every visible
card.

    python -m scflow_tpu_torch.cli serve-bench [--batch 64] [--img 256]
        [--iters 8] [--dtype bf16] [--frames 4] [--render-backend pallas|xla]
        [--rounds 20] [--device cpu]

Per card, `--batch` objects cropped from `--frames` noise frames, refined
by make_serving_fn(slim=True, render_cull_backfaces=True) with seeded
weights: P = batch x cards objects a call, the rows split over the cards
(parallel.batch_sharding) and the frames and weights copied to each
(replicated_sharding, replicate); one serve fn per card, launched in turn.
One warm call, then --rounds timed calls, synchronised by a host fetch of
every card's rotations.  Each call launches 8 K1 (K1's bf16 instance in
bf16) and 1 K2 per card.  --device (one device) is the port's addition."""

import argparse
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Serving throughput benchmark")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--img", type=int, default=256)
    p.add_argument("--frame-hw", type=int, nargs=2, default=[480, 640])
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--nclass", type=int, default=21)
    p.add_argument("--dtype", choices=["fp32", "bf16"], default="bf16")
    p.add_argument("--render-backend", default=None,
                   help="default: pallas on a card, xla elsewhere")
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--device", default=None,
                   help="one torch device (default: every visible card); 'cpu' runs the "
                        "plain versions")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Prints the devices line and the serving line; returns {'devices',
    'objects' (P), 'seconds' (the timed rounds), 'refinements_per_s',
    'per_device', 'ms_per_call'}."""
    args = parse_args(argv)
    import torch
    from scipy.spatial.transform import Rotation

    from scflow_tpu_torch.parallel import (batch_sharding, make_mesh, replicate,
                                           replicated_sharding)
    from scflow_tpu_torch.refiners.scflow import SCFlowRefiner
    from scflow_tpu_torch.refiners.system import RenderAssets
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank
    from scflow_tpu_torch.serving import make_serving_fn

    mesh = make_mesh(devices=[args.device] if args.device else None)
    n_dev = mesh.size
    platform = mesh.devices[0].type
    backend = args.render_backend or ("pallas" if platform == "cuda" else "xla")
    dtype = torch.bfloat16 if args.dtype == "bf16" else None
    print(f"{n_dev} device(s), backend={platform}, render={backend}, dtype={args.dtype}",
          flush=True)

    bank = make_synthetic_bank(args.nclass, kind="uvsphere", size=80.0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = SCFlowRefiner(
            num_class=args.nclass, image_size=(args.img, args.img), iters=args.iters,
            detach_depth_for_xy=True, dtype=dtype,
            pose_head_cfg=dict(type="MultiClassPoseHead", num_class=args.nclass,
                               in_channels=224))
    model.to(mesh.devices[0])

    rng = np.random.default_rng(0)
    P = args.batch * n_dev
    hf, wf = args.frame_hw
    frames = rng.uniform(0, 255, (args.frames, hf, wf, 3)).astype(np.float32)
    frame_idx = rng.integers(0, args.frames, P).astype(np.int32)
    R = Rotation.random(P, 1).as_matrix().astype(np.float32)
    t = np.stack([rng.normal(size=P) * 60, rng.normal(size=P) * 40,
                  rng.uniform(700, 1100, P)], -1).astype(np.float32)
    K = np.tile(np.array([[[572.4, 0, wf / 2], [0, 573.5, hf / 2], [0, 0, 1]]], np.float32),
                (P, 1, 1))
    labels = rng.integers(0, args.nclass, P).astype(np.int32)

    # slim=True is the shipped service's configuration (PoseService fetches
    # poses only); the synthetic bank is closed and outward-wound, so
    # culling back faces leaves the output as it is
    serves = []
    for replica, dev in zip(replicate(model, mesh), mesh.devices):
        assets = RenderAssets.from_bank(bank, device=dev)
        serves.append(make_serving_fn(replica, assets, assets.verts, assets.vert_valid,
                                      image_size=args.img, render_backend=backend,
                                      iters=args.iters, slim=True, render_cull_backfaces=True,
                                      device=dev))
    shards = list(zip(replicated_sharding(mesh).place(frames),
                      *(batch_sharding(mesh).place(x) for x in (frame_idx, R, t, K, labels))))

    def call():
        return [serve(*shard) for serve, shard in zip(serves, shards)]

    def fetch(outs):  # the host fetch waits for every card's work
        return float(sum(np.asarray(o["rotations"].cpu()).sum() for o in outs))

    fetch(call())
    t0 = time.perf_counter()
    for _ in range(args.rounds):
        outs = call()
    fetch(outs)
    dt = time.perf_counter() - t0

    total = P * args.rounds / dt
    print(f"serving: {total:.1f} refinements/s total, {total / n_dev:.1f} /s/chip "
          f"({dt / args.rounds * 1e3:.1f} ms / {P}-object step, incl. "
          f"device-side crop+render)", flush=True)
    return dict(devices=[str(d) for d in mesh.devices], objects=P, seconds=dt,
                refinements_per_s=total, per_device=total / n_dev,
                ms_per_call=dt / args.rounds * 1e3)
