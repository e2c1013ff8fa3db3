"""Build everything a deployment needs before its first request (the port's
copy of the JAX package's tools/warmup_cache.py).

    python -m scflow_tpu_torch.cli warmup configs/refine_models/scflow.py \
        [--what train,infer,serve] [--frame-hw 480 640] [--max-objects 64]
        [--cfg-options ...] [--device cpu]

First ops/cuda/build.py::build_all(): nvcc compiles every kernel library
that build/kernels/ lacks (named by a hash of its source, headers and
flags).  Those libraries are the one cache of the card that outlives the
process, the counterpart of JAX's persistent compilation cache.  Then one
call of each infer bucket, of the serving fn and of the train step for the
config, on the config's meshes and seeded random weights (the values do
not matter), each with its first-call time.  cuDNN's autotuning, the
allocator's pools and the CUDA context do not persist, so the printed
times are what a fresh process's first calls cost.  On --device cpu no
kernel is built: the plain versions run."""

import argparse
import copy
import time

import numpy as np


def synthetic_batch(n, image_size, num_class, train=True):
    """Random arrays with the dtypes and shapes of the steps' batches (the
    values do not matter)."""
    h, w = image_size
    rng = np.random.default_rng(0)
    from scipy.spatial.transform import Rotation

    batch = {
        "real_images": rng.normal(size=(n, h, w, 3)).astype(np.float32) * 0.2,
        "ref_rotations": Rotation.random(n, rng).as_matrix().astype(np.float32),
        "ref_translations": np.tile(np.array([[0, 0, 700.0]], np.float32), (n, 1)),
        "k": np.tile(np.array([[[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]]], np.float32),
                     (n, 1, 1)),
        "labels": rng.integers(0, num_class, n).astype(np.int32),
    }
    if train:
        batch["gt_rotations"] = Rotation.random(n, rng).as_matrix().astype(np.float32)
        batch["gt_translations"] = batch["ref_translations"] + 5.0
        batch["gt_masks"] = (rng.uniform(size=(n, h, w)) > 0.5).astype(np.float32)
    return batch


def _sync(tree) -> None:
    """Fetch one value of every tensor in the dict: the host waits for the
    work behind it."""
    for leaf in tree.values():
        if hasattr(leaf, "cpu"):
            leaf.reshape(-1)[:1].cpu()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Build the kernels and make each step's first call")
    p.add_argument("config")
    p.add_argument("--what", default="train,infer,serve")
    p.add_argument("--frame-hw", type=int, nargs=2, default=[480, 640],
                   help="serving frame size (must match cli serve)")
    p.add_argument("--max-objects", type=int, default=64,
                   help="serving batch budget (must match cli serve)")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card); 'cpu' builds nothing and runs "
                        "the plain versions")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns {'build_s' (None on the CPU), 'infer_s' {bucket: s},
    'serve_s', 'train_s'}: the seconds of each first call made."""
    args = parse_args(argv)
    what = set(args.what.split(","))
    import torch

    from scflow_tpu_torch.apis import (build_loss_assets, build_render_assets,
                                       init_model_variables, make_infer_from_cfg,
                                       make_serving_from_cfg, make_train_step_from_cfg)
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.device import resolve_device
    from scflow_tpu_torch.parallel import make_mesh, replicate
    from scflow_tpu_torch.refiners.build import build_refiner_from_config
    from scflow_tpu_torch.runtime.optim import build_optimizer
    from scflow_tpu_torch.runtime.train_state import TrainState

    dev = resolve_device(args.device)
    times = {"build_s": None, "infer_s": {}, "serve_s": None, "train_s": None}
    if dev.type == "cuda":
        from scflow_tpu_torch.ops.cuda.build import BUILD_DIR, build_all

        t0 = time.perf_counter()
        built = build_all()
        times["build_s"] = time.perf_counter() - t0
        print(f"kernels built in {times['build_s']:.1f}s ({len(built)} compiled, the rest "
              f"found under {BUILD_DIR})", flush=True)
    else:
        print(f"device {dev}: no kernel to build (the plain versions run)", flush=True)

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(Config.parse_options(args.cfg_options))
    image_size = tuple(cfg.model["renderer"].get("image_size", (256, 256)))
    with torch.random.fork_rng(devices=[]):  # init_model_variables sets every weight
        model = build_refiner_from_config(cfg.model)
    render_assets, bank = build_render_assets(cfg.model, device=dev)
    init_model_variables(cfg.model, model, device=dev)
    # as cli serve: data-parallel over every visible card unless --device
    mesh = None
    if dev.type == "cuda" and args.device is None and torch.cuda.device_count() > 1:
        mesh = make_mesh()
    n_dev = mesh.size if mesh is not None else 1
    print(f"backend={dev.type}, {n_dev} device(s), image_size={image_size}", flush=True)

    if "infer" in what:
        infer, _ = make_infer_from_cfg(cfg, model, render_assets, image_size, device=dev)
        test_cfg = cfg.model.get("test_cfg", {})
        max_bucket = test_cfg.get("max_bucket", 64)
        if test_cfg.get("fixed_bucket", False):
            buckets = [max_bucket]
        else:
            buckets, b = [], 1
            while b <= max_bucket:
                buckets.append(b)
                b *= 2
        for n in buckets:
            t0 = time.perf_counter()
            _sync(infer(synthetic_batch(n, image_size, bank.num_class, train=False)))
            times["infer_s"][n] = time.perf_counter() - t0
            print(f"infer bucket {n} first call in {times['infer_s'][n]:.1f}s", flush=True)

    if "serve" in what:
        from scflow_tpu_torch.runtime.server import PoseService

        t0 = time.perf_counter()
        # built as cli serve builds it, so the serve fn (norm stats, iterations,
        # culling) is the server's
        serve_fns = []
        for replica in ([model] if mesh is None else replicate(model, mesh)):
            rdev = next(replica.parameters()).device
            assets = render_assets if rdev == dev else build_render_assets(cfg.model, rdev)[0]
            serve_fn, fetch_keys, post_fn = make_serving_from_cfg(cfg, replica, assets,
                                                                  device=rdev)
            serve_fns.append(serve_fn)
        service = PoseService(serve_fns[0] if mesh is None else serve_fns,
                              frame_hw=tuple(args.frame_hw), num_class=bank.num_class,
                              max_objects=args.max_objects, mesh=mesh, fetch_keys=fetch_keys,
                              post_fn=post_fn, device=dev)
        service.warmup()
        times["serve_s"] = time.perf_counter() - t0
        print(f"serving fn first call in {times['serve_s']:.1f}s", flush=True)

    if "train" in what:
        # last, and on a copy: the step updates its model in place
        t0 = time.perf_counter()
        own = copy.deepcopy(model)
        loss_assets = build_loss_assets(cfg.model, bank.num_class, device=dev)
        opt_config = cfg.get("optimizer_config", {})
        tx, _ = build_optimizer(own, dict(cfg.optimizer), dict(cfg.get("lr_config", {})),
                                opt_config.get("grad_clip", {}).get("max_norm"),
                                frozen_prefixes=opt_config.get("frozen_prefixes"))
        train_step = make_train_step_from_cfg(cfg, own, render_assets, loss_assets, image_size,
                                              device=dev)
        # one process trains on one card (a job of several runs one per card)
        n = cfg.data.get("samples_per_gpu", 16)
        _, logs = train_step(TrainState(own, tx),
                             synthetic_batch(n, image_size, bank.num_class, train=True))
        _sync(logs)
        times["train_s"] = time.perf_counter() - t0
        print(f"train step (batch {n}) first call in {times['train_s']:.1f}s", flush=True)

    print("cache warm", flush=True)
    return times
