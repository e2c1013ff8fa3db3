"""Command line of the port, the reference's workflows on the card:

    python -m scflow_tpu_torch.cli train CONFIG [--work-dir D]
        [--resume | --resume-from N] [--max-iters N] [--num-workers N]
        [--seed S] [--nan-check] [--profile-steps N] [--cfg-options k=v ...]
        [--launcher none|jax|pytorch|slurm|mpi] [--device cpu]
    python -m scflow_tpu_torch.cli test CONFIG --checkpoint CKPT [--eval]
        [--format-only --save-dir DIR] [--out FILE]
        [--launcher none|jax|pytorch|slurm|mpi] [--device cpu]
    python -m scflow_tpu_torch.cli serve CONFIG --checkpoint CKPT
        [--host H] [--port P] [--frame-hw H W] [--max-objects N]
        [--max-frames N] [--max-delay-ms MS] [--pow2-buckets]
        [--keepalive-s S] [--cfg-options k=v ...] [--device cpu]
    python -m scflow_tpu_torch.cli loadtest [--url URL] [--clients N]
        [--requests N] [--objects N] [--frame-hw H W] [--num-class C]
        [--timeout S] [--save-responses FILE.npz]
    python -m scflow_tpu_torch.cli export CONFIG [--checkpoint CKPT]
        --out FILE.scflowx [--batch-size N] [--platforms cuda cpu]
        [--cfg-options k=v ...]
    python -m scflow_tpu_torch.cli overfit [--steps 2000] [--every 200]
        [--lookup-backend xla|pallas] [--save W.pth] [--device cpu]
    python -m scflow_tpu_torch.cli bf16-parity [--root DIR] [--num-images N]
        [--num-class C] [--sym-classes 2,5,8] [--ckpt-levels 1500,4500]
        [--tolerance 1e-3] [--skip-train] [--device cpu]
    python -m scflow_tpu_torch.cli serve-bench [--batch 64] [--img 256]
        [--frame-hw 480 640] [--frames 4] [--iters 8] [--nclass 21]
        [--dtype fp32|bf16] [--render-backend B] [--rounds 20] [--device cpu]
    python -m scflow_tpu_torch.cli warmup CONFIG [--what train,infer,serve]
        [--frame-hw H W] [--max-objects N] [--cfg-options k=v ...] [--device cpu]
    python -m scflow_tpu_torch.cli keypoints MESH_DIR --out FILE.json
        [--mode bbox|obb|fps] [--num 8] [--device cpu]
    python -m scflow_tpu_torch.cli browse CONFIG [--split train|val|test]
        [--num 8] [--out-dir D] [--skip-types T ...] [--device cpu]
    python -m scflow_tpu_torch.cli visualize CONFIG --checkpoint CKPT.pth
        [--num 6] [--out-dir D] [--device cpu]
    python -m scflow_tpu_torch.cli mmflow-convert MMFLOW.pth --config CONFIG
        --out PARAMS.pth [--save-torch DUP.pth] [--strict] [--device cpu]

(tools/train.py, tools/test.py, tools/serve.py, tools/serve_loadtest.py and
tools/export_model.py, whose bodies are scflow_tpu/cli.py's train_main,
test_main, serve_main, the load-test client and export_main; the rest
are tools/overfit_check.py, bf16_parity.py, serve_bench.py,
warmup_cache.py, collect_3d_keypoints.py, browse_dataset.py, visualize.py
and mmflow_ckpt_converter.py, ported in scflow_tpu_torch/tools/).

A launcher other than 'none' (or SCFLOW_DIST=1) runs train and test over
the ranks of a job, e.g. with torchrun:

    torchrun --standalone --nproc_per_node 8 -m scflow_tpu_torch.cli \
        train CONFIG --launcher pytorch

(parallel/dist.py: one card per local rank over NCCL; gloo on the CPU or
when ranks share a card).  Rank 0 writes every file."""

import argparse
import importlib
import json
import logging
import os
import random
import sys
import time

import numpy as np

# parallel.dist.LAUNCHERS, without importing torch here: the loader's spawned
# workers re-import this module when it runs as __main__
LAUNCHERS = ("none", "jax", "pytorch", "slurm", "mpi")
_LAUNCHER_HELP = ("'none' runs one process (unless SCFLOW_DIST=1); 'pytorch' (torchrun), "
                  "'slurm', 'mpi' and 'jax' (SCFLOW_COORDINATOR, SCFLOW_NUM_PROCESSES, "
                  "SCFLOW_PROCESS_ID) join the job launched around this process")


def _quiet_unless_main(logger) -> None:
    """Ranks other than 0 log warnings and errors only."""
    from scflow_tpu_torch.parallel import is_main

    if not is_main():
        logger.setLevel(logging.WARNING)


def parse_train_args(argv=None):
    p = argparse.ArgumentParser(description="Train a pose refiner on the card")
    p.add_argument("config", nargs="?", default=None)
    p.add_argument("--config", dest="config_opt", default=None,
                   help="config path (reference-style alternative to the positional argument)")
    p.add_argument("--local_rank", "--local-rank", type=int, default=0,
                   help="accepted for reference-launcher compatibility")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume-from", default=None, type=int,
                   help="checkpoint step to resume from (default: latest)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in work_dir")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--max-iters", default=None, type=int)
    p.add_argument("--num-workers", default=None, type=int)
    p.add_argument("--nan-check", action="store_true")
    p.add_argument("--launcher", default="none", choices=LAUNCHERS, help=_LAUNCHER_HELP)
    p.add_argument("--profile-steps", default=0, type=int,
                   help="trace N steps (from step 10) with torch.profiler into "
                        "WORK_DIR/profile")
    p.add_argument("--cfg-options", nargs="*", default=[],
                   help="override config entries, key=value")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card); 'cpu' runs the plain versions")
    args = p.parse_args(argv)
    args.config = args.config or args.config_opt
    if not args.config:
        p.error("a config file is required (positional or --config)")
    return args


def seed_pipeline_rngs(seed: int, rank: int) -> None:
    """Seed Python's `random` and numpy's global RNG, which the data
    pipeline's thread workers draw from, with seed + rank: each rank of a
    job draws its own augmentation stream (the reference's workers are
    seeded per rank; process workers seed themselves, datasets/loader.py),
    and rank 0, like a single process, draws what --seed alone gives."""
    random.seed(seed + rank)
    np.random.seed(seed + rank)


def train_main(argv=None, extra_hooks=()):
    """Train the config's refiner on data.train (scflow_tpu/cli.py::
    train_main on one card): seeded initial weights, then init_cfg's
    pretrained file; the optimizer, clip and lr schedule of the config
    (--max-iters sets OneCycle's total_steps to max_iters + 100);
    data.samples_per_gpu samples per step from data.workers_per_gpu
    workers (data.worker_mode 'thread', the default, or 'process'); the
    hooks in JAX's order (text log, profiler, checkpoints, TensorBoard,
    evaluation on data.val with save_best), after `extra_hooks` (a
    caller's instrumentation: they see each step first); --resume /
    --resume-from restore the weights, optimizer state and step from
    work_dir/checkpoints.  Python's `random` and numpy's global RNG, which
    the pipeline draws from, are seeded first (seed_pipeline_rngs: --seed
    plus the rank).  Returns the IterRunner after its run.

    With a launcher (parallel/dist.py) every rank trains on its device: the
    global batch is data.samples_per_gpu x ranks, each rank loads its shard
    of the index stream (process_index = rank), rank 0's weights are
    broadcast, and the step is data-parallel (make_scflow_train_step's
    process_group), so the ranks compute one process's step on the global
    batch.  Rank 0 writes the config dump, the log file, the checkpoints,
    TensorBoard, the profile and eval_history.json; the others wait for its
    checkpoints at barriers.  One process on a host of several cards trains
    on one of them at samples_per_gpu, where JAX's meshes every chip, and
    warns so."""
    args = parse_train_args(argv)
    import torch

    from scflow_tpu_torch.apis import (build_eval_fn, build_loss_assets, build_render_assets,
                                       build_tb_image_fn, init_model_variables,
                                       load_init_weights, make_train_step_from_cfg)
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.datasets import DataLoader
    from scflow_tpu_torch.parallel import (broadcast_module, maybe_initialize_distributed,
                                           rank_world)
    from scflow_tpu_torch.refiners.build import build_refiner_from_config
    from scflow_tpu_torch.registry import build_dataset
    from scflow_tpu_torch.runtime.logger import get_logger, timestamped_log_file
    from scflow_tpu_torch.runtime.optim import build_optimizer
    from scflow_tpu_torch.runtime.runner import (CheckpointHook, EvalHook, IterRunner,
                                                 ProfileHook, TensorboardHook, TextLoggerHook)
    from scflow_tpu_torch.runtime.train_state import TrainState

    dev = maybe_initialize_distributed(args.launcher, args.device)
    rank, world = rank_world()
    seed_pipeline_rngs(args.seed, rank)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(Config.parse_options(args.cfg_options))
    work_dir = args.work_dir or cfg.get("work_dir", "work_dirs/default")
    os.makedirs(work_dir, exist_ok=True)
    if rank == 0:
        cfg.dump(os.path.join(work_dir, "config_dump.py"))
    logger = get_logger(log_file=timestamped_log_file(work_dir) if rank == 0 else None)
    _quiet_unless_main(logger)
    logger.info(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})"
                                    if dev.type == "cuda" else ""))

    image_size = tuple(cfg.model.get("renderer", {}).get("image_size", (256, 256)))
    with torch.random.fork_rng(devices=[]):  # init_model_variables sets every weight
        model = build_refiner_from_config(cfg.model)
    render_assets, bank = build_render_assets(cfg.model, device=dev)
    loss_assets = build_loss_assets(cfg.model, bank.num_class, device=dev)
    init_model_variables(cfg.model, model, seed=args.seed, device=dev)
    load_init_weights(cfg.model, model, logger)
    broadcast_module(model)

    max_iters = args.max_iters or cfg.runner["max_iters"]
    lr_cfg = dict(cfg.get("lr_config", {}))
    if args.max_iters and lr_cfg.get("policy") == "OneCycle":
        lr_cfg["total_steps"] = max_iters + 100
    opt_config = cfg.get("optimizer_config", {})
    tx, schedule = build_optimizer(model, dict(cfg.optimizer), lr_cfg,
                                   opt_config.get("grad_clip", {}).get("max_norm"),
                                   frozen_prefixes=opt_config.get("frozen_prefixes"))
    state = TrainState(model, tx)

    local_batch = cfg.data.get("samples_per_gpu", 16)
    logger.info(f"{world} devices / {world} processes, global batch {local_batch * world} "
                f"(local {local_batch})")
    if world == 1 and dev.type == "cuda" and torch.cuda.device_count() > 1:
        # JAX's train_main meshes every local chip at any launcher, so its
        # global batch is samples_per_gpu x chips, which the lr schedule of
        # the shipped recipes assumes
        logger.warning(f"{torch.cuda.device_count()} cards visible but one process trains on "
                       f"{dev} at global batch {local_batch}; the JAX package would train on "
                       "every card at samples_per_gpu x cards. Start one rank per card: "
                       "torchrun --nproc_per_node <cards> -m scflow_tpu_torch.cli train "
                       "CONFIG --launcher pytorch")
    loader = DataLoader(build_dataset(cfg.data["train"]), samples_per_step=local_batch,
                        num_workers=args.num_workers or cfg.data.get("workers_per_gpu", 8),
                        seed=args.seed, process_index=rank, process_count=world,
                        worker_mode=cfg.data.get("worker_mode", "thread"))
    train_step = make_train_step_from_cfg(
        cfg, model, render_assets, loss_assets, image_size, device=dev,
        process_group=torch.distributed.group.WORLD if world > 1 else None)

    log_cfg = cfg.get("log_config", {})
    hooks = list(extra_hooks) + [TextLoggerHook(log_cfg.get("interval", 50))]
    if args.profile_steps and rank == 0:
        hooks.append(ProfileHook(os.path.join(work_dir, "profile"),
                                 num_steps=args.profile_steps))
    hooks.append(CheckpointHook(cfg.get("checkpoint_config", {}).get("interval", 10000)))
    for hcfg in log_cfg.get("hooks", []) if rank == 0 else ():
        if hcfg.get("type", "").startswith("Tensorboard"):
            hooks.append(TensorboardHook(
                os.path.join(work_dir, "tb"), interval=log_cfg.get("interval", 50),
                image_interval=hcfg.get("interval", 0),
                image_fn=build_tb_image_fn(cfg, model, render_assets, image_size, device=dev)))
    eval_cfg = cfg.get("evaluation")
    if eval_cfg and "val" in cfg.data:
        try:
            val_set = build_dataset(cfg.data["val"])
        except (FileNotFoundError, OSError) as e:
            logger.warning(f"val dataset unavailable ({e}); skipping EvalHook")
        else:
            hooks.append(EvalHook(build_eval_fn(cfg, model, render_assets, val_set, image_size,
                                                device=dev),
                                  interval=eval_cfg.get("interval", 5000),
                                  save_best=eval_cfg.get("save_best"),
                                  rule=eval_cfg.get("rule", "greater")))

    runner = IterRunner(train_step, state, loader, max_iters, work_dir=work_dir, hooks=hooks,
                        lr_schedule=schedule, logger=logger, nan_check=args.nan_check,
                        ckpt_max_keep=cfg.get("checkpoint_config", {}).get("max_keep_ckpts", 5))
    if args.resume or args.resume_from is not None:
        runner.resume(args.resume_from)
    try:
        runner.run()
    finally:
        runner.data_iter.close()  # stops the loader's workers
    return runner


def parse_test_args(argv=None):
    p = argparse.ArgumentParser(description="Test a pose refiner on the card")
    p.add_argument("config", nargs="?", default=None)
    p.add_argument("--config", dest="config_opt", default=None,
                   help="config path (reference-style alternative to the positional argument)")
    p.add_argument("--checkpoint", required=True, help="a .pth/.pt checkpoint")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--format-only", action="store_true")
    p.add_argument("--save-dir", default=None)
    p.add_argument("--out", default=None, help="dump raw results json")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--limit", default=None, type=int,
                   help="evaluate only the first N images (smoke runs)")
    p.add_argument("--gpu-collect", action="store_true",
                   help="accepted for reference compatibility")
    p.add_argument("--local_rank", "--local-rank", type=int, default=0,
                   help="accepted for reference-launcher compatibility")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--eval-options", nargs="*", default=[])
    p.add_argument("--launcher", default="none", choices=LAUNCHERS, help=_LAUNCHER_HELP)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card); 'cpu' runs the plain versions")
    args = p.parse_args(argv)
    args.config = args.config or args.config_opt
    if not args.config:
        p.error("a config file is required (positional or --config)")
    if args.format_only and not args.save_dir:
        p.error("--format-only requires --save-dir")
    return args


def test_main(argv=None):
    """Refine the config's data.test set with the checkpoint's weights and,
    as asked, write the raw results (--out), the BOP export (--format-only,
    under --save-dir) and the metrics (--eval: printed, and dumped to
    work_dir/eval_*.json).  Returns {'results', 'metrics' (or None),
    'seconds', 'stats' (the eval loop's seconds per stage)}.  With a launcher
    each rank refines its shard of the images (every process_count-th one)
    and every rank gets all the results in the dataset's order
    (eval_loop.multi_process_test); rank 0 alone writes --out, the BOP
    export and the metrics file."""
    args = parse_test_args(argv)
    import torch

    from scflow_tpu_torch.apis import (build_render_assets, load_eval_checkpoint,
                                       make_infer_from_cfg)
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.parallel import is_main, maybe_initialize_distributed
    from scflow_tpu_torch.refiners.build import build_refiner_from_config
    from scflow_tpu_torch.registry import build_dataset
    from scflow_tpu_torch.runtime.eval_loop import multi_process_test
    from scflow_tpu_torch.runtime.logger import get_logger

    dev = maybe_initialize_distributed(args.launcher, args.device)
    main = is_main()
    logger = get_logger()
    _quiet_unless_main(logger)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(Config.parse_options(args.cfg_options))
    np.random.seed(args.seed)

    image_size = tuple(cfg.model.get("renderer", {}).get("image_size", (256, 256)))
    with torch.random.fork_rng(devices=[]):  # the weights all come from the file
        model = build_refiner_from_config(cfg.model)
    model.to(dev)
    render_assets, _ = build_render_assets(cfg.model, device=dev)
    load_eval_checkpoint(args.checkpoint, model, logger)

    dataset = build_dataset(cfg.data["test"])
    if args.limit:
        dataset.img_files = dataset.img_files[: args.limit]

    infer, pose_from_output = make_infer_from_cfg(cfg, model, render_assets, image_size,
                                                  slim=True, device=dev)
    test_cfg = cfg.model.get("test_cfg", {})
    stats = {}
    t0 = time.perf_counter()
    results = multi_process_test(infer, dataset, pose_from_output=pose_from_output,
                                 logger=logger, max_bucket=test_cfg.get("max_bucket", 64),
                                 fixed_bucket=test_cfg.get("fixed_bucket", False), stats=stats)
    total = time.perf_counter() - t0
    logger.info(f"{len(results)} images in {total:.1f}s "
                f"({total / max(len(results), 1) * 1e3:.1f} ms/img)")

    if args.out and main:
        serializable = [dict(pred={k: np.asarray(v).tolist() for k, v in r["pred"].items()},
                             img_metas=r["img_metas"]) for r in results]
        with open(args.out, "w") as f:
            json.dump(serializable, f)
        logger.info(f"wrote raw results to {args.out}")

    if args.format_only and main:
        dataset.format_results(results, args.save_dir, time=total / max(len(results), 1))
        logger.info(f"BOP-format results saved to {args.save_dir}")
    metrics = None
    if args.eval:
        metric = cfg.get("evaluation", {}).get(
            "metric", {"add": [0.05, 0.10, 0.20, 0.50], "rep": [2, 5, 10, 20]})
        if args.eval_options:
            metric = Config.parse_options(args.eval_options)
        metrics = dataset.evaluate(results, metric=metric)
    if metrics is not None and main:
        ts = time.strftime("%Y%m%d_%H%M%S")
        out_json = os.path.join(cfg.get("work_dir", "work_dirs/default"), f"eval_{ts}.json")
        os.makedirs(os.path.dirname(out_json), exist_ok=True)
        with open(out_json, "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f, indent=1)
        logger.info(f"eval metrics dumped to {out_json}")
    return dict(results=results, metrics=metrics, seconds=total, stats=stats)


def parse_serve_args(argv=None):
    p = argparse.ArgumentParser(
        description="Online pose-refinement server on the card (HTTP + micro-batching)")
    p.add_argument("config")
    p.add_argument("--checkpoint", required=True, help="a .pth/.pt checkpoint")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", default=8080, type=int,
                   help="0 binds a free port, which the log names")
    p.add_argument("--frame-hw", type=int, nargs=2, default=[480, 640],
                   help="camera frame size the server accepts")
    p.add_argument("--max-objects", default=64, type=int, help="device batch budget")
    p.add_argument("--max-frames", default=8, type=int,
                   help="max requests coalesced into one batch")
    p.add_argument("--max-delay-ms", default=5.0, type=float,
                   help="batching window opened by the first queued request")
    p.add_argument("--pow2-buckets", action="store_true",
                   help="pad to shared pow2 buckets instead of one fixed batch")
    p.add_argument("--keepalive-s", default=0.0, type=float,
                   help="keep-alive tick interval (the serve fn on 1 synthetic object); "
                        "0 = off, the default")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card); 'cpu' runs the plain versions")
    return p.parse_args(argv)


def serve_main(argv=None):
    """Serve the config's refiner with the checkpoint's weights over HTTP
    (scflow_tpu/cli.py::serve_main): PoseService over
    apis.make_serving_from_cfg, data-parallel over every visible card when
    there is more than one (and no --device), with one replica of the model
    and serve fn per card; warmed up at its batch shape, behind a
    two-stage MicroBatcher (dispatch, then fetch on a second thread) and
    make_http_server; an optional keep-alive tick.  Logs "serving on
    http://HOST:PORT" with the bound port (so --port 0 can be found).
    SIGTERM drains like Ctrl-C: the HTTP loop stops, the batcher finishes
    its queued batches, and the call returns."""
    args = parse_serve_args(argv)
    import signal

    import torch

    from scflow_tpu_torch.apis import (build_render_assets, load_eval_checkpoint,
                                       make_serving_from_cfg)
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.device import resolve_device
    from scflow_tpu_torch.parallel import make_mesh, replicate
    from scflow_tpu_torch.refiners.build import build_refiner_from_config
    from scflow_tpu_torch.runtime.logger import get_logger
    from scflow_tpu_torch.runtime.server import (DeviceKeepAlive, MicroBatcher, PoseService,
                                                 make_http_server, make_service_keepalive_tick)

    logger = get_logger()
    dev = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(Config.parse_options(args.cfg_options))
    mesh = None
    if dev.type == "cuda":
        logger.info(f"device: {dev} ({torch.cuda.get_device_name(dev)})")
        if args.device is None and torch.cuda.device_count() > 1:
            mesh = make_mesh()
            logger.info(f"serving data-parallel over {mesh.size} devices")
    with torch.random.fork_rng(devices=[]):  # the weights all come from the file
        model = build_refiner_from_config(cfg.model)
    model.to(dev)
    load_eval_checkpoint(args.checkpoint, model, logger)
    serve_fns = []
    for replica in ([model] if mesh is None else replicate(model, mesh)):
        rdev = next(replica.parameters()).device
        render_assets, bank = build_render_assets(cfg.model, device=rdev)
        serve_fn, fetch_keys, post_fn = make_serving_from_cfg(cfg, replica, render_assets,
                                                              device=rdev)
        serve_fns.append(serve_fn)
    service = PoseService(serve_fns[0] if mesh is None else serve_fns,
                          frame_hw=tuple(args.frame_hw), num_class=bank.num_class,
                          max_frames=args.max_frames, max_objects=args.max_objects,
                          fixed_bucket=not args.pow2_buckets, mesh=mesh, fetch_keys=fetch_keys,
                          post_fn=post_fn, device=dev)
    logger.info("warming up (the serve fn at its batch shape)...")
    t0 = time.perf_counter()
    service.warmup()
    logger.info(f"warmup done in {time.perf_counter() - t0:.1f}s")

    batcher = MicroBatcher(service.dispatch, fetch_batch=service.fetch,
                           max_frames=args.max_frames, max_objects=args.max_objects,
                           max_delay_ms=args.max_delay_ms)
    keepalive = None
    if args.keepalive_s > 0:
        keepalive = DeviceKeepAlive(make_service_keepalive_tick(service),
                                    interval_s=args.keepalive_s)
    httpd = make_http_server(service, batcher, args.host, args.port)
    logger.info(f"serving on http://{args.host}:{httpd.server_address[1]} "
                "(POST /v1/refine, GET /healthz, GET /v1/stats)")

    def _term(signum, frame):  # systemd and k8s send SIGTERM on a rollout
        raise KeyboardInterrupt

    previous = signal.signal(signal.SIGTERM, _term)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down (draining in-flight batches)")
    finally:
        signal.signal(signal.SIGTERM, previous)
        httpd.shutdown()
        httpd.server_close()
        batcher.stop()
        if keepalive is not None:
            keepalive.stop()
    logger.info(f"stopped; stats {json.dumps(batcher.stats.snapshot())}")
    return batcher.stats.snapshot()


def parse_loadtest_args(argv=None):
    p = argparse.ArgumentParser(description="Concurrent load test of the serving server")
    p.add_argument("--url", default="http://127.0.0.1:8080")
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--requests", type=int, default=50, help="requests per client")
    p.add_argument("--objects", type=int, default=4, help="objects per request")
    p.add_argument("--frame-hw", type=int, nargs=2, default=[480, 640])
    p.add_argument("--num-class", type=int, default=21)
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--save-responses", default=None,
                   help="write the request and every answered response to this .npz")
    return p.parse_args(argv)


def loadtest_request(frame_hw, objects: int, num_class: int):
    """The load test's one request (tools/serve_loadtest.py's): a noise
    frame, random rotations, translations around 700-1100 mm, the LINEMOD
    focal lengths, random labels; seeded, so a checker can rebuild it."""
    from scipy.spatial.transform import Rotation

    h, w = frame_hw
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
    R = Rotation.random(objects, 0).as_matrix().astype(np.float32)
    t = np.stack([rng.normal(size=objects) * 50, rng.normal(size=objects) * 30,
                  rng.uniform(700, 1100, objects)], -1).astype(np.float32)
    K = np.array([[572.4, 0, w / 2], [0, 573.5, h / 2], [0, 0, 1]], np.float32)
    labels = rng.integers(0, num_class, objects).astype(np.int32)
    return dict(frame=frame, rotations=R, translations=t, k=K, labels=labels)


def loadtest_main(argv=None):
    """Drive POST /v1/refine with --clients threads of --requests requests
    each and print the achieved request and object rates, the client-side
    latency percentiles (nearest rank) and the server's /v1/stats.
    Returns the report."""
    args = parse_loadtest_args(argv)
    import threading
    from urllib.request import urlopen

    from scflow_tpu_torch.runtime.server import nearest_rank, refine_remote

    req = loadtest_request(args.frame_hw, args.objects, args.num_class)
    lat, errs, answers = [], [], []
    lock = threading.Lock()

    def client():
        for _ in range(args.requests):
            t0 = time.perf_counter()
            try:
                res = refine_remote(args.url, req["frame"], req["rotations"],
                                    req["translations"], req["k"], req["labels"],
                                    timeout=args.timeout)
                dt = time.perf_counter() - t0
                with lock:
                    lat.append(dt)
                    answers.append(res)
            except Exception as e:
                with lock:
                    errs.append(str(e))

    threads = [threading.Thread(target=client) for _ in range(args.clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    lat.sort()

    def q(p):
        v = nearest_rank(lat, p)
        return None if v is None else round(v * 1e3, 1)

    n_ok = len(lat)
    report = {"requests_ok": n_ok, "requests_failed": len(errs), "wall_s": round(wall, 2),
              "requests_per_s": round(n_ok / wall, 2) if wall else None,
              "objects_per_s": round(n_ok * args.objects / wall, 2) if wall else None,
              "latency_ms": {"p50": q(0.50), "p90": q(0.90), "p95": q(0.95),
                             "p99": q(0.99)}}
    print(json.dumps(report), flush=True)
    if errs:
        print("first error:", errs[0], flush=True)
    try:
        stats = urlopen(args.url.rstrip("/") + "/v1/stats", timeout=10).read().decode()
        report["server_stats"] = json.loads(stats)
        print("server stats:", stats, flush=True)
    except Exception as e:
        print(f"(stats endpoint unavailable: {e})", flush=True)
    if args.save_responses:
        p = args.objects
        np.savez(args.save_responses, **{f"request_{k}": v for k, v in req.items()},
                 rotations=np.reshape([a["rotations"] for a in answers], (-1, p, 3, 3)),
                 translations=np.reshape([a["translations"] for a in answers], (-1, p, 3)))
    return report


def parse_export_args(argv=None):
    p = argparse.ArgumentParser(
        description="Export the inference graph (weights baked in) as torch.export "
                    "programs in one artifact")
    p.add_argument("config")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint to bake in (omit = init weights, "
                        "useful only for plumbing tests)")
    p.add_argument("--out", required=True, help="artifact path (.scflowx)")
    p.add_argument("--batch-size", default=16, type=int,
                   help="static object-batch size baked into the graph")
    p.add_argument("--platforms", nargs="+", default=None, choices=("cuda", "cpu"),
                   help="one program per platform, each traced on its device "
                        "(default: the card), e.g. --platforms cuda cpu")
    p.add_argument("--cfg-options", nargs="*", default=[])
    return p.parse_args(argv)


def export_main(argv=None):
    """Export the config's inference call with the checkpoint's weights
    (scflow_tpu/cli.py::export_main): for each platform, the model and the
    render assets built on its device, and the infer fn
    apis.make_infer_from_cfg gives (SCFlow, cycled SCFlow, bf16, RAFT with
    either PnP backend), traced by runtime/export.py.  Returns the
    artifact's meta."""
    args = parse_export_args(argv)
    import torch

    from scflow_tpu_torch.apis import (build_render_assets, init_model_variables,
                                       load_eval_checkpoint, make_infer_from_cfg)
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.refiners.build import build_refiner_from_config
    from scflow_tpu_torch.runtime.export import batch_spec, export_infer, read_meta
    from scflow_tpu_torch.runtime.logger import get_logger

    logger = get_logger()
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(Config.parse_options(args.cfg_options))
    image_size = tuple(cfg.model.get("renderer", {}).get("image_size", (256, 256)))
    if not args.checkpoint:
        logger.warning("no --checkpoint: exporting INIT weights")

    def make_infer(device):
        with torch.random.fork_rng(devices=[]):
            model = build_refiner_from_config(cfg.model)
        render_assets, _ = build_render_assets(cfg.model, device=device)
        if args.checkpoint:
            load_eval_checkpoint(args.checkpoint, model.to(render_assets.verts.device), logger)
        else:
            init_model_variables(cfg.model, model, device=device)
        infer, pose_from_output = make_infer_from_cfg(cfg, model, render_assets, image_size,
                                                      slim=True, device=device)
        if pose_from_output is not None:
            logger.warning(
                "this config solves poses with host-side PnP; the artifact "
                "outputs flow/occlusion — run PnP outside, or set "
                "test_cfg.pnp_backend=device for a pose-emitting artifact")
        return infer

    data = export_infer(
        make_infer, batch_spec(args.batch_size, image_size), platforms=args.platforms,
        meta={"config": os.path.basename(args.config), "checkpoint": args.checkpoint or "",
              "model_type": cfg.model["type"], "image_size": list(image_size),
              "batch_size": args.batch_size})
    with open(args.out, "wb") as f:
        f.write(data)
    meta = read_meta(data)
    logger.info(f"wrote {args.out} ({len(data) / 1e6:.1f} MB, "
                f"platforms={meta['platforms']}, outputs={meta['outputs']})")
    return meta


def _tool(module: str):
    """The main of scflow_tpu_torch/tools/<module>.py, imported at the call
    (this module imports no torch: spawned loader workers re-import it)."""

    def main(argv=None):
        return importlib.import_module(f"scflow_tpu_torch.tools.{module}").main(argv)

    return main


COMMANDS = {"train": train_main, "test": test_main, "serve": serve_main,
            "loadtest": loadtest_main, "export": export_main, "overfit": _tool("overfit_check"),
            "bf16-parity": _tool("bf16_parity"), "serve-bench": _tool("serve_bench"),
            "warmup": _tool("warmup_cache"), "keypoints": _tool("collect_3d_keypoints"),
            "browse": _tool("browse_dataset"), "visualize": _tool("visualize"),
            "mmflow-convert": _tool("mmflow_ckpt_converter")}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit(f"usage: python -m scflow_tpu_torch.cli {{{','.join(COMMANDS)}}} ...")
    COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
