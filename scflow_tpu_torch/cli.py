"""Command line of the port, the reference's workflows on the card:

    python -m scflow_tpu_torch.cli train CONFIG [--work-dir D]
        [--resume | --resume-from N] [--max-iters N] [--num-workers N]
        [--seed S] [--nan-check] [--profile-steps N] [--cfg-options k=v ...]
        [--device cpu]
    python -m scflow_tpu_torch.cli test CONFIG --checkpoint CKPT [--eval]
        [--format-only --save-dir DIR] [--out FILE] [--device cpu]

(tools/train.py and tools/test.py, whose bodies are scflow_tpu/cli.py's
train_main and test_main).  The serve and export commands of the JAX
package are not ported yet."""

import argparse
import json
import os
import sys
import time

import numpy as np

_NOT_PORTED = {"serve": "ROADMAP §1 item 9 (serving)",
               "export": "ROADMAP §1 item 9 (torch.export)"}


def _check_launcher(launcher: str) -> None:
    if launcher != "none":
        raise NotImplementedError(f"launcher {launcher!r}: multi-process runs are not "
                                  "ported (ROADMAP §1 item 9); use --launcher none")


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
    p.add_argument("--launcher", default="none",
                   help="only 'none': multi-process runs are not ported (ROADMAP §1 item 9)")
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
    _check_launcher(args.launcher)
    return args


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
    the pipeline draws from, are seeded with --seed first.  Returns the
    IterRunner after its run."""
    args = parse_train_args(argv)
    import random

    import torch

    from scflow_tpu_torch.apis import (build_eval_fn, build_loss_assets, build_render_assets,
                                       build_tb_image_fn, init_model_variables,
                                       load_init_weights, make_train_step_from_cfg)
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.datasets import DataLoader
    from scflow_tpu_torch.device import resolve_device
    from scflow_tpu_torch.refiners.build import build_refiner_from_config
    from scflow_tpu_torch.registry import build_dataset
    from scflow_tpu_torch.runtime.logger import get_logger, timestamped_log_file
    from scflow_tpu_torch.runtime.optim import build_optimizer
    from scflow_tpu_torch.runtime.runner import (CheckpointHook, EvalHook, IterRunner,
                                                 ProfileHook, TensorboardHook, TextLoggerHook)
    from scflow_tpu_torch.runtime.train_state import TrainState

    random.seed(args.seed)
    np.random.seed(args.seed)
    dev = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(Config.parse_options(args.cfg_options))
    work_dir = args.work_dir or cfg.get("work_dir", "work_dirs/default")
    os.makedirs(work_dir, exist_ok=True)
    cfg.dump(os.path.join(work_dir, "config_dump.py"))
    logger = get_logger(log_file=timestamped_log_file(work_dir))
    logger.info(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})"
                                    if dev.type == "cuda" else ""))

    image_size = tuple(cfg.model.get("renderer", {}).get("image_size", (256, 256)))
    with torch.random.fork_rng(devices=[]):  # init_model_variables sets every weight
        model = build_refiner_from_config(cfg.model)
    render_assets, bank = build_render_assets(cfg.model, device=dev)
    loss_assets = build_loss_assets(cfg.model, bank.num_class, device=dev)
    init_model_variables(cfg.model, model, seed=args.seed, device=dev)
    load_init_weights(cfg.model, model, logger)

    max_iters = args.max_iters or cfg.runner["max_iters"]
    lr_cfg = dict(cfg.get("lr_config", {}))
    if args.max_iters and lr_cfg.get("policy") == "OneCycle":
        lr_cfg["total_steps"] = max_iters + 100
    opt_config = cfg.get("optimizer_config", {})
    tx, schedule = build_optimizer(model, dict(cfg.optimizer), lr_cfg,
                                   opt_config.get("grad_clip", {}).get("max_norm"),
                                   frozen_prefixes=opt_config.get("frozen_prefixes"))
    state = TrainState(model, tx)

    batch = cfg.data.get("samples_per_gpu", 16)
    logger.info(f"1 device / 1 process, batch {batch}")
    loader = DataLoader(build_dataset(cfg.data["train"]), samples_per_step=batch,
                        num_workers=args.num_workers or cfg.data.get("workers_per_gpu", 8),
                        seed=args.seed, worker_mode=cfg.data.get("worker_mode", "thread"))
    train_step = make_train_step_from_cfg(cfg, model, render_assets, loss_assets, image_size,
                                          device=dev)

    log_cfg = cfg.get("log_config", {})
    hooks = list(extra_hooks) + [TextLoggerHook(log_cfg.get("interval", 50))]
    if args.profile_steps:
        hooks.append(ProfileHook(os.path.join(work_dir, "profile"),
                                 num_steps=args.profile_steps))
    hooks.append(CheckpointHook(cfg.get("checkpoint_config", {}).get("interval", 10000)))
    for hcfg in log_cfg.get("hooks", []):
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
    p.add_argument("--launcher", default="none",
                   help="only 'none': multi-process runs are not ported (ROADMAP §1 item 9)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card); 'cpu' runs the plain versions")
    args = p.parse_args(argv)
    args.config = args.config or args.config_opt
    if not args.config:
        p.error("a config file is required (positional or --config)")
    _check_launcher(args.launcher)
    if args.format_only and not args.save_dir:
        p.error("--format-only requires --save-dir")
    return args


def test_main(argv=None):
    """Refine the config's data.test set with the checkpoint's weights and,
    as asked, write the raw results (--out), the BOP export (--format-only,
    under --save-dir) and the metrics (--eval: printed, and dumped to
    work_dir/eval_*.json).  Returns {'results', 'metrics' (or None),
    'seconds', 'stats' (the eval loop's seconds per stage)}."""
    args = parse_test_args(argv)
    import torch

    from scflow_tpu_torch.apis import (build_render_assets, load_eval_checkpoint,
                                       make_infer_from_cfg)
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.device import resolve_device
    from scflow_tpu_torch.refiners.build import build_refiner_from_config
    from scflow_tpu_torch.registry import build_dataset
    from scflow_tpu_torch.runtime.eval_loop import multi_process_test
    from scflow_tpu_torch.runtime.logger import get_logger

    logger = get_logger()
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(Config.parse_options(args.cfg_options))
    np.random.seed(args.seed)

    image_size = tuple(cfg.model.get("renderer", {}).get("image_size", (256, 256)))
    with torch.random.fork_rng(devices=[]):  # the weights all come from the file
        model = build_refiner_from_config(cfg.model)
    model.to(resolve_device(args.device))
    render_assets, _ = build_render_assets(cfg.model, device=args.device)
    load_eval_checkpoint(args.checkpoint, model, logger)

    dataset = build_dataset(cfg.data["test"])
    if args.limit:
        dataset.img_files = dataset.img_files[: args.limit]

    infer, pose_from_output = make_infer_from_cfg(cfg, model, render_assets, image_size,
                                                  slim=True, device=args.device)
    test_cfg = cfg.model.get("test_cfg", {})
    stats = {}
    t0 = time.perf_counter()
    results = multi_process_test(infer, dataset, pose_from_output=pose_from_output,
                                 logger=logger, max_bucket=test_cfg.get("max_bucket", 64),
                                 fixed_bucket=test_cfg.get("fixed_bucket", False), stats=stats)
    total = time.perf_counter() - t0
    logger.info(f"{len(results)} images in {total:.1f}s "
                f"({total / max(len(results), 1) * 1e3:.1f} ms/img)")

    if args.out:
        serializable = [dict(pred={k: np.asarray(v).tolist() for k, v in r["pred"].items()},
                             img_metas=r["img_metas"]) for r in results]
        with open(args.out, "w") as f:
            json.dump(serializable, f)
        logger.info(f"wrote raw results to {args.out}")

    if args.format_only:
        dataset.format_results(results, args.save_dir, time=total / max(len(results), 1))
        logger.info(f"BOP-format results saved to {args.save_dir}")
    metrics = None
    if args.eval:
        metric = cfg.get("evaluation", {}).get(
            "metric", {"add": [0.05, 0.10, 0.20, 0.50], "rep": [2, 5, 10, 20]})
        if args.eval_options:
            metric = Config.parse_options(args.eval_options)
        metrics = dataset.evaluate(results, metric=metric)
        ts = time.strftime("%Y%m%d_%H%M%S")
        out_json = os.path.join(cfg.get("work_dir", "work_dirs/default"), f"eval_{ts}.json")
        os.makedirs(os.path.dirname(out_json), exist_ok=True)
        with open(out_json, "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f, indent=1)
        logger.info(f"eval metrics dumped to {out_json}")
    return dict(results=results, metrics=metrics, seconds=total, stats=stats)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    commands = ["train", "test", *_NOT_PORTED]
    if not argv or argv[0] not in commands:
        raise SystemExit(f"usage: python -m scflow_tpu_torch.cli {{{','.join(commands)}}} ...")
    if argv[0] in _NOT_PORTED:
        raise NotImplementedError(f"'{argv[0]}' is not ported: {_NOT_PORTED[argv[0]]}")
    {"train": train_main, "test": test_main}[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
