"""Command line of the port: `python -m scflow_tpu_torch.cli test CONFIG
--checkpoint CKPT [--eval] [--format-only --save-dir DIR] [--out FILE]
[--device cpu]`, the reference's test workflow (tools/test.py, whose body
is scflow_tpu/cli.py::test_main) on the card.  The train, serve and export
commands of the JAX package are not ported yet."""

import argparse
import json
import os
import sys
import time

import numpy as np

_NOT_PORTED = {"train": "ROADMAP §1 item 7b (the train workflow)",
               "serve": "ROADMAP §1 item 9 (serving)",
               "export": "ROADMAP §1 item 9 (torch.export)"}


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
    if args.launcher != "none":
        raise NotImplementedError(f"launcher {args.launcher!r}: multi-process runs are not "
                                  "ported (ROADMAP §1 item 9); use --launcher none")
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
    commands = ["test", *_NOT_PORTED]
    if not argv or argv[0] not in commands:
        raise SystemExit(f"usage: python -m scflow_tpu_torch.cli {{{','.join(commands)}}} ...")
    if argv[0] in _NOT_PORTED:
        raise NotImplementedError(f"'{argv[0]}' is not ported: {_NOT_PORTED[argv[0]]}")
    test_main(argv[1:])


if __name__ == "__main__":
    main()
