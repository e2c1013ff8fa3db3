"""Iteration-based training with hooks: the port's copy of
scflow_tpu/runtime/runner.py (mmcv's IterBasedRunner and hook stack,
reference train.py:152-213).

The runner owns the train step, the data iterator, the hooks (logging,
profiling, checkpoints, evaluation with the best model kept, TensorBoard)
and resume.  The step's logs stay on the device: no hook fetches them every
step (TextLoggerHook fetches its window once per interval), so the host
loads and launches the next step while the card computes this one."""

import json
import os
import time
import warnings
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from scflow_tpu_torch.runtime.checkpoint import CheckpointManager
from scflow_tpu_torch.runtime.logger import get_logger


class Hook:
    def before_run(self, runner):
        pass

    def before_train_iter(self, runner):
        """After the batch is loaded and on the device, before the step."""

    def after_train_iter(self, runner):
        pass

    def after_run(self, runner):
        pass


def fetch_logs(logs: List[Dict[str, torch.Tensor]]) -> List[Dict[str, float]]:
    """Log dicts of 0-d tensors as floats, in one device-to-host copy."""
    keys = [list(d) for d in logs]
    flat = [torch.as_tensor(d[k]).float().reshape(()) for d, ks in zip(logs, keys) for k in ks]
    if not flat:
        return [{} for _ in logs]
    values = iter(torch.stack([v.to(flat[0].device) for v in flat]).cpu().tolist())
    return [{k: next(values) for k in ks} for ks in keys]


class TextLoggerHook(Hook):
    """Every `interval` steps: the lr, the steps per second since the last
    line and each log's mean over the last `smooth_window` steps (the
    seq_* entries left out), from one fetch of the window."""

    def __init__(self, interval: int = 50, smooth_window: int = 50):
        self.interval = interval
        self._hist: deque = deque(maxlen=smooth_window)
        self._t0 = None
        self._last_step = 0

    def before_run(self, runner):
        self._t0 = time.perf_counter()
        self._last_step = int(runner.step)

    def after_train_iter(self, runner):
        self._hist.append(runner.last_log)
        if runner.step % self.interval != 0:
            return
        dt = time.perf_counter() - self._t0
        steps = runner.step - self._last_step
        ips = steps / dt if dt > 0 else 0.0
        host = fetch_logs(list(self._hist))
        self._t0 = time.perf_counter()
        self._last_step = runner.step
        keys = sorted({k for d in host for k in d})
        msg = ", ".join(f"{k}: {np.mean([d[k] for d in host if k in d]):.4f}"
                        for k in keys if not k.startswith("seq_"))
        runner.logger.info(f"Iter [{runner.step}/{runner.max_iters}] "
                           f"lr: {runner.current_lr():.3e}, {ips:.2f} it/s, {msg}")


class ProfileHook(Hook):
    """A torch.profiler trace (CPU and, on a card, CUDA activity) of the
    steps numbered [start, start + num_steps) (step n is the one after
    which runner.step == n), written to log_dir as a Chrome trace.  The JAX
    package's hook reads runner.iter, which its IterRunner does not have,
    so there it raises after the first step; this one reads runner.step."""

    def __init__(self, log_dir: str, start: int = 10, num_steps: int = 5):
        self.log_dir = log_dir
        self.start = start
        self.stop = start + num_steps
        self.trace_path = None
        self._prof = None

    def _begin(self, runner):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if runner.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.start()
        runner.logger.info(f"profiler: tracing -> {self.log_dir}")

    def _end(self, runner):
        if runner.device.type == "cuda":
            torch.cuda.synchronize(runner.device)
        self._prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        self.trace_path = os.path.join(self.log_dir, f"trace_steps_{self.start}_{self.stop - 1}.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        runner.logger.info(f"profiler: trace captured ({self.trace_path})")

    def before_run(self, runner):
        if runner.step + 1 == self.start:
            self._begin(runner)

    def after_train_iter(self, runner):
        if runner.step + 1 == self.start and self._prof is None:
            self._begin(runner)
        elif runner.step + 1 == self.stop and self._prof is not None:
            self._end(runner)

    def after_run(self, runner):
        if self._prof is not None:
            self._end(runner)


class CheckpointHook(Hook):
    """A checkpoint every `interval` steps and one at the end of the run."""

    def __init__(self, interval: int = 10000):
        self.interval = interval

    def after_train_iter(self, runner):
        if runner.step % self.interval == 0:
            runner.ckpt_manager.save(runner.step, runner.state)
            runner.logger.info(f"Saved checkpoint at iter {runner.step}")

    def after_run(self, runner):
        runner.ckpt_manager.save(runner.step, runner.state)


class EvalHook(Hook):
    """Every `interval` steps: eval_fn(state) -> metrics, logged (the first
    12 by name), appended to runner.eval_history and written in full to
    work_dir/eval_history.json, sent to TensorBoard, and with save_best the
    weights kept as the best by that metric under `rule` ('greater' or
    'less')."""

    def __init__(self, eval_fn: Callable[[Any], Dict[str, float]], interval: int = 5000,
                 save_best: Optional[str] = None, rule: str = "greater"):
        self.eval_fn = eval_fn
        self.interval = interval
        self.save_best = save_best
        self.rule = rule

    def after_train_iter(self, runner):
        if runner.step % self.interval != 0:
            return
        metrics = self.eval_fn(runner.state)
        msg = ", ".join(f"{k}: {v:.4f}" for k, v in sorted(metrics.items())[:12])
        runner.logger.info(f"Eval at iter {runner.step}: {msg}")
        runner.eval_history.append((runner.step, metrics))
        with open(os.path.join(runner.work_dir, "eval_history.json"), "w") as f:
            json.dump([{"step": s, "metrics": m} for s, m in runner.eval_history], f, indent=1)
        for hook in runner.hooks:
            if isinstance(hook, TensorboardHook) and hook.writer is not None:
                for k, v in metrics.items():
                    hook.writer.add_scalar(f"val/{k}", float(v), runner.step)
        if self.save_best:
            val = metrics.get(self.save_best)
            if val is not None and runner.ckpt_manager.maybe_save_best(
                    runner.step, runner.state, self.save_best, float(val), self.rule):
                runner.logger.info(f"New best {self.save_best}={val:.4f} at iter {runner.step}")


class TensorboardHook(Hook):
    """Scalars every `interval` steps (the logs and the lr) and, every
    `image_interval` steps, the panels of image_fn(runner) (reference
    TensorboardImgLoggerHook, models/utils/tensorboard_hook.py:10-60).
    Without tensorboardX or torch.utils.tensorboard it warns and writes
    nothing, as the JAX package's hook does."""

    def __init__(self, log_dir: str, interval: int = 50, image_interval: int = 0,
                 image_fn: Optional[Callable] = None):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
        if SummaryWriter is None:
            warnings.warn("neither tensorboardX nor torch.utils.tensorboard imports; "
                          "TensorboardHook disabled")
            self.writer = None
        else:
            self.writer = SummaryWriter(log_dir)
        self.interval = interval
        self.image_interval = image_interval
        self.image_fn = image_fn

    def after_train_iter(self, runner):
        if self.writer is None:
            return
        if runner.step % self.interval == 0:
            for k, v in fetch_logs([runner.last_log])[0].items():
                self.writer.add_scalar(f"train/{k}", v, runner.step)
            self.writer.add_scalar("train/lr", runner.current_lr(), runner.step)
        if self.image_interval and self.image_fn is not None \
                and runner.step % self.image_interval == 0:
            for name, img in self.image_fn(runner).items():
                self.writer.add_image(name, img, runner.step, dataformats="HWC")

    def after_run(self, runner):
        if self.writer is not None:
            self.writer.close()


_HOST_KEYS = ("img_metas", "per_img_patch_num")


class IterRunner:
    """Runs train_step(state, batch) -> (state, logs) from state.step to
    max_iters on batches from data_iter, calling the hooks in order.
    state: a train_state.TrainState whose model sits on the device the
    batches go to.  Checkpoints go to work_dir/checkpoints (keeping
    ckpt_max_keep).  With nan_check a non-finite loss raises
    FloatingPointError (a fetch each step).  stats holds the seconds spent
    in next(data_iter) ('load'), put_batch ('put') and launching the step
    ('step', host clock; the card runs behind it)."""

    def __init__(self, train_step: Callable, state, data_iter: Iterable, max_iters: int,
                 work_dir: str = "work_dirs/default", hooks: Optional[List[Hook]] = None,
                 lr_schedule: Optional[Callable] = None, logger=None,
                 ckpt_max_keep: int = 5, nan_check: bool = False):
        self.train_step = train_step
        self.state = state
        self.data_iter = iter(data_iter)
        self.max_iters = max_iters
        self.work_dir = work_dir
        self.hooks = hooks or []
        self.lr_schedule = lr_schedule
        self.logger = logger or get_logger()
        self.device = next(state.model.parameters()).device
        self.step = int(state.step)
        self.last_log: Dict[str, torch.Tensor] = {}
        self.last_batch = None
        self.last_host_extras = None
        self.eval_history: List = []
        self.nan_check = nan_check
        self.stats = {"load": 0.0, "put": 0.0, "step": 0.0}
        os.makedirs(work_dir, exist_ok=True)
        self.ckpt_manager = CheckpointManager(work_dir, max_to_keep=ckpt_max_keep)

    def current_lr(self) -> float:
        if self.lr_schedule is None:
            return 0.0
        if callable(self.lr_schedule):
            return float(self.lr_schedule(self.step))
        return float(self.lr_schedule)

    def resume(self, step: Optional[int] = None) -> int:
        """Restore the weights, optimizer state and step count of the
        checkpoint at `step` (default: the latest); returns the step."""
        self.state, restored = self.ckpt_manager.restore(self.state, step)
        self.step = int(self.state.step)
        if restored:
            self.logger.info(f"Resumed from iter {self.step}")
        return self.step

    def put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The batch's arrays as tensors on the model's device: on a card
        through pinned host memory with non-blocking copies, so the copy
        queues behind the running step instead of waiting for it."""
        if self.device.type != "cuda":
            return {k: torch.as_tensor(v) for k, v in batch.items()}
        return {k: torch.as_tensor(v).pin_memory().to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def run(self):
        for h in self.hooks:
            h.before_run(self)
        self.logger.info(f"Start training: iter {self.step} -> {self.max_iters}, "
                         f"work_dir={self.work_dir}")
        while self.step < self.max_iters:
            t0 = time.perf_counter()
            batch = next(self.data_iter)
            t1 = time.perf_counter()
            self.last_host_extras = {k: batch.pop(k) for k in list(batch) if k in _HOST_KEYS}
            self.last_batch = self.put_batch(batch)
            t2 = time.perf_counter()
            for h in self.hooks:
                h.before_train_iter(self)
            t3 = time.perf_counter()
            self.state, logs = self.train_step(self.state, self.last_batch)
            t4 = time.perf_counter()
            self.stats["load"] += t1 - t0
            self.stats["put"] += t2 - t1
            self.stats["step"] += t4 - t3
            self.step += 1
            self.last_log = logs
            if self.nan_check and not np.isfinite(float(logs.get("loss", 0.0))):
                host = fetch_logs([logs])[0]
                raise FloatingPointError(f"non-finite loss at iter {self.step}: {host}")
            for h in self.hooks:
                h.after_train_iter(self)
        for h in self.hooks:
            h.after_run(self)
        self.logger.info("Training finished")
        return self.state
