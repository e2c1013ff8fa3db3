"""The port's IterRunner and hooks (runtime/runner.py) against the JAX
package's protocol (scflow_tpu/runtime/runner.py, tests/test_runner.py) on
a toy model: the hook order and step counts, the checkpoint interval and
the final save, resume (step, Adam moments, the schedule's lr, and the run
continuing as an unbroken one would), nan_check, TextLoggerHook's message
(equal to JAX's hook's on the same logs), EvalHook's history and save_best
under both rules, ProfileHook's window, and TensorboardHook with and
without a writer.  JAX's ProfileHook reads runner.iter, which JAX's
IterRunner does not define: shown raising here."""

import json
import logging
import sys

import numpy as np
import pytest
import torch

from scflow_tpu_torch.runtime.checkpoint import read_checkpoint
from scflow_tpu_torch.runtime.optim import build_optimizer
from scflow_tpu_torch.runtime.runner import (CheckpointHook, EvalHook, Hook, IterRunner,
                                             ProfileHook, TensorboardHook, TextLoggerHook,
                                             fetch_logs)
from scflow_tpu_torch.runtime.train_state import TrainState

from torch_port_helpers import keep_torch_rng  # noqa: F401

LR = dict(policy="OneCycle", max_lr=0.1, total_steps=20, pct_start=0.2, anneal_strategy="linear")


def make_state(lr_cfg=None):
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        model.weight.copy_(torch.arange(6.0).reshape(2, 3) / 10)
        model.bias.zero_()
    tx, schedule = build_optimizer(model, dict(type="AdamW", lr=0.1, weight_decay=1e-4),
                                   lr_cfg, grad_clip=10.0)
    return TrainState(model, tx), schedule


def fake_step(loss_value=None):
    def step(state, batch):
        with torch.profiler.record_function(f"fake_step_{state.step + 1}"):
            out = state.model(batch["x"])
            loss = (out ** 2).sum()
            state.tx.zero_grad()
            loss.backward()
            norm = state.apply_gradients()
        loss = torch.tensor(loss_value) if loss_value is not None else loss.detach()
        return state, {"loss": loss, "grad_norm": norm, "seq_0_loss": loss * 2}
    return step


def batches():
    i = 0
    while True:
        i += 1
        yield {"x": np.full((2, 3), 0.1 * i, np.float32), "img_metas": [{}], "per_img_patch_num": [1]}


class Recorder(Hook):
    def __init__(self):
        self.calls = []

    def before_run(self, runner):
        self.calls.append(("before_run", runner.step))

    def before_train_iter(self, runner):
        self.calls.append(("before_iter", runner.step))

    def after_train_iter(self, runner):
        self.calls.append(("after_iter", runner.step))

    def after_run(self, runner):
        self.calls.append(("after_run", runner.step))


def test_hooks_order_and_step_counts(tmp_path):
    rec = Recorder()
    state, _ = make_state()
    runner = IterRunner(fake_step(), state, batches(), 3, work_dir=str(tmp_path), hooks=[rec])
    state = runner.run()
    assert state.step == runner.step == 3
    assert rec.calls == [("before_run", 0), ("before_iter", 0), ("after_iter", 1),
                         ("before_iter", 1), ("after_iter", 2), ("before_iter", 2),
                         ("after_iter", 3), ("after_run", 3)]
    assert runner.last_host_extras == {"img_metas": [{}], "per_img_patch_num": [1]}
    assert set(runner.last_batch) == {"x"} and isinstance(runner.last_batch["x"], torch.Tensor)
    assert set(runner.stats) == {"load", "put", "step"} and runner.stats["step"] > 0


def test_checkpoint_interval_and_final_save(tmp_path):
    state, _ = make_state()
    IterRunner(fake_step(), state, batches(), 5, work_dir=str(tmp_path),
               hooks=[CheckpointHook(interval=2)], ckpt_max_keep=2).run()
    assert sorted(p.name for p in (tmp_path / "checkpoints").glob("*.pth")) == [
        "iter_4.pth", "iter_5.pth"]
    ckpt = read_checkpoint(str(tmp_path / "checkpoints" / "iter_5.pth"))
    assert ckpt["meta"] == {"iter": 5, "step": 5}
    torch.testing.assert_close(ckpt["state_dict"]["weight"], state.model.weight.detach(),
                               rtol=0, atol=0)


def test_resume_restores_step_moments_and_lr(tmp_path):
    """4 steps, then a fresh state resumed from iter_4: the step, the Adam
    moments and the lr of the schedule at count 4; two more steps then equal
    an unbroken 6-step run bit for bit."""
    straight, _ = make_state(LR)
    IterRunner(fake_step(), straight, batches(), 6, work_dir=str(tmp_path / "a")).run()
    first, _ = make_state(LR)
    IterRunner(fake_step(), first, batches(), 4, work_dir=str(tmp_path / "b"),
               hooks=[CheckpointHook(interval=4)]).run()
    fresh, schedule = make_state(LR)
    gen = batches()
    for _ in range(4):
        next(gen)  # the data the first run consumed
    runner = IterRunner(fake_step(), fresh, gen, 6, work_dir=str(tmp_path / "b"),
                        lr_schedule=schedule)
    assert runner.resume() == 4 and runner.step == 4 and runner.state.step == 4
    want, got = first.tx.tx.state_dict()["state"], runner.state.tx.tx.state_dict()["state"]
    for k in want:
        for m in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(got[k][m], want[k][m], rtol=0, atol=0)
    assert runner.current_lr() == schedule(4)
    runner.run()
    assert runner.state.tx.tx.param_groups[0]["lr"] == schedule(5)
    for a, b in zip(runner.state.model.parameters(), straight.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert IterRunner(fake_step(), make_state()[0], batches(), 1,
                      work_dir=str(tmp_path / "c")).resume() == 0  # nothing to resume


def test_nan_check(tmp_path):
    state, _ = make_state()
    runner = IterRunner(fake_step(float("nan")), state, batches(), 3, work_dir=str(tmp_path),
                        nan_check=True)
    with pytest.raises(FloatingPointError, match="non-finite loss at iter 1"):
        runner.run()
    state, _ = make_state()
    assert IterRunner(fake_step(float("nan")), state, batches(), 2,
                      work_dir=str(tmp_path)).run().step == 2  # no guard unless asked


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logger(name):
    logger = logging.getLogger(name)
    logger.handlers, logger.propagate = [_Lines()], False
    logger.setLevel(logging.INFO)
    return logger, logger.handlers[0].lines


def test_text_logger_matches_jax_message(tmp_path):
    """Every `interval` steps: the lr, it/s and each log's mean over the
    window (seq_* left out), as JAX's hook words it on the same logs."""
    import jax.numpy as jnp

    from scflow_tpu.runtime.runner import TextLoggerHook as JTextLoggerHook

    state, schedule = make_state(LR)
    logger, lines = _logger("test_text_logger_port")
    IterRunner(fake_step(), state, batches(), 4, work_dir=str(tmp_path), lr_schedule=schedule,
               hooks=[TextLoggerHook(interval=2, smooth_window=3)], logger=logger).run()
    steps = [ln for ln in lines if ln.startswith("Iter")]
    assert len(steps) == 2 and steps[1].startswith(f"Iter [4/4] lr: {schedule(4):.3e}, ")
    assert "seq_" not in steps[1] and "grad_norm: " in steps[1] and " it/s, " in steps[1]

    class Fake:  # JAX's hook on the port's logs of each step
        max_iters, step = 4, 0

        def current_lr(self):
            return schedule(self.step)

    fake = Fake()
    fake.logger, jlines = _logger("test_text_logger_jax")
    hook = JTextLoggerHook(interval=2, smooth_window=3)
    hook.before_run(fake)
    state, _ = make_state(LR)
    step, gen = fake_step(), batches()
    for _ in range(4):
        b = next(gen)
        state, logs = step(state, {"x": torch.as_tensor(b["x"])})
        fake.step += 1
        fake.last_log = {k: jnp.asarray(v.numpy()) for k, v in logs.items()}
        hook.after_train_iter(fake)
    def without_rate(ln):  # "Iter [n/N] lr: x, R it/s, logs" less R
        head, logs = ln.split(" it/s, ")
        return head.rsplit(", ", 1)[0], logs

    assert [without_rate(ln) for ln in steps] == [without_rate(ln) for ln in jlines]


def test_fetch_logs_in_one_copy():
    logs = [{"a": torch.tensor(1.5), "b": torch.tensor(2)}, {}, {"a": torch.tensor(-1.0)}]
    assert fetch_logs(logs) == [{"a": 1.5, "b": 2.0}, {}, {"a": -1.0}]


@pytest.mark.parametrize("rule,best_step", [("greater", 4), ("less", 2)])
def test_eval_hook_history_and_save_best(tmp_path, rule, best_step):
    values = iter([0.5, 0.7, 0.6])
    state, _ = make_state()
    runner = IterRunner(fake_step(), state, batches(), 6, work_dir=str(tmp_path),
                        hooks=[EvalHook(lambda s: {"average/add_10": next(values), "x": 1.0},
                                        interval=2, save_best="average/add_10", rule=rule)])
    runner.run()
    history = json.loads((tmp_path / "eval_history.json").read_text())
    assert [h["step"] for h in history] == [2, 4, 6]
    assert [h["metrics"]["average/add_10"] for h in history] == [0.5, 0.7, 0.6]
    assert runner.eval_history == [(h["step"], h["metrics"]) for h in history]
    best = json.loads((tmp_path / "best.json").read_text())
    assert best["step"] == best_step and best["metric"] == "average/add_10"
    assert read_checkpoint(str(tmp_path / "best_ckpt.pth"))["meta"]["iter"] == best_step


def test_profile_hook_traces_its_window(tmp_path):
    """Steps 2 and 3 of 5 (start 2, 2 steps): the Chrome trace holds their
    record_function spans and no other step's."""
    state, _ = make_state()
    hook = ProfileHook(str(tmp_path / "profile"), start=2, num_steps=2)
    IterRunner(fake_step(), state, batches(), 5, work_dir=str(tmp_path), hooks=[hook]).run()
    assert hook.trace_path.endswith("trace_steps_2_3.json")
    names = {e.get("name") for e in json.loads(open(hook.trace_path).read())["traceEvents"]}
    assert {n for n in names if str(n).startswith("fake_step_")} == {"fake_step_2", "fake_step_3"}


def test_jax_profile_hook_reads_runner_iter_which_jax_runner_lacks(tmp_path):
    import jax.numpy as jnp
    import optax

    from scflow_tpu.runtime import IterRunner as JIterRunner
    from scflow_tpu.runtime import TrainState as JTrainState
    from scflow_tpu.runtime.runner import ProfileHook as JProfileHook

    runner = JIterRunner(lambda s, b: (s, {}), JTrainState.create({"w": jnp.zeros(3)},
                                                                 optax.sgd(0.1)),
                         iter([]), 3, work_dir=str(tmp_path))
    assert not hasattr(runner, "iter")
    with pytest.raises(AttributeError, match="iter"):
        JProfileHook(str(tmp_path / "p"), start=1, num_steps=1).after_train_iter(runner)


def test_tensorboard_hook(tmp_path, monkeypatch):
    """With a writer: the logs and the lr as scalars, image_fn's panels; with
    neither tensorboardX nor torch.utils.tensorboard importable: a warning,
    no writer, and nothing done."""
    panels = []
    state, _ = make_state()
    hook = None
    try:
        hook = TensorboardHook(str(tmp_path / "tb"), interval=2, image_interval=3,
                               image_fn=lambda r: panels.append(r.step) or {
                                   "train/x": np.zeros((4, 4, 3), np.float32)})
    except ImportError:
        pass
    if hook is not None and hook.writer is not None:
        IterRunner(fake_step(), state, batches(), 3, work_dir=str(tmp_path), hooks=[hook]).run()
        assert panels == [3] and list((tmp_path / "tb").glob("events.*"))
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.warns(UserWarning, match="TensorboardHook disabled"):
        hook = TensorboardHook(str(tmp_path / "tb2"), image_fn=lambda r: 1 / 0)
    assert hook.writer is None
    state, _ = make_state()
    IterRunner(fake_step(), state, batches(), 2, work_dir=str(tmp_path / "r"),
               hooks=[hook]).run()
    assert not (tmp_path / "tb2").exists()
