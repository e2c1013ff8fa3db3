"""Per-stage wall-clock timing, and a torch.profiler trace: the port's copy
of scflow_tpu/utils/timer.py (whose trace is jax.profiler's)."""

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional


class StageTimer:
    """Accumulates wall time per named stage.  Waiting for the card is the
    caller's part: synchronize (torch.cuda.synchronize) or read a result
    on the host inside the stage, or the stage times only the launches."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name}: total {tot:.3f}s, n={n}, mean {tot / n * 1e3:.2f}ms")
        return "\n".join(lines)

    def mean_ms(self, name: str) -> float:
        return self.totals[name] / max(self.counts[name], 1) * 1e3


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """A torch.profiler trace of the block (the host, and the card where
    there is one) written under log_dir as a `*.pt.trace.json` that
    TensorBoard's profiler plugin and chrome://tracing read.  With no
    log_dir it does nothing."""
    if not log_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))):
        yield
