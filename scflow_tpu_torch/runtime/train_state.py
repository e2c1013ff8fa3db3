"""Train state: the model (its parameters and its BatchNorm statistics, as
buffers), the optimizer with its moments, and the step count.  Port of
scflow_tpu/runtime/train_state.py, whose state holds the same as pytrees;
here the update happens in place."""

from dataclasses import dataclass

import torch

from scflow_tpu_torch.runtime.optim import ClippedOptimizer


@dataclass
class TrainState:
    model: torch.nn.Module
    tx: ClippedOptimizer
    step: int = 0

    def apply_gradients(self) -> torch.Tensor:
        """One optimizer update from the parameters' .grad at the schedule's
        learning rate for this step; returns the global gradient norm
        before the clip."""
        norm = self.tx.step(self.step)
        self.step += 1
        return norm
