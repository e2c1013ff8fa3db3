"""Building blocks (NCHW): mmcv-style ConvModule, a single-pass
InstanceNorm and a BatchNorm with flax's arithmetic.  Port of
scflow_tpu/models/layers.py; module and parameter names follow the
reference's mmcv state dicts (conv, bn / in / gn)."""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

NORM_ABBR = {"BN": "bn", "IN": "in", "GN": "gn"}

_ACTS = {
    None: lambda x: x,
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over H, W without affine
    parameters, with the JAX package's single-pass variance
    max(E[x^2] - mean^2, 0) (not torch's two-pass InstanceNorm2d)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(2, 3), keepdim=True)
        sq = (x * x).mean(dim=(2, 3), keepdim=True)
        var = torch.clamp(sq - mean * mean, min=0.0)
        return (x - mean) * torch.rsqrt(var + self.eps)


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm (momentum 0.9, eps 1e-5) on NCHW, with the state
    dict of nn.BatchNorm2d.  Differs from nn.BatchNorm2d in training: the
    batch variance is single-pass, max(E[x^2] - mean^2, 0), and the running
    variance takes that biased variance (torch's takes the unbiased one).
    `momentum` is flax's: running = momentum * running + (1 - momentum) *
    batch (torch's 0.1 means the same update).  train=True normalizes by the
    batch statistics and updates the running ones in place; train=False
    uses the running ones."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


def apply_norm(norm: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
    """A norm layer on x; only BatchNorm reads `train`."""
    return norm(x, train) if isinstance(norm, BatchNorm) else norm(x)


def make_norm(kind: str, channels: int) -> nn.Module:
    if kind == "BN":
        return BatchNorm(channels)
    if kind == "IN":
        return InstanceNorm()
    if kind == "GN":
        return nn.GroupNorm(32, channels, eps=1e-5)
    raise ValueError(f"unknown norm {kind}")


class ConvModule(nn.Module):
    """conv -> norm -> act; the conv has a bias only when no norm follows."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride: int = 1, padding=0, norm: Optional[str] = None,
                 act: Optional[str] = "relu"):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              padding, bias=norm is None)
        self.norm_name = NORM_ABBR[norm] if norm else None
        if norm:
            self.add_module(self.norm_name, make_norm(norm, out_channels))
        self.act = _ACTS[act]

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.conv(x)
        if self.norm_name:
            x = apply_norm(getattr(self, self.norm_name), x, train)
        return self.act(x)
