"""Building blocks (NCHW): mmcv-style ConvModule and a single-pass
InstanceNorm.  Port of scflow_tpu/models/layers.py; module and parameter
names follow the reference's mmcv state dicts (conv, bn / in / gn)."""

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


def make_norm(kind: str, channels: int) -> nn.Module:
    if kind == "BN":
        return nn.BatchNorm2d(channels, eps=1e-5)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm_name:
            x = getattr(self, self.norm_name)(x)
        return self.act(x)
