"""Dense blocks (NCHW): the port's copy of scflow_tpu/models/densenet.py
(reference models/backbone/densenet.py:10-110, registered there but unused
by its shipped configs).  Names follow the JAX package's converter:
`layers.{i}.conv` and the norm `layers.{i}.bn` / `.gn`."""

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from scflow_tpu_torch.models.layers import NORM_ABBR, apply_norm, conv2d, make_norm
from scflow_tpu_torch.registry import BACKBONES


class DenseLayer(nn.Module):
    """3x3 conv (with a bias only without a norm) -> BatchNorm or
    GroupNorm(32) -> leaky ReLU(negative_slope), then the concat [out, x]
    on channels.  in_channels is the port's own (flax infers it).  The
    norms carry no dtype, as JAX's do: with dtype bfloat16 their output,
    and so the concat, is float32."""

    def __init__(self, feat_channels: int, norm: Optional[str] = None,
                 negative_slope: float = 0.1, dtype: Optional[torch.dtype] = None, *,
                 in_channels: int):
        super().__init__()
        if norm not in (None, "BN", "GN"):
            raise ValueError(f"DenseLayer norm must be None, 'BN' or 'GN', got {norm!r}")
        self.negative_slope, self.dtype = negative_slope, dtype
        self.conv = nn.Conv2d(in_channels, feat_channels, 3, 1, 1, bias=norm is None)
        self.norm_name = NORM_ABBR.get(norm)
        if norm is not None:
            self.add_module(self.norm_name, make_norm(norm, feat_channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = conv2d(self.conv, x, self.dtype)
        if self.norm_name:
            out = apply_norm(getattr(self, self.norm_name), out.float(), train)
        out = F.leaky_relu(out, self.negative_slope)
        dt = torch.promote_types(out.dtype, x.dtype)
        return torch.cat([out.to(dt), x.to(dt)], dim=1)


@BACKBONES.register_module("BasicDenseBlock", requires=("in_channels",))
class BasicDenseBlock(nn.Module):
    """DenseLayers of feat_channels in turn: (N, in_channels, H, W) ->
    (N, in_channels + sum(feat_channels), H, W)."""

    def __init__(self, feat_channels: Sequence[int] = (128, 128, 96, 64, 32),
                 norm: Optional[str] = None, dtype: Optional[torch.dtype] = None, *,
                 in_channels: int):
        super().__init__()
        layers = []
        for ch in feat_channels:
            layers.append(DenseLayer(ch, norm, dtype=dtype, in_channels=in_channels))
            in_channels += ch
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, train)
        return x
