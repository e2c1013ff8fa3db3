"""RAFT feature/context encoder (NCHW).  Port of
scflow_tpu/models/raft_encoder.py: a 7x7 stem (stride 2, or 1 at scale
1/4), residual stages of two blocks each, a 1x1 output conv.  net_type
picks the stages, as in JAX:
- 'Basic': three stages of two BasicBlocks, 64/96/128 channels, strides
  1/2/2 (1/8 scale);
- 'Large': two stages of two BasicBlocks, 64/96 channels, strides 1/2 (1/4
  scale at the default stem);
- 'Small': a 32-channel stem, three stages of two mmcv Bottlenecks, planes
  8/16/24 (x4 expansion: 32/64/96 channels), strides 1/2/2 (1/8 scale).
norm is 'BN', 'IN', 'GN' (32 groups: 'Small' raises, as flax's GroupNorm
does on its 8-plane stage) or None (no norm layer).  Names follow the
reference state dict (conv1, bn1 / in1 / gn1, res_layerK.B.conv1..3 and
their norms, downsample.0/1, conv2).  dtype: the computation dtype of every
conv and norm (models/layers.py), as the JAX encoder's `dtype` and its
_Norm's rules; the output is in dtype."""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from scflow_tpu_torch.models.layers import NORM_ABBR, apply_norm, conv2d, make_norm
from scflow_tpu_torch.registry import ENCODERS

_BASE_CHANNELS = {"Basic": (64, 96, 128), "Large": (64, 96), "Small": (8, 16, 24)}
_STRIDES = {"Basic": (1, 2, 2), "Large": (1, 2), "Small": (1, 2, 2)}
_STEM_CHANNELS = {"Basic": 64, "Large": 64, "Small": 32}


class _Block(nn.Module):
    """Shared parts of the residual blocks: the norm layers by index (none
    for norm None) and the downsample projection of the identity, a 1x1
    conv that keeps its bias, as the reference's ResLayer does
    (load-bearing for its checkpoints), then the norm.  With avg_down and a
    stride, the projection is a stride-s average pool (ceil_mode,
    count_include_pad=False, so odd maps keep the main branch's ceil(H/s))
    and a stride-1 conv: the reference's downsample.0/1/2 (JAX's
    avgdown_conv, avgdown_norm)."""

    def __init__(self, norm: Optional[str], dtype: Optional[torch.dtype]):
        super().__init__()
        self.abbr, self.dtype = NORM_ABBR.get(norm), dtype
        self.downsample = None

    def _add_norm(self, i: int, norm: Optional[str], channels: int) -> None:
        if norm is not None:
            self.add_module(f"{self.abbr}{i}", make_norm(norm, channels, self.dtype))

    def _norm(self, i: int, x: torch.Tensor, train: bool) -> torch.Tensor:
        return apply_norm(getattr(self, f"{self.abbr}{i}", None), x, train)

    def _set_downsample(self, cin: int, cout: int, stride: int, norm: Optional[str],
                        avg_down: bool = False) -> None:
        layers = []
        if avg_down and stride != 1:
            layers.append(nn.AvgPool2d(stride, stride, ceil_mode=True, count_include_pad=False))
            stride = 1
        layers.append(nn.Conv2d(cin, cout, 1, stride, bias=True))
        if norm is not None:
            layers.append(make_norm(norm, cout, self.dtype))
        self.downsample = nn.Sequential(*layers)

    def _identity(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.downsample is None:
            return x
        layers = list(self.downsample)
        if isinstance(layers[0], nn.AvgPool2d):
            x = layers.pop(0)(x)
        y = conv2d(layers[0], x, self.dtype)
        return apply_norm(layers[1], y, train) if len(layers) > 1 else y


class BasicBlock(_Block):
    """3x3 convs with bias -> norm (the reference's modified BasicBlock),
    the dilation on conv1."""

    expansion = 1

    def __init__(self, in_channels: int, planes: int, stride: int, norm: Optional[str],
                 dtype: Optional[torch.dtype] = None, dilation: int = 1,
                 avg_down: bool = False):
        super().__init__(norm, dtype)
        self.conv1 = nn.Conv2d(in_channels, planes, 3, stride, dilation, dilation, bias=True)
        self._add_norm(1, norm, planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=True)
        self._add_norm(2, norm, planes)
        if stride != 1 or in_channels != planes:
            self._set_downsample(in_channels, planes, stride, norm, avg_down)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        out = F.relu(self._norm(1, conv2d(self.conv1, x, dt), train))
        out = self._norm(2, conv2d(self.conv2, out, dt), train)
        return F.relu(out + self._identity(x, train))


class Bottleneck(_Block):
    """mmcv Bottleneck, 'pytorch' style (JAX Bottleneck): bias-free 1x1,
    3x3 (the stride and the dilation) and 1x1 (x4 expansion) convs, each
    with its norm."""

    expansion = 4

    def __init__(self, in_channels: int, planes: int, stride: int, norm: Optional[str],
                 dtype: Optional[torch.dtype] = None, dilation: int = 1,
                 avg_down: bool = False):
        super().__init__(norm, dtype)
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(in_channels, planes, 1, bias=False)
        self._add_norm(1, norm, planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, dilation, dilation, bias=False)
        self._add_norm(2, norm, planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self._add_norm(3, norm, out)
        if stride != 1 or in_channels != out:
            self._set_downsample(in_channels, out, stride, norm, avg_down)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        out = F.relu(self._norm(1, conv2d(self.conv1, x, dt), train))
        out = F.relu(self._norm(2, conv2d(self.conv2, out, dt), train))
        out = self._norm(3, conv2d(self.conv3, out, dt), train)
        return F.relu(out + self._identity(x, train))


@ENCODERS.register_module("RAFTEncoder")
class RAFTEncoder(nn.Module):
    """(N, in_channels, H, W) -> (N, out_channels, H/8, W/8) ('Large': H/4).
    train=True runs BatchNorm on batch statistics (the JAX package's
    `train`).  The JAX module's fields and defaults; out_channels, norm and
    dtype come first, as the port's callers pass them."""

    def __init__(self, out_channels: int = 256, norm: Optional[str] = "BN",
                 dtype: Optional[torch.dtype] = None, *, in_channels: int = 3,
                 net_type: str = "Basic", scale: float = 1.0 / 8):
        super().__init__()
        if net_type not in _BASE_CHANNELS:
            raise ValueError(f"net_type {net_type!r} unsupported; expected one of "
                             f"{tuple(_BASE_CHANNELS)}")
        if norm is not None and norm not in NORM_ABBR:
            raise ValueError(f"unknown norm {norm!r}")
        self.abbr, self.dtype = NORM_ABBR.get(norm), dtype
        stem = _STEM_CHANNELS[net_type]
        self.conv1 = nn.Conv2d(in_channels, stem, 7, 1 if scale == 1.0 / 4 else 2, 3, bias=True)
        if norm is not None:
            self.add_module(f"{self.abbr}1", make_norm(norm, stem, dtype))
        block = Bottleneck if net_type == "Small" else BasicBlock
        cin = stem
        self.stages = len(_BASE_CHANNELS[net_type])
        for i, (planes, stride) in enumerate(zip(_BASE_CHANNELS[net_type], _STRIDES[net_type])):
            blocks = [block(cin if b == 0 else planes * block.expansion, planes,
                            stride if b == 0 else 1, norm, dtype) for b in range(2)]
            self.add_module(f"res_layer{i + 1}", nn.Sequential(*blocks))
            cin = planes * block.expansion
        self.conv2 = nn.Conv2d(cin, out_channels, 1, bias=True)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = conv2d(self.conv1, x, self.dtype)
        x = F.relu(apply_norm(getattr(self, f"{self.abbr}1", None), x, train))
        for i in range(self.stages):
            for block in getattr(self, f"res_layer{i + 1}"):
                x = block(x, train)
        return conv2d(self.conv2, x, self.dtype)
