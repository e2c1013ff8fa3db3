"""The full ResNet and ResNetV1d backbones (NCHW): the port's copy of
scflow_tpu/models/resnet.py (reference models/backbone/resnet.py:306-773,
registered there but unused by its shipped configs; custom configs reach
them through BACKBONES).

Module names are the reference's, so its state dicts load strictly: the
stem `conv1` and `bn1` / `in1` / `gn1`, or with deep_stem the Sequential
`stem` (convs at 0, 3, 6, norms at 1, 4, 7); the stages `layer{i}.{b}`,
BasicBlocks for depths 18 and 34, Bottlenecks from 50 up (the blocks of
models/raft_encoder.py), their projections `downsample.0/1`, or with
avg_down `downsample.0/1/2` (pool, conv, norm).

dtype is the computation dtype of the blocks' convs and norms, as in JAX;
the stem's norm carries none there, so with dtype bfloat16 its BatchNorm or
GroupNorm output is float32 (flax promotes to the float32 parameters) and
an InstanceNorm's stays bfloat16, and a block whose identity is that
float32 map adds in float32.  frozen_stages follows JAX: the stem
(frozen_stages >= 0) and stages 1..frozen_stages run their norms on the
running statistics even with train=True, and their outputs are detached
(JAX's stop_gradient), so their parameters get no gradient."""

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from scflow_tpu_torch.models.layers import NORM_ABBR, apply_norm, conv2d, make_norm
from scflow_tpu_torch.models.raft_encoder import BasicBlock, Bottleneck
from scflow_tpu_torch.registry import BACKBONES

ARCH_SETTINGS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


@BACKBONES.register_module("ResNet")
class ResNet(nn.Module):
    """(N, in_channels, H, W) -> the tuple of stage outputs at out_indices
    (1/4, 1/8, 1/16, 1/32 of the input at the default strides).  The JAX
    module's fields and defaults.  A depth outside ARCH_SETTINGS raises
    KeyError, as JAX's does; num_stages outside 1-4, strides or dilations
    not one per stage, an out index past the stages or an unknown norm
    raise ValueError (JAX asserts)."""

    def __init__(self, depth: int = 50, in_channels: int = 3,
                 stem_channels: Optional[int] = None, base_channels: int = 64,
                 num_stages: int = 4, strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3), deep_stem: bool = False,
                 avg_down: bool = False, frozen_stages: int = -1, norm: Optional[str] = "BN",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise KeyError(f"invalid depth {depth} for ResNet")
        if not 1 <= num_stages <= 4:
            raise ValueError(f"num_stages must be 1-4, got {num_stages}")
        if not len(strides) == len(dilations) == num_stages:
            raise ValueError(f"strides {tuple(strides)} and dilations {tuple(dilations)} need "
                             f"one entry per stage ({num_stages})")
        if max(out_indices) >= num_stages:
            raise ValueError(f"out_indices {tuple(out_indices)} past {num_stages} stages")
        if norm is not None and norm not in NORM_ABBR:
            raise ValueError(f"unknown norm {norm!r}")
        block, stage_blocks = ARCH_SETTINGS[depth]
        self.norm, self.dtype, self.deep_stem = norm, dtype, deep_stem
        self.out_indices, self.frozen_stages = tuple(out_indices), frozen_stages
        self.num_stages = num_stages
        stem = stem_channels or base_channels
        if deep_stem:
            half = stem // 2
            layers = []
            for cin, cout, s in ((in_channels, half, 2), (half, half, 1), (half, stem, 1)):
                layers += [nn.Conv2d(cin, cout, 3, s, 1, bias=False),
                           make_norm(norm, cout) or nn.Identity(), nn.ReLU()]
            self.stem = nn.Sequential(*layers)
        else:
            self.conv1 = nn.Conv2d(in_channels, stem, 7, 2, 3, bias=False)
            if norm is not None:
                self.add_module(f"{NORM_ABBR[norm]}1", make_norm(norm, stem))
        inplanes = stem
        for i, num_blocks in enumerate(stage_blocks[:num_stages]):
            planes = base_channels * 2**i
            blocks = []
            for b in range(num_blocks):
                blocks.append(block(inplanes, planes, strides[i] if b == 0 else 1, norm, dtype,
                                    dilations[i], avg_down))
                inplanes = planes * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))

    def _stem_norm(self, layer: Optional[nn.Module], x: torch.Tensor, train: bool):
        if self.norm in ("BN", "GN"):
            x = x.float()  # JAX's stem norms carry no dtype: flax computes in float32
        return apply_norm(layer, x, train)

    def forward(self, x: torch.Tensor, train: bool = False) -> Tuple[torch.Tensor, ...]:
        stem_train = train and self.frozen_stages < 0
        if self.deep_stem:
            for j in range(3):
                x = conv2d(self.stem[3 * j], x, self.dtype)
                x = F.relu(self._stem_norm(self.stem[3 * j + 1], x, stem_train))
        else:
            x = conv2d(self.conv1, x, self.dtype)
            norm = getattr(self, f"{NORM_ABBR[self.norm]}1") if self.norm else None
            x = F.relu(self._stem_norm(norm, x, stem_train))
        x = F.max_pool2d(x, 3, 2, 1)
        if self.frozen_stages >= 0:
            x = x.detach()
        outs = []
        for i in range(self.num_stages):
            stage_train = train and self.frozen_stages < i + 1
            for block in getattr(self, f"layer{i + 1}"):
                x = block(x, stage_train)
            if self.frozen_stages >= i + 1:
                x = x.detach()
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


@BACKBONES.register_module("ResNetV1d")
class ResNetV1d(ResNet):
    """ResNetV1d (reference resnet.py:736-773): ResNet with the deep 3x3
    stem and avg-pool downsampling in the projections by default."""

    def __init__(self, depth: int = 50, in_channels: int = 3,
                 stem_channels: Optional[int] = None, base_channels: int = 64,
                 num_stages: int = 4, strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3), deep_stem: bool = True,
                 avg_down: bool = True, frozen_stages: int = -1, norm: Optional[str] = "BN",
                 dtype: Optional[torch.dtype] = None):
        super().__init__(depth, in_channels, stem_channels, base_channels, num_stages, strides,
                         dilations, out_indices, deep_stem, avg_down, frozen_stages, norm, dtype)
