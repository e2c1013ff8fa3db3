"""RAFT feature/context encoder, 'Basic' arch (NCHW).  Port of
scflow_tpu/models/raft_encoder.py: 7x7 stride-2 stem, three stages of two
BasicBlocks (64/96/128 channels, strides 1/2/2), 1x1 output conv -> 1/8
scale.  Names follow the reference state dict (conv1, bn1/in1,
res_layerK.B, downsample.0/1, conv2)."""

import torch
import torch.nn as nn
import torch.nn.functional as F

from scflow_tpu_torch.models.layers import NORM_ABBR, make_norm


class BasicBlock(nn.Module):
    """3x3 convs with bias -> norm; the downsample projection (on a stride or
    channel change) is a 1x1 conv that keeps its bias, as the reference's
    ResLayer does (load-bearing for its checkpoints)."""

    def __init__(self, in_channels: int, planes: int, stride: int, norm: str):
        super().__init__()
        self.abbr = NORM_ABBR[norm]
        self.conv1 = nn.Conv2d(in_channels, planes, 3, stride, 1, bias=True)
        self.add_module(f"{self.abbr}1", make_norm(norm, planes))
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=True)
        self.add_module(f"{self.abbr}2", make_norm(norm, planes))
        self.downsample = None
        if stride != 1 or in_channels != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, planes, 1, stride, bias=True),
                make_norm(norm, planes),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(getattr(self, f"{self.abbr}1")(self.conv1(x)))
        out = getattr(self, f"{self.abbr}2")(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class RAFTEncoder(nn.Module):
    """(N, 3, H, W) -> (N, out_channels, H/8, W/8)."""

    def __init__(self, out_channels: int = 256, norm: str = "BN"):
        super().__init__()
        self.abbr = NORM_ABBR[norm]
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=True)
        self.add_module(f"{self.abbr}1", make_norm(norm, 64))
        cin = 64
        for i, (planes, stride) in enumerate(zip((64, 96, 128), (1, 2, 2))):
            self.add_module(f"res_layer{i + 1}", nn.Sequential(
                BasicBlock(cin, planes, stride, norm),
                BasicBlock(planes, planes, 1, norm),
            ))
            cin = planes
        self.conv2 = nn.Conv2d(128, out_channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(getattr(self, f"{self.abbr}1")(self.conv1(x)))
        x = self.res_layer3(self.res_layer2(self.res_layer1(x)))
        return self.conv2(x)
