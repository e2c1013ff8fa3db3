"""Multi-class delta-pose head (NCHW).  Port of
scflow_tpu/models/pose_head.py::MultiClassPoseHead: three stride-2 GN+ReLU
convs, an NCHW flatten, FC 1024 -> 256, then per-class ortho6d rotation
and translation linears gathered by each sample's own label."""

from typing import Tuple

import torch
import torch.nn as nn

from scflow_tpu_torch.models.layers import ConvModule

ORTHO6D_IDENTITY = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


class MultiClassPoseHead(nn.Module):
    def __init__(self, num_class: int = 21, in_channels: int = 224,
                 feat_size: Tuple[int, int] = (32, 32)):
        """feat_size: the (h, w) of the head's input, which fixes the FC
        input width."""
        super().__init__()
        self.num_class = num_class
        self.conv_layers = nn.Sequential(*(
            ConvModule(in_channels if i == 0 else 128, 128, 3, stride=2,
                       padding=1, norm="GN") for i in range(3)))
        h, w = feat_size
        for _ in range(3):
            h, w = (h + 1) // 2, (w + 1) // 2
        self.fc_layers = nn.Sequential(
            nn.Sequential(nn.Linear(128 * h * w, 1024), nn.ReLU()),
            nn.Sequential(nn.Linear(1024, 256), nn.ReLU()),
        )
        self.rotation_pred = nn.Linear(256, 6 * num_class)
        self.translation_pred = nn.Linear(256, 3 * num_class)
        # zero weights and an identity-rotation bias: the first update is
        # the identity (load-bearing for training stability)
        with torch.no_grad():
            self.rotation_pred.weight.zero_()
            self.rotation_pred.bias.copy_(torch.tensor(ORTHO6D_IDENTITY).repeat(num_class))
            self.translation_pred.weight.zero_()
            self.translation_pred.bias.zero_()

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        feat = self.fc_layers(self.conv_layers(x).flatten(1))
        n = feat.shape[0]
        idx = torch.arange(n, device=feat.device)
        label = label.long()
        rot = self.rotation_pred(feat).view(n, self.num_class, 6)[idx, label]
        trans = self.translation_pred(feat).view(n, self.num_class, 3)[idx, label]
        return rot, trans
