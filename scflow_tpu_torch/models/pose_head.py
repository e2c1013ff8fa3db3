"""Multi-class delta-pose head (NCHW).  Port of
scflow_tpu/models/pose_head.py::MultiClassPoseHead: three stride-2 GN+ReLU
convs, an NCHW flatten, FC 1024 -> 256, then per-class ortho6d rotation
and translation linears gathered by each sample's own label.

dtype is the computation dtype of the GN convs and the FC layers
(models/layers.py).  The rotation and translation linears have none, as in
the JAX head (its _zero_init_heads builds them without dtype): flax promotes
their bf16 input to the float32 parameters, so the deltas are float32."""

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from scflow_tpu_torch.models.layers import ConvModule, linear

ORTHO6D_IDENTITY = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


class MultiClassPoseHead(nn.Module):
    def __init__(self, num_class: int = 21, in_channels: int = 224,
                 feat_size: Tuple[int, int] = (32, 32), dtype: Optional[torch.dtype] = None):
        """feat_size: the (h, w) of the head's input, which fixes the FC
        input width."""
        super().__init__()
        self.num_class, self.dtype = num_class, dtype
        self.conv_layers = nn.Sequential(*(
            ConvModule(in_channels if i == 0 else 128, 128, 3, stride=2,
                       padding=1, norm="GN", dtype=dtype) for i in range(3)))
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
        feat = self.conv_layers(x).flatten(1)
        for fc in self.fc_layers:
            feat = F.relu(linear(fc[0], feat, self.dtype))
        n = feat.shape[0]
        idx = torch.arange(n, device=feat.device)
        label = label.long()
        rot = linear(self.rotation_pred, feat).view(n, self.num_class, 6)[idx, label]
        trans = linear(self.translation_pred, feat).view(n, self.num_class, 3)[idx, label]
        return rot, trans
