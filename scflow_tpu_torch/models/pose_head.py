"""Delta-pose heads (NCHW).  Port of scflow_tpu/models/pose_head.py:
three stride-2 GN+ReLU convs, an NCHW flatten, FC 1024 -> 256, then
rotation (ortho6d: 6, quaternion: 4 values) and translation (3) linears
with zero weights and an identity-rotation bias.  MultiClassPoseHead
predicts per class and gathers by each sample's own label;
SingleClassPoseHead predicts once and ignores the label.
`build_pose_head` reads the decoders' pose_head_cfg as the JAX
decoder's _build_pose_head does.

dtype is the computation dtype of the GN convs and the FC layers
(models/layers.py).  The rotation and translation linears have none, as in
the JAX head (its _zero_init_heads builds them without dtype): flax promotes
their bf16 input to the float32 parameters, so the deltas are float32."""

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from scflow_tpu_torch.models.layers import ConvModule, linear
from scflow_tpu_torch.registry import HEADS

ID_BIAS = {"ortho6d": (1.0, 0.0, 0.0, 0.0, 1.0, 0.0), "quaternion": (0.0, 0.0, 0.0, 1.0)}


class _PoseHead(nn.Module):
    """The trunk and the zero-initialised output linears for `outputs`
    predictions (classes)."""

    def __init__(self, outputs: int, in_channels: int, feat_size: Tuple[int, int],
                 dtype: Optional[torch.dtype], rotation_mode: str):
        super().__init__()
        if rotation_mode not in ID_BIAS:
            raise KeyError(rotation_mode)  # JAX's _ID_BIAS lookup
        self.dtype, self.rot_dim = dtype, len(ID_BIAS[rotation_mode])
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
        self.rotation_pred = nn.Linear(256, self.rot_dim * outputs)
        self.translation_pred = nn.Linear(256, 3 * outputs)
        # zero weights and an identity-rotation bias: the first update is
        # the identity (load-bearing for training stability)
        with torch.no_grad():
            self.rotation_pred.weight.zero_()
            self.rotation_pred.bias.copy_(torch.tensor(ID_BIAS[rotation_mode]).repeat(outputs))
            self.translation_pred.weight.zero_()
            self.translation_pred.bias.zero_()

    def _predict(self, x: torch.Tensor):
        feat = self.conv_layers(x).flatten(1)
        for fc in self.fc_layers:
            feat = F.relu(linear(fc[0], feat, self.dtype))
        return linear(self.rotation_pred, feat), linear(self.translation_pred, feat)


@HEADS.register_module("MultiClassPoseHead", requires=("feat_size",))
class MultiClassPoseHead(_PoseHead):
    def __init__(self, num_class: int = 21, in_channels: int = 224,
                 feat_size: Tuple[int, int] = (32, 32), dtype: Optional[torch.dtype] = None,
                 rotation_mode: str = "ortho6d"):
        """feat_size: the (h, w) of the head's input, which fixes the FC
        input width (flax infers it)."""
        super().__init__(num_class, in_channels, feat_size, dtype, rotation_mode)
        self.num_class = num_class

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        rot, trans = self._predict(x)
        n = rot.shape[0]
        idx = torch.arange(n, device=rot.device)
        label = label.long()
        return (rot.view(n, self.num_class, self.rot_dim)[idx, label],
                trans.view(n, self.num_class, 3)[idx, label])


@HEADS.register_module("SingleClassPoseHead", requires=("feat_size",))
class SingleClassPoseHead(_PoseHead):
    def __init__(self, in_channels: int = 224, feat_size: Tuple[int, int] = (32, 32),
                 dtype: Optional[torch.dtype] = None, rotation_mode: str = "ortho6d"):
        super().__init__(1, in_channels, feat_size, dtype, rotation_mode)

    def forward(self, x: torch.Tensor, label: Optional[torch.Tensor] = None):
        return self._predict(x)


POSE_HEADS = {"MultiClassPoseHead": MultiClassPoseHead,
              "SingleClassPoseHead": SingleClassPoseHead}


def build_pose_head(cfg: Optional[dict], num_class: int, in_channels: int,
                    feat_size: Tuple[int, int], dtype: Optional[torch.dtype] = None
                    ) -> _PoseHead:
    """The head of a decoder's pose_head_cfg (None: MultiClassPoseHead), as
    the JAX decoder's _build_pose_head reads it: 'type' picks the class (an
    unknown one raises KeyError, as in JAX), 'num_class' (MultiClassPoseHead
    only; the decoder's num_class where the cfg has none) and
    'rotation_mode' pass through.  The conv input is the decoder's own
    width `in_channels`: flax infers it, so the JAX head ignores the cfg's
    'in_channels', and so does this one."""
    cfg = dict(cfg or {"type": "MultiClassPoseHead"})
    cls = POSE_HEADS[cfg.pop("type")]
    kw = {"rotation_mode": cfg["rotation_mode"]} if "rotation_mode" in cfg else {}
    if cls is MultiClassPoseHead:
        kw["num_class"] = cfg.get("num_class", num_class)
    return cls(in_channels=in_channels, feat_size=feat_size, dtype=dtype, **kw)
