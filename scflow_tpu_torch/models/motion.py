"""Motion encoder, ConvGRU and prediction heads (NCHW).  Port of
scflow_tpu/models/motion.py with every option of its modules: the
'Basic', 'Large' and 'Small' motion encoders, the SeqConv and Conv GRUs
with or without fused gates, and XHeads of any layer widths; names follow
the reference state dict.

dtype is each conv's computation dtype (models/layers.py).  The JAX
modules' dtype promotion is kept: torch.cat promotes as jnp.concatenate
does, so the motion encoder's output, concat[bf16 features, float32 flow],
is float32, the GRU's input x is float32 and each conv casts it, and h
keeps the dtype it came in with (bfloat16 from tanh of the bf16 context)."""

from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from scflow_tpu_torch.models.layers import ConvModule, conv2d

# net_type: (corr (channels, kernel, padding) list, flow list, out list), the
# JAX package's _MOTION_ARCH
MOTION_ARCH = {
    "Basic": ([(256, 1, 0), (192, 3, 1)], [(128, 7, 3), (64, 3, 1)], [(126, 3, 1)]),
    "Large": ([(256, 1, 0), (192, 3, 1)], [(128, 7, 3), (64, 3, 1)], [(126, 3, 1)]),
    "Small": ([(96, 1, 0)], [(64, 7, 3), (32, 3, 1)], [(80, 3, 1)]),
}
GRU_TYPES = ("SeqConv", "Conv")


def _convs(cin: int, arch, dtype) -> nn.Sequential:
    layers = []
    for ch, k, p in arch:
        layers.append(ConvModule(cin, ch, k, padding=p, dtype=dtype))
        cin = ch
    return nn.Sequential(*layers)


class MotionEncoder(nn.Module):
    """(corr, flow) -> concat[out_net(concat[corr_net(corr), flow_net(flow)]),
    flow]: out_channels = 126 + 2 ('Basic', 'Large') or 80 + 2 ('Small').
    corr has the num_levels x (2 radius + 1)^2 taps of the lookup (the
    width that the JAX module infers from its input)."""

    def __init__(self, dtype: Optional[torch.dtype] = None, net_type: str = "Basic",
                 num_levels: int = 4, radius: int = 4):
        super().__init__()
        if net_type not in MOTION_ARCH:
            raise ValueError(f"net_type {net_type!r} unsupported; expected one of "
                             f"{tuple(MOTION_ARCH)}")
        corr_arch, flow_arch, out_arch = MOTION_ARCH[net_type]
        self.corr_net = _convs(num_levels * (2 * radius + 1) ** 2, corr_arch, dtype)
        self.flow_net = _convs(2, flow_arch, dtype)
        self.out_net = _convs(corr_arch[-1][0] + flow_arch[-1][0], out_arch, dtype)
        self.out_channels = out_arch[-1][0] + 2

    def forward(self, corr: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        out = self.out_net(torch.cat([self.corr_net(corr), self.flow_net(flow)], dim=1))
        return torch.cat([out, flow], dim=1)


class ConvGRU(nn.Module):
    """GRU cell h' = (1 - z) h + z q, z and r sigmoid convs of [h, x], q a
    tanh conv of [r h, x]: net_type 'SeqConv' runs two such passes with
    (1,5) then (5,1) kernels, 'Conv' one with 3x3 kernels (the JAX module
    reads any other name as 'SeqConv'; here it raises).  fuse_gates=True
    computes z and r as one convolution over their weights concatenated
    along the output channels, as the JAX module does; the parameters are
    the same modules either way (conv_z, conv_r, conv_q), so a state dict
    loads into both."""

    def __init__(self, h_channels: int = 128, x_channels: int = 256,
                 dtype: Optional[torch.dtype] = None, net_type: str = "SeqConv",
                 fuse_gates: bool = False):
        super().__init__()
        if net_type not in GRU_TYPES:
            raise ValueError(f"GRU net_type {net_type!r} unsupported; expected one of "
                             f"{GRU_TYPES}")
        self.h_channels, self.dtype, self.fuse_gates = h_channels, dtype, fuse_gates
        cin = h_channels + x_channels
        if net_type == "Conv":
            kernels, paddings = [(3, 3)], [(1, 1)]
        else:
            kernels, paddings = [(1, 5), (5, 1)], [(0, 2), (2, 0)]

        def convs(act):
            return nn.ModuleList(ConvModule(cin, h_channels, k, padding=p, act=act, dtype=dtype)
                                 for k, p in zip(kernels, paddings))

        self.conv_z = convs("sigmoid")
        self.conv_r = convs("sigmoid")
        self.conv_q = convs("tanh")

    def _zr(self, conv_z: ConvModule, conv_r: ConvModule, hx: torch.Tensor):
        if not self.fuse_gates:
            return conv_z(hx), conv_r(hx)
        cz, cr = conv_z.conv, conv_r.conv
        w = torch.cat([cz.weight, cr.weight])
        b = torch.cat([cz.bias, cr.bias])
        if self.dtype is not None:
            hx, w, b = hx.to(self.dtype), w.to(self.dtype), b.to(self.dtype)
        zr = F.conv2d(hx, w, None, 1, cz.padding) + b[:, None, None]
        return torch.sigmoid(zr[:, :self.h_channels]), torch.sigmoid(zr[:, self.h_channels:])

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for conv_z, conv_r, conv_q in zip(self.conv_z, self.conv_r, self.conv_q):
            z, r = self._zr(conv_z, conv_r, torch.cat([h, x], dim=1))
            q = conv_q(torch.cat([r * h, x], dim=1))
            h = (1.0 - z) * h + z * q
        return h


class XHead(nn.Module):
    """3x3 conv+ReLU layers of widths feat_channels (an int for one layer,
    or a sequence, the JAX module's field), then a 3x3 ('flow') or 1x1
    ('mask') predict conv of x_channels outputs; in_channels is the width
    that flax infers."""

    def __init__(self, in_channels: int, feat_channels: Union[int, Sequence[int]],
                 x_channels: int, kind: str = "flow", dtype: Optional[torch.dtype] = None):
        super().__init__()
        if kind not in ("flow", "mask"):
            raise ValueError(kind)
        self.dtype = dtype
        widths = (feat_channels,) if isinstance(feat_channels, int) else tuple(feat_channels)
        self.layers = _convs(in_channels, [(ch, 3, 1) for ch in widths], dtype)
        k = 3 if kind == "flow" else 1
        cin = widths[-1] if widths else in_channels
        self.predict_layer = nn.Conv2d(cin, x_channels, k, padding=k // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(self.predict_layer, self.layers(x), self.dtype)
