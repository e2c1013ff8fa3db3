"""Motion encoder, SeqConv ConvGRU and prediction heads (NCHW).  Port of
scflow_tpu/models/motion.py for the 'Basic' net and the unfused gates;
names follow the reference state dict."""

import torch
import torch.nn as nn

from scflow_tpu_torch.models.layers import ConvModule


class MotionEncoder(nn.Module):
    """(corr, flow) -> concat[out_net(concat[corr_net(corr), flow_net(flow)]),
    flow]: 126 + 2 channels.  corr has the 4 levels x 81 taps of the
    lookup."""

    out_channels = 128

    def __init__(self):
        super().__init__()
        self.corr_net = nn.Sequential(ConvModule(4 * 81, 256, 1, padding=0),
                                      ConvModule(256, 192, 3, padding=1))
        self.flow_net = nn.Sequential(ConvModule(2, 128, 7, padding=3),
                                      ConvModule(128, 64, 3, padding=1))
        self.out_net = nn.Sequential(ConvModule(256, 126, 3, padding=1))

    def forward(self, corr: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        out = self.out_net(torch.cat([self.corr_net(corr), self.flow_net(flow)], dim=1))
        return torch.cat([out, flow], dim=1)


class ConvGRU(nn.Module):
    """GRU cell of two passes with (1,5) then (5,1) kernels:
    h' = (1 - z) h + z q, z and r sigmoid convs of [h, x], q a tanh conv of
    [r h, x]."""

    def __init__(self, h_channels: int = 128, x_channels: int = 256):
        super().__init__()
        cin = h_channels + x_channels
        kernels, paddings = [(1, 5), (5, 1)], [(0, 2), (2, 0)]

        def convs(act):
            return nn.ModuleList(ConvModule(cin, h_channels, k, padding=p, act=act)
                                 for k, p in zip(kernels, paddings))

        self.conv_z = convs("sigmoid")
        self.conv_r = convs("sigmoid")
        self.conv_q = convs("tanh")

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for conv_z, conv_r, conv_q in zip(self.conv_z, self.conv_r, self.conv_q):
            hx = torch.cat([h, x], dim=1)
            z = conv_z(hx)
            r = conv_r(hx)
            q = conv_q(torch.cat([r * h, x], dim=1))
            h = (1.0 - z) * h + z * q
        return h


class XHead(nn.Module):
    """One 3x3 conv+ReLU, then a 3x3 ('flow') or 1x1 ('mask') predict conv."""

    def __init__(self, in_channels: int, feat_channels: int, out_channels: int,
                 kind: str = "flow"):
        super().__init__()
        if kind not in ("flow", "mask"):
            raise ValueError(kind)
        self.layers = nn.Sequential(ConvModule(in_channels, feat_channels, 3, padding=1))
        k = 3 if kind == "flow" else 1
        self.predict_layer = nn.Conv2d(feat_channels, out_channels, k, padding=k // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.predict_layer(self.layers(x))
