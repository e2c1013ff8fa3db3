"""RAFT iterative decoders, flow-only and flow + occlusion.  Port of
scflow_tpu/models/raft_decoder.py::RAFTDecoder and RAFTDecoderMask.

Each iteration, at 1/8 resolution: the flow is detached, the corr lookup
(kernel K1, K7 or K8 on a card; K1b in its backward, without a flow
gradient since the flow is detached) -> motion encoder -> ConvGRU -> delta
flow; then the full-resolution flow by convex upsampling with the mask
head's weights (0.25 x logits, 9 x 64 channels), and with
predict_occlusion the sigmoid occlusion head upsampled with multiplier 1.
convex_upsample_flow=False upsamples both bilinearly (align_corners=True).

dtype (None: float32; torch.bfloat16) is the computation dtype of every
conv and of the pyramid levels, as in JAX: the lookup's output, the flow
carry and the motion features are float32, h_feat and the heads' outputs
bf16, the delta flow cast to float32, and the upsampled flow float32; the
upsampled occlusion keeps the head's dtype.

Every field of the JAX module: net_type 'Basic' or 'Small' ('Small' has no
up-mask head, so flow and occlusion upsample bilinearly), the SeqConv or
Conv GRU with fused or unfused gates, any level count and radius,
feat_channels and mask_channels.  Convex upsampling reshapes the mask
head's mask_channels (2 radius + 1) channels to 9 scale^2; where they
differ the JAX module fails to reshape and this one raises ValueError at
construction.  Maps that are not square take the JAX package's own route
(ops/corr.py): 'xla', or 'auto'; 'pallas' there raises on the card.
"""

from typing import Dict, Optional

import torch
import torch.nn as nn

from scflow_tpu_torch.models.motion import ConvGRU, MotionEncoder, XHead
from scflow_tpu_torch.models.scflow_decoder import CXT_CHANNELS, H_CHANNELS, check_net_type
from scflow_tpu_torch.ops.corr import corr_lookup, correlation_pyramid_flat
from scflow_tpu_torch.ops.resize import interpolate_bilinear
from scflow_tpu_torch.ops.upsample import convex_upsample
from scflow_tpu_torch.registry import DECODERS


@DECODERS.register_module("RAFTDecoder", requires=("cxt_channels",))
class RAFTDecoder(nn.Module):
    """The JAX module's fields, with its defaults, then the port's own
    cxt_channels (the context features' width, None: the net_type's; flax
    infers it); names follow the reference state dict (encoder, gru,
    flow_pred, mask_pred, occlusion_pred)."""

    def __init__(self, net_type: str = "Basic", num_levels: int = 4, radius: int = 4,
                 iters: int = 12, gru_type: str = "SeqConv", gru_fuse_gates: bool = False,
                 feat_channels: int = 256, mask_channels: int = 64,
                 convex_upsample_flow: bool = True, predict_occlusion: bool = False,
                 dtype: Optional[torch.dtype] = None, lookup_backend: str = "xla",
                 cxt_channels: Optional[int] = None):
        super().__init__()
        self.net_type = check_net_type(net_type)
        self.num_levels, self.radius = num_levels, radius
        self.iters = iters
        self.predict_occlusion = predict_occlusion
        self.dtype, self.lookup_backend = dtype, lookup_backend
        scale = 2 ** (num_levels - 1)
        # flax builds the up-mask head for the 'Basic' net only, and runs it
        # where convex_upsample_flow is set
        self.convex = net_type == "Basic" and convex_upsample_flow
        if self.convex and mask_channels * (2 * radius + 1) != 9 * scale ** 2:
            raise ValueError(
                f"convex upsampling needs mask_channels (2 radius + 1) = 9 x {scale}^2 "
                f"channels, got {mask_channels} x {2 * radius + 1}")
        h = self.h_channels
        cxt = self.cxt_channels if cxt_channels is None else cxt_channels
        self.encoder = MotionEncoder(dtype, net_type, num_levels, radius)
        self.gru = ConvGRU(h, cxt + self.encoder.out_channels, dtype, gru_type, gru_fuse_gates)
        self.flow_pred = XHead(h, feat_channels, 2, kind="flow", dtype=dtype)
        if self.convex:
            self.mask_pred = XHead(h, feat_channels, mask_channels * (2 * radius + 1),
                                   kind="mask", dtype=dtype)
        if predict_occlusion:
            self.occlusion_pred = XHead(h, feat_channels, 1, kind="mask", dtype=dtype)

    @property
    def h_channels(self) -> int:
        return H_CHANNELS[self.net_type]

    @property
    def cxt_channels(self) -> int:
        return CXT_CHANNELS[self.net_type]

    def forward(self, feat1: torch.Tensor, feat2: torch.Tensor, flow: torch.Tensor,
                h_feat: torch.Tensor, cxt_feat: torch.Tensor, iters: Optional[int] = None,
                lookup_backend: Optional[str] = None, lookup_variant: str = "tent",
                output_sequences: bool = True) -> Dict[str, torch.Tensor]:
        """feat1, feat2 (N, C, h, w), flow (N, h, w, 2) the warm start at the
        maps' resolution, h_feat (N, h_channels, h, w) and cxt_feat.
        Returns "flow" (T, N, scale h, scale w, 2), scale = 2^(num_levels -
        1), and, with predict_occlusion, "occlusion" (T, N, scale h, scale
        w), one entry per iteration.  output_sequences=False keeps only the
        last (T = 1) and runs the mask and occlusion heads and the
        upsampling for it alone: what JAX's inference computes once XLA has
        dropped the iterations it does not return.  lookup_backend None
        takes the module's own ('xla', as in JAX); lookup_variant picks the
        kernel ('tent' K1, 'shift' K7, 'bdiag' K8)."""
        iters = self.iters if iters is None else iters
        backend = lookup_backend or self.lookup_backend
        scale = 2 ** (self.num_levels - 1)
        pyramid = correlation_pyramid_flat(feat1.permute(0, 2, 3, 1), feat2.permute(0, 2, 3, 1),
                                           self.num_levels, out_dtype=self.dtype)
        upflows, upoccs = [], []
        for it in range(iters):
            flow = flow.detach()
            corr = corr_lookup(pyramid, flow, self.radius, backend, lookup_variant)
            motion = self.encoder(corr.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2))
            h_feat = self.gru(h_feat, torch.cat([cxt_feat, motion], dim=1))
            flow = flow + self.flow_pred(h_feat).float().permute(0, 2, 3, 1)
            if not output_sequences and it < iters - 1:
                continue
            mask = None
            if self.convex:
                mask = (0.25 * self.mask_pred(h_feat)).permute(0, 2, 3, 1)
                upflows.append(convex_upsample(flow, mask, scale, multiplier=scale))
            else:
                upflows.append(scale * interpolate_bilinear(flow, scale))
            if self.predict_occlusion:
                occ = torch.sigmoid(self.occlusion_pred(h_feat)).permute(0, 2, 3, 1)
                if mask is None:
                    upocc = interpolate_bilinear(occ, scale)
                else:
                    upocc = convex_upsample(occ, mask, scale, multiplier=1.0)
                upoccs.append(upocc[..., 0])
        out = {"flow": torch.stack(upflows)}
        if self.predict_occlusion:
            out["occlusion"] = torch.stack(upoccs)
        return out


@DECODERS.register_module("RAFTDecoderMask", requires=("cxt_channels",))
class RAFTDecoderMask(RAFTDecoder):
    """RAFTDecoder with the occlusion head (predict_occlusion=True)."""

    def __init__(self, **kw):
        kw.setdefault("predict_occlusion", True)
        super().__init__(**kw)
