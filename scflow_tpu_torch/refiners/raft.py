"""RAFT baseline refiners, flow-only and flow + occlusion: the network part
of the reference's raft_refiner_flow(_mask).py.  Port of
scflow_tpu/refiners/raft.py.  The pose comes from the flow afterwards, by
PnP on 2D-3D correspondences (refiners/flow_pose.py)."""

from typing import Dict, Optional

import torch
import torch.nn as nn

from scflow_tpu_torch.models.raft_decoder import RAFTDecoder
from scflow_tpu_torch.models.raft_encoder import RAFTEncoder
from scflow_tpu_torch.refiners.scflow import check_channels, check_dtype
from scflow_tpu_torch.registry import REFINERS


class _RAFTRefinerBase(nn.Module):
    predict_occlusion = False

    def __init__(self, seperate_encoder: bool = False, h_channels: int = 128,
                 cxt_channels: int = 128, encoder_out_channels: int = 256,
                 encoder_norm: Optional[str] = "IN", cxt_norm: Optional[str] = "BN",
                 net_type: str = "Basic", num_levels: int = 4, radius: int = 4,
                 iters: int = 12, gru_type: str = "SeqConv", gru_fuse_gates: bool = False,
                 convex_upsample_flow: bool = True, max_flow: float = 400.0,
                 predict_occlusion: Optional[bool] = None, dtype: Optional[torch.dtype] = None):
        """The JAX module's fields and defaults (the reference's spelling of
        seperate_encoder included).  The encoders take net_type and the
        norms ('BN', 'IN', 'GN' or None); the decoder net_type, the levels
        and radius, the GRU and the upsampling (models/raft_decoder.py);
        cxt_channels any width, h_channels the net_type's (128 'Basic', 96
        'Small'), as in JAX, where another fails to broadcast.  RAFT-S, the
        RAFT paper's small model, is net_type='Small', h_channels=96,
        cxt_channels=64, encoder_out_channels=128, cxt_norm=None,
        radius=3, gru_type='Conv'.  num_levels: any count, as JAX's module
        takes; the decoder upsamples the 1/8 flow by 2^(num_levels - 1), so
        only 4 levels give the image's size (5: twice it), and convex
        upsampling (its 576 mask channels) reshapes only at 4 levels, where
        JAX fails too.  dtype: None computes in float32,
        torch.bfloat16 in bf16 (parameters and BatchNorm statistics stay
        float32).  max_flow is carried for the configs; the steps take
        their own."""
        super().__init__()
        dtype = check_dtype(dtype)
        if predict_occlusion is not None:
            self.predict_occlusion = predict_occlusion
        self.seperate_encoder, self.h_channels = seperate_encoder, h_channels
        self.encoder_norm, self.max_flow, self.dtype = encoder_norm, max_flow, dtype
        self.cxt_norm = cxt_norm
        enc = dict(net_type=net_type)
        self.render_encoder = RAFTEncoder(encoder_out_channels, encoder_norm, dtype, **enc)
        if seperate_encoder:
            self.real_encoder = RAFTEncoder(encoder_out_channels, encoder_norm, dtype, **enc)
        self.context = RAFTEncoder(h_channels + cxt_channels, cxt_norm, dtype, **enc)
        self.decoder = RAFTDecoder(net_type=net_type, num_levels=num_levels, radius=radius,
                                   iters=iters, gru_type=gru_type, gru_fuse_gates=gru_fuse_gates,
                                   convex_upsample_flow=convex_upsample_flow,
                                   predict_occlusion=self.predict_occlusion, dtype=dtype,
                                   cxt_channels=cxt_channels)
        check_channels(self.decoder, h_channels)

    def _encode_pair(self, render: torch.Tensor, real: torch.Tensor, train: bool):
        """Both feature maps.  A shared instance-normed encoder takes them as
        one doubled batch (per-sample statistics, so equal to two passes)."""
        if self.seperate_encoder:
            return self.render_encoder(render, train), self.real_encoder(real, train)
        if self.encoder_norm == "IN" and render.shape[0] == real.shape[0]:
            feats = self.render_encoder(torch.cat([render, real]), train)
            return feats[:render.shape[0]], feats[render.shape[0]:]
        return self.render_encoder(render, train), self.render_encoder(real, train)

    def extract_feat(self, render_images: torch.Tensor, real_images: torch.Tensor,
                     train: bool = False):
        """NHWC images (N, H, W, 3) -> NCHW (render_feat, real_feat, h_feat,
        cxt_feat).  An unbatched (H, W, 3) image on either side is encoded
        once and expanded to the other side's views, as in JAX."""
        def nchw(x):
            return x.permute(0, 3, 1, 2).contiguous()

        real_encoder = self.real_encoder if self.seperate_encoder else self.render_encoder
        if render_images.ndim == 4 and real_images.ndim == 4:
            render_feat, real_feat = self._encode_pair(nchw(render_images), nchw(real_images),
                                                       train)
            cxt = self.context(nchw(render_images), train)
        else:
            if real_images.ndim == 3:
                real_feat = real_encoder(nchw(real_images[None]), train)
                real_feat = real_feat.expand(render_images.shape[0], *real_feat.shape[1:])
            else:
                real_feat = real_encoder(nchw(real_images), train)
            if render_images.ndim == 3:
                views = real_images.shape[0]
                render_feat = self.render_encoder(nchw(render_images[None]), train)
                cxt = self.context(nchw(render_images[None]), train)
                render_feat = render_feat.expand(views, *render_feat.shape[1:])
                cxt = cxt.expand(views, *cxt.shape[1:])
            else:
                render_feat = self.render_encoder(nchw(render_images), train)
                cxt = self.context(nchw(render_images), train)
        h_feat = torch.tanh(cxt[:, :self.h_channels])
        cxt_feat = torch.relu(cxt[:, self.h_channels:])
        return render_feat, real_feat, h_feat, cxt_feat

    def forward(self, render_images: torch.Tensor, real_images: torch.Tensor,
                init_flow: Optional[torch.Tensor] = None, iters: Optional[int] = None,
                train: bool = False, lookup_backend: Optional[str] = None,
                lookup_variant: str = "tent",
                output_sequences: bool = True) -> Dict[str, torch.Tensor]:
        """The JAX module's call on NHWC images: "flow" (T, N, H, W, 2) and,
        for the mask model, "occlusion" (T, N, H, W).  init_flow: (N, H/8,
        W/8, 2), zeros by default.  Images that are not square take the
        JAX package's route for their maps (ops/corr.py; on the card with
        lookup_backend 'xla' or 'auto', 'pallas' raises).  train=True runs the BatchNorms on batch
        statistics and updates their running ones in place.  lookup_backend
        None is the decoder's 'xla', as in JAX; the entry points pass one.
        lookup_variant and output_sequences: RAFTDecoder.forward."""
        feat_render, feat_real, h_feat, cxt_feat = self.extract_feat(render_images, real_images,
                                                                     train)
        if init_flow is None:
            n, _, h, w = feat_real.shape
            dtype = torch.promote_types(feat_real.dtype, torch.float32)  # float32 for bf16
            init_flow = torch.zeros((n, h, w, 2), dtype=dtype, device=feat_real.device)
        return self.decoder(feat_render, feat_real, init_flow, h_feat, cxt_feat, iters=iters,
                            lookup_backend=lookup_backend, lookup_variant=lookup_variant,
                            output_sequences=output_sequences)


@REFINERS.register_module("RAFTRefinerFlow")
class RAFTRefinerFlow(_RAFTRefinerBase):
    predict_occlusion = False


@REFINERS.register_module("RAFTRefinerFlowMask")
class RAFTRefinerFlowMask(_RAFTRefinerBase):
    predict_occlusion = True
