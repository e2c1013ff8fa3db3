"""SCFlow refiner network: shared IN feature encoder, BN context encoder and
the pose-only SCFlow decoder.  Port of scflow_tpu/refiners/scflow.py."""

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from scflow_tpu_torch.models.raft_encoder import RAFTEncoder
from scflow_tpu_torch.models.scflow_decoder import CXT_CHANNELS, H_CHANNELS, SCFlowDecoder


class SCFlowRefiner(nn.Module):
    """One feature encoder serves both the rendered and the real images
    (the reference's shared `render_encoder`, so there is no separate
    `real_encoder`)."""

    def __init__(self, num_class: int = 21, image_size: Tuple[int, int] = (256, 256),
                 iters: int = 8):
        super().__init__()
        self.render_encoder = RAFTEncoder(256, norm="IN")
        self.context = RAFTEncoder(H_CHANNELS + CXT_CHANNELS, norm="BN")
        self.decoder = SCFlowDecoder(num_class=num_class, image_size=image_size,
                                     iters=iters)

    def extract_feat(self, render_images: torch.Tensor, real_images: torch.Tensor):
        """NCHW images -> (render_feat, real_feat, h_feat, cxt_feat).  Both
        images run through the feature encoder as one doubled batch
        (InstanceNorm is per sample, so this equals two passes)."""
        n = render_images.shape[0]
        feats = self.render_encoder(torch.cat([render_images, real_images], dim=0))
        cxt = self.context(render_images)
        h_feat = torch.tanh(cxt[:, :H_CHANNELS])
        cxt_feat = torch.relu(cxt[:, H_CHANNELS:])
        return feats[:n], feats[n:], h_feat, cxt_feat

    def forward(
        self,
        render_images: torch.Tensor,  # (N, H, W, 3) normalized
        real_images: torch.Tensor,  # (N, H, W, 3) normalized
        ref_rotation: torch.Tensor,  # (N, 3, 3)
        ref_translation: torch.Tensor,  # (N, 3)
        depth: torch.Tensor,  # (N, H, W) rendered depth
        internal_k: torch.Tensor,  # (N, 3, 3)
        label: torch.Tensor,  # (N,)
        iters: Optional[int] = None,
    ) -> Dict[str, torch.Tensor]:
        feat_render, feat_real, h_feat, cxt_feat = self.extract_feat(
            render_images.permute(0, 3, 1, 2).contiguous(),
            real_images.permute(0, 3, 1, 2).contiguous())
        return self.decoder(feat_render, feat_real, h_feat, cxt_feat, ref_rotation,
                            ref_translation, depth, internal_k, label, iters=iters)
