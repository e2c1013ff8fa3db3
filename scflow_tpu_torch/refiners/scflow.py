"""SCFlow refiner network: shared IN feature encoder, BN context encoder and
the SCFlow decoder.  Port of scflow_tpu/refiners/scflow.py."""

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
                 iters: int = 8, detach_flow: bool = True, detach_pose: bool = True,
                 detach_depth_for_xy: bool = False, dtype: Optional[torch.dtype] = None):
        """The detach options default as in the JAX package; the shipped
        configuration (configs/refine_models/scflow.py) sets
        detach_depth_for_xy=True.  dtype is the JAX package's computation
        dtype: None computes in float32, torch.bfloat16 in bf16 (bench.py's
        flagship dtype), passed to both encoders and the decoder.  Either
        way the parameters and BatchNorm statistics stay float32 (so the
        optimizer and convert.py are the same for both) and the poses come
        back float32."""
        super().__init__()
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be None, torch.float32 or torch.bfloat16, got {dtype}")
        dtype = None if dtype == torch.float32 else dtype
        self.dtype = dtype
        self.render_encoder = RAFTEncoder(256, norm="IN", dtype=dtype)
        self.context = RAFTEncoder(H_CHANNELS + CXT_CHANNELS, norm="BN", dtype=dtype)
        self.decoder = SCFlowDecoder(num_class=num_class, image_size=image_size,
                                     iters=iters, detach_flow=detach_flow,
                                     detach_pose=detach_pose,
                                     detach_depth_for_xy=detach_depth_for_xy, dtype=dtype)

    def extract_feat(self, render_images: torch.Tensor, real_images: torch.Tensor,
                     train: bool = False):
        """NCHW images -> (render_feat, real_feat, h_feat, cxt_feat).  Both
        images run through the feature encoder as one doubled batch
        (InstanceNorm is per sample, so this equals two passes).  train=True
        runs the context encoder's BatchNorms on batch statistics and
        updates their running statistics in place."""
        n = render_images.shape[0]
        feats = self.render_encoder(torch.cat([render_images, real_images], dim=0))
        cxt = self.context(render_images, train)
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
        train: bool = False,
        output_sequences: bool = True,
        pose_only: bool = False,
        lookup_backend: str = "auto",
        lookup_variant: str = "tent",
    ) -> Dict[str, torch.Tensor]:
        """The JAX module's call.  lookup_backend defaults to 'auto' (the
        kernels on a card), where the JAX module's own default is 'xla';
        its entry points pass one explicitly, as the port's do."""
        feat_render, feat_real, h_feat, cxt_feat = self.extract_feat(
            render_images.permute(0, 3, 1, 2).contiguous(),
            real_images.permute(0, 3, 1, 2).contiguous(), train)
        return self.decoder(feat_render, feat_real, h_feat, cxt_feat, ref_rotation,
                            ref_translation, depth, internal_k, label, iters=iters,
                            output_sequences=output_sequences, pose_only=pose_only,
                            lookup_backend=lookup_backend, lookup_variant=lookup_variant)
