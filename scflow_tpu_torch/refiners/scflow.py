"""SCFlow refiner network: feature encoder(s), context encoder and the
SCFlow decoder.  Port of scflow_tpu/refiners/scflow.py with all of its
fields."""

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from scflow_tpu_torch.models.raft_encoder import RAFTEncoder
from scflow_tpu_torch.models.scflow_decoder import SCFlowDecoder, check_net_type, check_unroll
from scflow_tpu_torch.registry import REFINERS


def check_dtype(dtype: Optional[torch.dtype]) -> Optional[torch.dtype]:
    """The refiners' dtype: None or torch.float32 (float32, returned as
    None) or torch.bfloat16."""
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be None, torch.float32 or torch.bfloat16, got {dtype}")
    return None if dtype == torch.float32 else dtype


def check_channels(decoder: nn.Module, h_channels: int) -> None:
    """h_channels must be the decoder's GRU width: the JAX refiner splits
    the context at h_channels, and its GRU's gates, of the net_type's
    width, then fail to broadcast against h (a reshape error there)."""
    if h_channels != decoder.h_channels:
        raise ValueError(f"h_channels {h_channels} must be the {decoder.net_type!r} "
                         f"decoder's {decoder.h_channels}")


def check_num_levels(num_levels: int) -> None:
    """The decoders run at 1/2^(num_levels - 1) of the image, the encoders
    at 1/8; JAX's shapes fail to meet for any other count."""
    if num_levels != 4:
        raise ValueError(f"num_levels {num_levels}: the encoders' 1/8 maps need 4 levels")


@REFINERS.register_module("SCFlowRefiner", requires=("num_class", "image_size"))
class SCFlowRefiner(nn.Module):
    """The JAX module's fields, with its defaults (the reference's spelling
    of seperate_encoder included), after the port's own num_class (the pose
    head's classes where pose_head_cfg names none) and image_size (which
    fixes the pose head's FC width, flax infers it).  With
    seperate_encoder=False one feature encoder serves both the rendered and
    the real images (the reference's shared `render_encoder`); with True a
    second, `real_encoder`, takes the real ones.  dtype is the JAX package's
    computation dtype: None computes in float32, torch.bfloat16 in bf16
    (bench.py's flagship dtype), passed to the encoders and the decoder.
    Either way the parameters and BatchNorm statistics stay float32 (so the
    optimizer and convert.py are the same for both) and the poses come back
    float32.  max_flow is carried for the configs; the steps take their
    own.  The shipped configuration (configs/refine_models/scflow.py) sets
    detach_depth_for_xy=True."""

    def __init__(self, num_class: int = 21, image_size: Tuple[int, int] = (256, 256),
                 iters: int = 8, detach_flow: bool = True, detach_pose: bool = True,
                 detach_depth_for_xy: bool = False, dtype: Optional[torch.dtype] = None, *,
                 seperate_encoder: bool = False, h_channels: int = 128,
                 cxt_channels: int = 128, encoder_out_channels: int = 256,
                 encoder_norm: Optional[str] = "IN", cxt_norm: Optional[str] = "BN",
                 net_type: str = "Basic", num_levels: int = 4, radius: int = 4,
                 detach_mask: bool = True, mask_flow: bool = False, mask_corr: bool = False,
                 depth_transform: str = "exp", gru_type: str = "SeqConv",
                 gru_fuse_gates: bool = False, pose_head_cfg: Optional[dict] = None,
                 max_flow: float = 400.0, unroll: bool = True, scan_unroll: int = 1):
        super().__init__()
        dtype = check_dtype(dtype)
        check_net_type(net_type)
        check_num_levels(num_levels)
        self.dtype, self.seperate_encoder = dtype, seperate_encoder
        self.h_channels, self.encoder_norm, self.max_flow = h_channels, encoder_norm, max_flow
        self.cxt_norm = cxt_norm
        enc = dict(net_type=net_type)
        self.render_encoder = RAFTEncoder(encoder_out_channels, encoder_norm, dtype, **enc)
        if seperate_encoder:
            self.real_encoder = RAFTEncoder(encoder_out_channels, encoder_norm, dtype, **enc)
        self.context = RAFTEncoder(h_channels + cxt_channels, cxt_norm, dtype, **enc)
        self.decoder = SCFlowDecoder(
            num_class=num_class, image_size=image_size, iters=iters, detach_flow=detach_flow,
            detach_pose=detach_pose, detach_depth_for_xy=detach_depth_for_xy, dtype=dtype,
            net_type=net_type, num_levels=num_levels, radius=radius, detach_mask=detach_mask,
            mask_flow=mask_flow, mask_corr=mask_corr, depth_transform=depth_transform,
            gru_type=gru_type, gru_fuse_gates=gru_fuse_gates, pose_head_cfg=pose_head_cfg,
            unroll=unroll, scan_unroll=scan_unroll, cxt_channels=cxt_channels)
        check_channels(self.decoder, h_channels)

    def extract_feat(self, render_images: torch.Tensor, real_images: torch.Tensor,
                     train: bool = False):
        """NCHW images -> (render_feat, real_feat, h_feat, cxt_feat).  A
        shared feature encoder takes both images as one doubled batch, as
        the JAX module does (equal to two passes for InstanceNorm, which is
        per sample; with BatchNorm the statistics are the doubled batch's
        there too); separate encoders take one each.  train=True runs the
        BatchNorms on batch statistics and updates their running statistics
        in place."""
        if self.seperate_encoder:
            render_feat = self.render_encoder(render_images, train)
            real_feat = self.real_encoder(real_images, train)
        else:
            n = render_images.shape[0]
            feats = self.render_encoder(torch.cat([render_images, real_images], dim=0), train)
            render_feat, real_feat = feats[:n], feats[n:]
        cxt = self.context(render_images, train)
        h_feat = torch.tanh(cxt[:, :self.h_channels])
        cxt_feat = torch.relu(cxt[:, self.h_channels:])
        return render_feat, real_feat, h_feat, cxt_feat

    def forward(
        self,
        render_images: torch.Tensor,  # (N, H, W, 3) normalized
        real_images: torch.Tensor,  # (N, H, W, 3) normalized
        ref_rotation: torch.Tensor,  # (N, 3, 3)
        ref_translation: torch.Tensor,  # (N, 3)
        depth: torch.Tensor,  # (N, H, W) rendered depth
        internal_k: torch.Tensor,  # (N, 3, 3)
        label: torch.Tensor,  # (N,)
        init_flow: Optional[torch.Tensor] = None,  # (N, H, W, 2)
        iters: Optional[int] = None,
        train: bool = False,
        output_sequences: bool = True,
        unroll: Optional[bool] = None,
        lookup_backend: str = "auto",
        pose_only: bool = False,
        lookup_variant: str = "tent",
    ) -> Dict[str, torch.Tensor]:
        """The JAX module's call, its arguments in its order, then
        lookup_variant.  lookup_backend defaults to 'auto' (the kernels on
        a card), where the JAX module's own default is 'xla'; its entry
        points pass one explicitly, as the port's do.  unroll is checked
        and changes nothing (SCFlowDecoder)."""
        check_unroll(unroll, None)
        feat_render, feat_real, h_feat, cxt_feat = self.extract_feat(
            render_images.permute(0, 3, 1, 2).contiguous(),
            real_images.permute(0, 3, 1, 2).contiguous(), train)
        return self.decoder(feat_render, feat_real, h_feat, cxt_feat, ref_rotation,
                            ref_translation, depth, internal_k, label, init_flow=init_flow,
                            invalid_flow_num=0.0, iters=iters,
                            output_sequences=output_sequences, unroll=unroll,
                            lookup_backend=lookup_backend, pose_only=pose_only,
                            lookup_variant=lookup_variant)
