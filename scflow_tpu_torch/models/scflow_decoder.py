"""SCFlow decoder in pose-only mode: the shape-constrained recurrent update.

Port of scflow_tpu/models/scflow_decoder.py::SCFlowDecoder (pose_only=True)
and its update step _SCFlowUpdate.  Each iteration: corr lookup (kernel K1)
at the pose-induced flow -> motion encoder -> ConvGRU -> delta-flow and
mask heads -> delta encoders -> pose head -> SE(3) update -> the next
pose-induced flow at 1/8 resolution.

As in the JAX package, the loop reprojects only the full-resolution pixels
that the 1/8 bilinear downsample (align_corners=True) reads, and blends
them with the same 2-tap weights, rows then columns.  The recurrence is a
plain Python loop (the JAX package's lax.scan).  Not ported: the dense
full-resolution flow and mask outputs (pose_only=False), mask_flow and
mask_corr (off in the shipped configuration), and the training-time detach
options, which inference does not need.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from scflow_tpu_torch.geometry import (apply_delta_pose,
                                       flow_from_object_points_at,
                                       lift_depth_to_object_points_at)
from scflow_tpu_torch.models.layers import ConvModule
from scflow_tpu_torch.models.motion import ConvGRU, MotionEncoder, XHead
from scflow_tpu_torch.models.pose_head import MultiClassPoseHead
from scflow_tpu_torch.ops.corr import corr_lookup, correlation_pyramid_flat
from scflow_tpu_torch.ops.resize import interp_taps

H_CHANNELS = 128
CXT_CHANNELS = 128
NUM_LEVELS = 4
RADIUS = 4
SCALE = 2 ** (NUM_LEVELS - 1)  # the recurrence runs at 1/8 resolution


class SCFlowDecoder(nn.Module):
    def __init__(self, num_class: int = 21, image_size: Tuple[int, int] = (256, 256),
                 iters: int = 8):
        super().__init__()
        self.iters = iters
        self.encoder = MotionEncoder()
        self.gru = ConvGRU(H_CHANNELS, CXT_CHANNELS + MotionEncoder.out_channels)
        self.flow_pred = XHead(H_CHANNELS, 256, 2, kind="flow")
        self.mask_pred = XHead(H_CHANNELS, 256, 1, kind="mask")
        self.delta_flow_encoder = nn.Sequential(ConvModule(2, 128, 7, padding=3),
                                                ConvModule(128, 64, 3, padding=1))
        self.mask_encoder = nn.Sequential(ConvModule(1, 64, 3, padding=1),
                                          ConvModule(64, 32, 3, padding=1))
        feat_size = (image_size[0] // 8, image_size[1] // 8)
        self.pose_pred = MultiClassPoseHead(num_class, H_CHANNELS + 64 + 32, feat_size)

    def _tap_geometry(self, img_h: int, img_w: int, device):
        """Rows/cols the 1/scale downsample reads, their pixel grid
        (2h, 2w, 2) and the blend weights."""
        ylo, yhi, wy_lo, wy_hi = interp_taps(img_h, img_h // SCALE)
        xlo, xhi, wx_lo, wx_hi = interp_taps(img_w, img_w // SCALE)
        ridx = np.concatenate([ylo, yhi])
        cidx = np.concatenate([xlo, xhi])
        gx, gy = np.meshgrid(cidx.astype(np.float32), ridx.astype(np.float32),
                             indexing="xy")
        pix = torch.from_numpy(np.stack([gx, gy], axis=-1)).to(device)
        weights = [torch.from_numpy(a).to(device) for a in (wy_lo, wy_hi, wx_lo, wx_hi)]
        return (torch.from_numpy(ridx).long().to(device),
                torch.from_numpy(cidx).long().to(device), pix, weights)

    def forward(
        self,
        feat_render: torch.Tensor,  # (N, C, h, w)
        feat_real: torch.Tensor,  # (N, C, h, w)
        h_feat: torch.Tensor,  # (N, 128, h, w)
        cxt_feat: torch.Tensor,  # (N, 128, h, w)
        ref_rotation: torch.Tensor,  # (N, 3, 3)
        ref_translation: torch.Tensor,  # (N, 3)
        depth: torch.Tensor,  # (N, H, W) rendered depth
        internal_k: torch.Tensor,  # (N, 3, 3)
        label: torch.Tensor,  # (N,)
        iters: Optional[int] = None,
    ) -> Dict[str, torch.Tensor]:
        """Returns rotations (I, N, 3, 3), translations (I, N, 3) and the
        predicted deltas, one entry per iteration."""
        iters = self.iters if iters is None else iters
        n, img_h, img_w = depth.shape
        pyramid = correlation_pyramid_flat(feat_render.permute(0, 2, 3, 1),
                                           feat_real.permute(0, 2, 3, 1), NUM_LEVELS)
        ridx, cidx, pix, (wy_lo, wy_hi, wx_lo, wx_hi) = self._tap_geometry(
            img_h, img_w, depth.device)
        points, valid = lift_depth_to_object_points_at(
            depth[:, ridx][:, :, cidx], internal_k, ref_rotation, ref_translation, pix)
        ho, wo = img_h // SCALE, img_w // SCALE

        flow = torch.zeros((n, ho, wo, 2), dtype=torch.float32, device=depth.device)
        R, t = ref_rotation, ref_translation
        seq = {k: [] for k in ("rotations", "translations", "delta_rotations",
                               "delta_translations")}
        for _ in range(iters):
            corr = corr_lookup(pyramid, flow, RADIUS)
            motion = self.encoder(corr.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2))
            h_feat = self.gru(h_feat, torch.cat([cxt_feat, motion], dim=1))
            delta_flow = self.flow_pred(h_feat)
            mask = torch.sigmoid(self.mask_pred(h_feat))
            d_rot, d_trans = self.pose_pred(
                torch.cat([h_feat, self.delta_flow_encoder(delta_flow),
                           self.mask_encoder(mask)], dim=1), label)
            R, t = apply_delta_pose(d_rot, d_trans, R, t)

            # pose-induced flow at the tap pixels, blended rows then columns
            fv = flow_from_object_points_at(points, valid, R, t, internal_k, pix)
            y1 = (wy_lo[None, :, None, None] * fv[:, :ho]
                  + wy_hi[None, :, None, None] * fv[:, ho:])
            y2 = (wx_lo[None, None, :, None] * y1[:, :, :wo]
                  + wx_hi[None, None, :, None] * y1[:, :, wo:])
            flow = (1.0 / SCALE) * y2
            for k, v in zip(seq, (R, t, d_rot, d_trans)):
                seq[k].append(v)
        return {k: torch.stack(v) for k, v in seq.items()}
