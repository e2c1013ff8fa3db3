"""SCFlow decoder: the shape-constrained recurrent update.

Port of scflow_tpu/models/scflow_decoder.py::SCFlowDecoder and its update
step _SCFlowUpdate.  Each iteration: corr lookup (kernel K1, K7 or K8 on a
card) at the pose-induced flow -> motion encoder -> ConvGRU -> delta-flow
and mask heads -> delta encoders -> pose head -> SE(3) update -> the next
pose-induced flow at 1/8 resolution.

As in the JAX package, the loop reprojects only the full-resolution pixels
that the 1/8 bilinear downsample (align_corners=True) reads, and blends
them with the same 2-tap weights, rows then columns.  The recurrence is a
plain Python loop (the JAX package's lax.scan or unrolled loop).  With
pose_only=False the depth is lifted densely once, and after the loop the
full-resolution pose-induced flow, predicted flow and mask of each kept
iteration are rebuilt (the training outputs).  The training-time detach
options are detach_flow, detach_pose and detach_depth_for_xy; the JAX
package's detach_mask acts on a carried mask that only mask_flow and
mask_corr read, and those (off in the shipped configuration) are not
ported, so the port carries no mask.  Not ported either: init_flow.

dtype (None: float32; torch.bfloat16: the JAX package's bf16) is the
computation dtype of every module of the update, as the JAX decoder's
`_update_cfg` passes it, and of the pyramid (`correlation_pyramid_flat(...,
out_dtype=dtype)`).  The tensors keep the JAX dtypes: the pyramid levels
are bf16, so the lookup launches the bf16 instance of its kernel (K1, K7 or
K8 on a card, and K1b in training, whose level gradients come back bf16);
its output, the flow carry and the motion encoder's output are float32;
h_feat, the delta flow and the head's mask are bf16; the pose deltas, R, t
and all pose, flow and geometry math float32; flow_from_pred is built from
(fs + df) in float32, and the full-resolution masks are float32 (the
resize's float32 matrices promote the bf16 mask, as jnp.einsum does).
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from scflow_tpu_torch.geometry import (apply_delta_pose, coords_grid,
                                       flow_from_object_points_at,
                                       lift_depth_to_object_points,
                                       lift_depth_to_object_points_at)
from scflow_tpu_torch.models.layers import ConvModule
from scflow_tpu_torch.models.motion import ConvGRU, MotionEncoder, XHead
from scflow_tpu_torch.models.pose_head import MultiClassPoseHead
from scflow_tpu_torch.ops.corr import corr_lookup, correlation_pyramid_flat
from scflow_tpu_torch.ops.resize import interp_taps, interpolate_bilinear

H_CHANNELS = 128
CXT_CHANNELS = 128
NUM_LEVELS = 4
RADIUS = 4
SCALE = 2 ** (NUM_LEVELS - 1)  # the recurrence runs at 1/8 resolution
SEQ_KEYS = ("flow_from_pose", "flow_from_pred", "rotations", "translations", "masks",
            "delta_rotations", "delta_translations")


def _flow_seq_from_poses(points_obj, valid, R_seq, t_seq, K, invalid_num: float):
    """Dense pose-induced flow for a sequence of poses: (I, N, H, W, 2)."""
    pts_cam = (torch.einsum("snij,nhwj->snhwi", R_seq, points_obj)
               + t_seq[:, :, None, None, :])
    uvw = torch.einsum("nij,snhwj->snhwi", K, pts_cam)
    v = valid[None, ..., None]
    z = torch.where(v, uvw[..., 2:3], torch.ones_like(uvw[..., 2:3]))
    h, w = points_obj.shape[1:3]
    flow = uvw[..., :2] / z - coords_grid(h, w, points_obj.dtype, points_obj.device)[None, None]
    return torch.where(v, flow, torch.full_like(flow, invalid_num))


class SCFlowDecoder(nn.Module):
    def __init__(self, num_class: int = 21, image_size: Tuple[int, int] = (256, 256),
                 iters: int = 8, detach_flow: bool = True, detach_pose: bool = True,
                 detach_depth_for_xy: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.iters = iters
        self.detach_flow = detach_flow
        self.detach_pose = detach_pose
        self.detach_depth_for_xy = detach_depth_for_xy
        self.dtype = dtype
        self.encoder = MotionEncoder(dtype)
        self.gru = ConvGRU(H_CHANNELS, CXT_CHANNELS + MotionEncoder.out_channels, dtype)
        self.flow_pred = XHead(H_CHANNELS, 256, 2, kind="flow", dtype=dtype)
        self.mask_pred = XHead(H_CHANNELS, 256, 1, kind="mask", dtype=dtype)
        self.delta_flow_encoder = nn.Sequential(ConvModule(2, 128, 7, padding=3, dtype=dtype),
                                                ConvModule(128, 64, 3, padding=1, dtype=dtype))
        self.mask_encoder = nn.Sequential(ConvModule(1, 64, 3, padding=1, dtype=dtype),
                                          ConvModule(64, 32, 3, padding=1, dtype=dtype))
        feat_size = (image_size[0] // 8, image_size[1] // 8)
        self.pose_pred = MultiClassPoseHead(num_class, H_CHANNELS + 64 + 32, feat_size, dtype)

    def _tap_geometry(self, img_h: int, img_w: int, device, dtype):
        """Rows/cols the 1/scale downsample reads, their pixel grid
        (2h, 2w, 2) and the blend weights."""
        ylo, yhi, wy_lo, wy_hi = interp_taps(img_h, img_h // SCALE)
        xlo, xhi, wx_lo, wx_hi = interp_taps(img_w, img_w // SCALE)
        ridx = np.concatenate([ylo, yhi])
        cidx = np.concatenate([xlo, xhi])
        gx, gy = np.meshgrid(cidx.astype(np.float32), ridx.astype(np.float32),
                             indexing="xy")
        pix = torch.from_numpy(np.stack([gx, gy], axis=-1)).to(device, dtype)
        weights = [torch.from_numpy(a).to(device, dtype) for a in (wy_lo, wy_hi, wx_lo, wx_hi)]
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
        output_sequences: bool = True,
        pose_only: bool = False,
        lookup_backend: str = "auto",
        lookup_variant: str = "tent",
    ) -> Dict[str, torch.Tensor]:
        """Returns per kept iteration (every one with output_sequences, else
        the last): rotations (I, N, 3, 3), translations (I, N, 3) and the
        predicted deltas; with pose_only=False also flow_from_pose and
        flow_from_pred (I, N, H, W, 2) and masks (I, N, H, W)."""
        iters = self.iters if iters is None else iters
        n, img_h, img_w = depth.shape
        pyramid = correlation_pyramid_flat(feat_render.permute(0, 2, 3, 1),
                                           feat_real.permute(0, 2, 3, 1), NUM_LEVELS,
                                           out_dtype=self.dtype)
        ridx, cidx, pix, (wy_lo, wy_hi, wx_lo, wx_hi) = self._tap_geometry(
            img_h, img_w, depth.device, depth.dtype)
        if pose_only:
            points, valid = lift_depth_to_object_points_at(
                depth[:, ridx][:, :, cidx], internal_k, ref_rotation, ref_translation, pix)
        else:
            points_obj, points_valid = lift_depth_to_object_points(
                depth, internal_k, ref_rotation, ref_translation)
            points = points_obj[:, ridx][:, :, cidx]
            valid = points_valid[:, ridx][:, :, cidx]
        ho, wo = img_h // SCALE, img_w // SCALE

        flow = torch.zeros((n, ho, wo, 2), dtype=depth.dtype, device=depth.device)
        R, t = ref_rotation, ref_translation
        kept = []
        for it in range(iters):
            if self.detach_flow:
                flow = flow.detach()
            corr = corr_lookup(pyramid, flow, RADIUS, lookup_backend, lookup_variant)
            motion = self.encoder(corr.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2))
            h_feat = self.gru(h_feat, torch.cat([cxt_feat, motion], dim=1))
            delta_flow = self.flow_pred(h_feat)
            mask = torch.sigmoid(self.mask_pred(h_feat))
            d_rot, d_trans = self.pose_pred(
                torch.cat([h_feat, self.delta_flow_encoder(delta_flow),
                           self.mask_encoder(mask)], dim=1), label)
            d_rot, d_trans = d_rot.to(R.dtype), d_trans.to(R.dtype)  # float32, as JAX casts
            if self.detach_pose:
                R, t = R.detach(), t.detach()
            R, t = apply_delta_pose(d_rot, d_trans, R, t,
                                    detach_depth_for_xy=self.detach_depth_for_xy)
            if output_sequences or it == iters - 1:
                kept.append((flow, delta_flow.permute(0, 2, 3, 1), mask.permute(0, 2, 3, 1),
                             R, t, d_rot, d_trans))

            # pose-induced flow at the tap pixels, blended rows then columns
            fv = flow_from_object_points_at(points, valid, R, t, internal_k, pix, 0.0)
            y1 = (wy_lo[None, :, None, None] * fv[:, :ho]
                  + wy_hi[None, :, None, None] * fv[:, ho:])
            y2 = (wx_lo[None, None, :, None] * y1[:, :, :wo]
                  + wx_hi[None, None, :, None] * y1[:, :, wo:])
            flow = (1.0 / SCALE) * y2
        fs, df, ms, Rs, ts, drs, dts = (torch.stack(v) for v in zip(*kept))
        out = {"rotations": Rs, "translations": ts, "delta_rotations": drs,
               "delta_translations": dts}
        if pose_only:
            return out
        seq = fs.shape[0]
        out["flow_from_pose"] = _flow_seq_from_poses(points_obj, points_valid, Rs, ts,
                                                     internal_k, 0.0)
        out["flow_from_pred"] = SCALE * interpolate_bilinear(
            (fs + df).reshape(seq * n, ho, wo, 2), SCALE).reshape(seq, n, img_h, img_w, 2)
        out["masks"] = interpolate_bilinear(ms.reshape(seq * n, ho, wo, 1), SCALE).reshape(
            seq, n, img_h, img_w)
        return {k: out[k] for k in SEQ_KEYS}
