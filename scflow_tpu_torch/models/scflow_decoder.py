"""SCFlow decoder: the shape-constrained recurrent update.

Port of scflow_tpu/models/scflow_decoder.py::SCFlowDecoder and its update
step _SCFlowUpdate, with all of its fields.  Each iteration: corr lookup
(kernel K1, K7 or K8 on a card) at the pose-induced flow -> motion encoder
-> ConvGRU -> delta-flow and mask heads -> delta encoders -> pose head ->
SE(3) update -> the next pose-induced flow at 1/scale resolution, scale =
2^(num_levels - 1).

As in the JAX package, the loop reprojects only the full-resolution pixels
that the 1/scale bilinear downsample (align_corners=True) reads, and
blends them with the same 2-tap weights, rows then columns.  The
recurrence is a plain Python loop (the JAX package's lax.scan or unrolled
loop, which `unroll` and `scan_unroll` choose there and which compute the
same thing; here they are checked and change nothing).  With
pose_only=False the depth is lifted densely once, and after the loop the
full-resolution pose-induced flow, predicted flow and mask of each kept
iteration are rebuilt (the training outputs).

The carried mask starts as ones in the features' dtype and is the mask
head's sigmoid after each iteration; detach_mask stops its gradient into
the next one, mask_corr multiplies the lookup's output by it and mask_flow
the flow the motion encoder reads.  init_flow (N, H, W, 2) warm-starts the
flow carry, downsampled to 1/scale and divided by scale; invalid_flow_num
fills the pose-induced flow where the rendered depth is empty.

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

from scflow_tpu_torch.geometry import (apply_delta_pose, check_depth_transform, coords_grid,
                                       flow_from_object_points_at,
                                       lift_depth_to_object_points,
                                       lift_depth_to_object_points_at)
from scflow_tpu_torch.models.layers import ConvModule
from scflow_tpu_torch.models.motion import ConvGRU, MotionEncoder, XHead
from scflow_tpu_torch.models.pose_head import build_pose_head
from scflow_tpu_torch.ops.corr import corr_lookup, correlation_pyramid_flat
from scflow_tpu_torch.ops.resize import interp_taps, interpolate_bilinear
from scflow_tpu_torch.registry import DECODERS

# the JAX decoders' channel tables (no 'Large': there they raise KeyError)
H_CHANNELS = {"Basic": 128, "Small": 96}
CXT_CHANNELS = {"Basic": 128, "Small": 64}
SEQ_KEYS = ("flow_from_pose", "flow_from_pred", "rotations", "translations", "masks",
            "delta_rotations", "delta_translations")


def check_net_type(net_type: str) -> str:
    if net_type not in H_CHANNELS:
        raise ValueError(f"decoder net_type {net_type!r} unsupported; expected one of "
                         f"{tuple(H_CHANNELS)} (the JAX decoders have no other channel "
                         f"widths)")
    return net_type


def check_unroll(unroll, scan_unroll) -> None:
    """The JAX loop-form fields: unroll a bool, scan_unroll a positive int
    (None: the module's own)."""
    if unroll is not None and not isinstance(unroll, bool):
        raise TypeError(f"unroll must be a bool, got {unroll!r}")
    if scan_unroll is not None and (isinstance(scan_unroll, bool)
                                    or not isinstance(scan_unroll, int) or scan_unroll < 1):
        raise ValueError(f"scan_unroll must be a positive int, got {scan_unroll!r}")


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


@DECODERS.register_module("SCFlowDecoder",
                           requires=("num_class", "image_size", "cxt_channels"))
class SCFlowDecoder(nn.Module):
    """The JAX module's fields, with its defaults, after the port's own
    num_class (the pose head's classes where pose_head_cfg names none),
    image_size (which fixes the pose head's FC width, flax infers it) and,
    as keywords, cxt_channels (the context features' width, None: the
    net_type's; flax infers it).  A net_type, gru_type, depth_transform or
    pose-head type or rotation mode that the JAX decoder does not build
    raises here, at construction."""

    def __init__(self, num_class: int = 21, image_size: Tuple[int, int] = (256, 256),
                 iters: int = 8, detach_flow: bool = True, detach_pose: bool = True,
                 detach_depth_for_xy: bool = False, dtype: Optional[torch.dtype] = None, *,
                 net_type: str = "Basic", num_levels: int = 4, radius: int = 4,
                 detach_mask: bool = True, mask_flow: bool = False, mask_corr: bool = False,
                 depth_transform: str = "exp", gru_type: str = "SeqConv",
                 gru_fuse_gates: bool = False, feat_channels: int = 256,
                 pose_head_cfg: Optional[dict] = None, unroll: bool = True,
                 scan_unroll: int = 1, lookup_backend: str = "xla",
                 cxt_channels: Optional[int] = None):
        super().__init__()
        check_net_type(net_type)
        check_unroll(unroll, scan_unroll)
        check_depth_transform(depth_transform)
        self.iters, self.net_type = iters, net_type
        self.num_levels, self.radius = num_levels, radius
        self.scale = 2 ** (num_levels - 1)  # the recurrence runs at 1/scale resolution
        self.detach_flow, self.detach_mask, self.detach_pose = detach_flow, detach_mask, detach_pose
        self.detach_depth_for_xy = detach_depth_for_xy
        self.mask_flow, self.mask_corr = mask_flow, mask_corr
        self.depth_transform = depth_transform
        self.unroll, self.scan_unroll = unroll, scan_unroll
        self.dtype, self.lookup_backend = dtype, lookup_backend
        h = self.h_channels
        cxt = CXT_CHANNELS[net_type] if cxt_channels is None else cxt_channels
        self.encoder = MotionEncoder(dtype, net_type, num_levels, radius)
        self.gru = ConvGRU(h, cxt + self.encoder.out_channels, dtype, gru_type, gru_fuse_gates)
        self.flow_pred = XHead(h, feat_channels, 2, kind="flow", dtype=dtype)
        self.mask_pred = XHead(h, feat_channels, 1, kind="mask", dtype=dtype)
        self.delta_flow_encoder = nn.Sequential(ConvModule(2, 128, 7, padding=3, dtype=dtype),
                                                ConvModule(128, 64, 3, padding=1, dtype=dtype))
        self.mask_encoder = nn.Sequential(ConvModule(1, 64, 3, padding=1, dtype=dtype),
                                          ConvModule(64, 32, 3, padding=1, dtype=dtype))
        feat_size = (image_size[0] // self.scale, image_size[1] // self.scale)
        self.pose_pred = build_pose_head(pose_head_cfg, num_class, h + 64 + 32, feat_size, dtype)

    @property
    def h_channels(self) -> int:
        return H_CHANNELS[self.net_type]

    @property
    def cxt_channels(self) -> int:
        return CXT_CHANNELS[self.net_type]

    def _tap_geometry(self, img_h: int, img_w: int, device, dtype):
        """Rows/cols the 1/scale downsample reads, their pixel grid
        (2h, 2w, 2) and the blend weights."""
        ylo, yhi, wy_lo, wy_hi = interp_taps(img_h, img_h // self.scale)
        xlo, xhi, wx_lo, wx_hi = interp_taps(img_w, img_w // self.scale)
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
        h_feat: torch.Tensor,  # (N, h_channels, h, w)
        cxt_feat: torch.Tensor,  # (N, cxt_channels, h, w)
        ref_rotation: torch.Tensor,  # (N, 3, 3)
        ref_translation: torch.Tensor,  # (N, 3)
        depth: torch.Tensor,  # (N, H, W) rendered depth
        internal_k: torch.Tensor,  # (N, 3, 3)
        label: torch.Tensor,  # (N,)
        init_flow: Optional[torch.Tensor] = None,  # (N, H, W, 2)
        invalid_flow_num: float = 0.0,
        iters: Optional[int] = None,
        output_sequences: bool = True,
        unroll: Optional[bool] = None,
        scan_unroll: Optional[int] = None,
        lookup_backend: Optional[str] = "auto",
        pose_only: bool = False,
        lookup_variant: str = "tent",
    ) -> Dict[str, torch.Tensor]:
        """Returns per kept iteration (every one with output_sequences, else
        the last): rotations (I, N, 3, 3), translations (I, N, 3) and the
        predicted deltas; with pose_only=False also flow_from_pose and
        flow_from_pred (I, N, H, W, 2) and masks (I, N, H, W).  The JAX
        call's arguments in its order, then lookup_variant; lookup_backend
        defaults to 'auto' (the kernels on a card) and None takes the
        module's own ('xla', as in JAX)."""
        check_unroll(unroll, scan_unroll)
        iters = self.iters if iters is None else iters
        backend = lookup_backend or self.lookup_backend
        scale = self.scale
        n, img_h, img_w = depth.shape
        pyramid = correlation_pyramid_flat(feat_render.permute(0, 2, 3, 1),
                                           feat_real.permute(0, 2, 3, 1), self.num_levels,
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
        ho, wo = img_h // scale, img_w // scale

        if init_flow is None:
            flow = torch.zeros((n, ho, wo, 2), dtype=depth.dtype, device=depth.device)
        else:
            flow = (1.0 / scale) * interpolate_bilinear(init_flow, 1.0 / scale)
        mask = torch.ones((n, 1, ho, wo), dtype=feat_render.dtype, device=depth.device)
        R, t = ref_rotation, ref_translation
        kept = []
        for it in range(iters):
            if self.detach_flow:
                flow = flow.detach()
            if self.detach_mask:
                mask = mask.detach()
            corr = corr_lookup(pyramid, flow, self.radius, backend,
                               lookup_variant).permute(0, 3, 1, 2)
            flow_in = flow.permute(0, 3, 1, 2)
            if self.mask_corr:
                corr = corr * mask
            if self.mask_flow:
                flow_in = flow_in * mask
            motion = self.encoder(corr, flow_in)
            h_feat = self.gru(h_feat, torch.cat([cxt_feat, motion], dim=1))
            delta_flow = self.flow_pred(h_feat)
            mask = torch.sigmoid(self.mask_pred(h_feat))
            d_rot, d_trans = self.pose_pred(
                torch.cat([h_feat, self.delta_flow_encoder(delta_flow),
                           self.mask_encoder(mask)], dim=1), label)
            d_rot, d_trans = d_rot.to(R.dtype), d_trans.to(R.dtype)  # float32, as JAX casts
            if self.detach_pose:
                R, t = R.detach(), t.detach()
            R, t = apply_delta_pose(d_rot, d_trans, R, t, depth_transform=self.depth_transform,
                                    detach_depth_for_xy=self.detach_depth_for_xy)
            if output_sequences or it == iters - 1:
                kept.append((flow, delta_flow.permute(0, 2, 3, 1), mask.permute(0, 2, 3, 1),
                             R, t, d_rot, d_trans))

            # pose-induced flow at the tap pixels, blended rows then columns
            fv = flow_from_object_points_at(points, valid, R, t, internal_k, pix,
                                            invalid_flow_num)
            y1 = (wy_lo[None, :, None, None] * fv[:, :ho]
                  + wy_hi[None, :, None, None] * fv[:, ho:])
            y2 = (wx_lo[None, None, :, None] * y1[:, :, :wo]
                  + wx_hi[None, None, :, None] * y1[:, :, wo:])
            flow = (1.0 / scale) * y2
        fs, df, ms, Rs, ts, drs, dts = (torch.stack(v) for v in zip(*kept))
        out = {"rotations": Rs, "translations": ts, "delta_rotations": drs,
               "delta_translations": dts}
        if pose_only:
            return out
        seq = fs.shape[0]
        out["flow_from_pose"] = _flow_seq_from_poses(points_obj, points_valid, Rs, ts,
                                                     internal_k, invalid_flow_num)
        out["flow_from_pred"] = scale * interpolate_bilinear(
            (fs + df).reshape(seq * n, ho, wo, 2), scale).reshape(seq, n, img_h, img_w, 2)
        out["masks"] = interpolate_bilinear(ms.reshape(seq * n, ho, wo, 1), scale).reshape(
            seq, n, img_h, img_w)
        return {k: out[k] for k in SEQ_KEYS}
