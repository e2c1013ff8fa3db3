"""Backward warping of NHWC maps by optical flow: the port's copy of
scflow_tpu/ops/warp.py (reference models/utils/warp.py:32-105)."""

from typing import Tuple, Union

import torch

from scflow_tpu_torch.ops.sampling import grid_sample


def backward_warp(feat: torch.Tensor, flow: torch.Tensor, mode: str = "bilinear",
                  align_corners: bool = False, use_mask: bool = True,
                  return_mask: bool = False
                  ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """out[p] = feat[p + flow[p]] for feat (N, H, W, C) and flow (N, H, W,
    2).  The grid is normalized by 2 / (size - 1) whatever align_corners,
    as the reference's is.  With use_mask, positions whose sampled ones
    are not above 0.9999 (partly or wholly outside the image) are zeroed;
    return_mask also returns that mask (N, H, W, 1)."""
    n, h, w, _ = flow.shape
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device)
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([gx, gy], dim=-1)[None] + flow
    grid = torch.stack([coords[..., 0] * 2.0 / max(w - 1, 1) - 1.0,
                        coords[..., 1] * 2.0 / max(h - 1, 1) - 1.0], dim=-1)
    out = grid_sample(feat, grid, mode=mode, padding_mode="zeros", align_corners=align_corners)
    if not use_mask:
        return out
    ones = torch.ones_like(feat[..., :1])
    mask = grid_sample(ones, grid, mode=mode, padding_mode="zeros", align_corners=align_corners)
    mask = (mask > 0.9999).to(feat.dtype)
    out = out * mask
    if return_mask:
        return out, mask
    return out
