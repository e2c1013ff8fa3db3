"""Bilinear and nearest sampling of NHWC maps, with torch's `grid_sample`
semantics (zeros or border padding): the port's copy of
scflow_tpu/ops/sampling.py, in its order of operations, so that the same
float32 inputs give the same bits.  Plain PyTorch, as the JAX package
leaves these gathers to XLA.

Nearest is the JAX function's, not F.grid_sample's: the rounded index
(half to even) is clipped into the map, and with zeros padding only a
coordinate outside [-0.5, size - 0.5] reads zero, so x = w - 0.5 reads the
edge pixel where F.grid_sample reads 0."""

import torch


def _gather_hw(flat: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor, w: int) -> torch.Tensor:
    """flat (N, H*W, C) at clipped integer pixels ix, iy (N, P) -> (N, P, C)."""
    idx = iy * w + ix
    return torch.gather(flat, 1, idx[..., None].expand(-1, -1, flat.shape[-1]))


def sample_at_pixels(feat: torch.Tensor, xy: torch.Tensor, mode: str = "bilinear",
                     padding_mode: str = "zeros") -> torch.Tensor:
    """feat (N, H, W, C) at float pixel coordinates xy (N, P, 2), (x, y)
    order with (0, 0) the centre of the top-left pixel -> (N, P, C).
    mode 'bilinear' or 'nearest'; padding_mode 'zeros' zeroes the weight of
    every corner outside the map (nearest: the whole sample outside
    [-0.5, size - 0.5]), any other reads the clipped edge, as JAX's does."""
    n, h, w, c = feat.shape
    flat = feat.reshape(n, h * w, c)
    x, y = xy[..., 0], xy[..., 1]

    if mode == "nearest":
        ix = torch.clamp(torch.round(x).long(), 0, w - 1)
        iy = torch.clamp(torch.round(y).long(), 0, h - 1)
        out = _gather_hw(flat, ix, iy, w)
        if padding_mode == "zeros":
            inside = (x >= -0.5) & (x <= w - 0.5) & (y >= -0.5) & (y <= h - 0.5)
            out = out * inside[..., None].to(feat.dtype)
        return out

    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    ix0, iy0 = x0.long(), y0.long()
    ix1, iy1 = ix0 + 1, iy0 + 1
    if padding_mode == "zeros":
        wx0 = wx0 * ((ix0 >= 0) & (ix0 <= w - 1)).to(feat.dtype)
        wx1 = wx1 * ((ix1 >= 0) & (ix1 <= w - 1)).to(feat.dtype)
        wy0 = wy0 * ((iy0 >= 0) & (iy0 <= h - 1)).to(feat.dtype)
        wy1 = wy1 * ((iy1 >= 0) & (iy1 <= h - 1)).to(feat.dtype)
    cx0, cx1 = torch.clamp(ix0, 0, w - 1), torch.clamp(ix1, 0, w - 1)
    cy0, cy1 = torch.clamp(iy0, 0, h - 1), torch.clamp(iy1, 0, h - 1)
    return (_gather_hw(flat, cx0, cy0, w) * (wx0 * wy0)[..., None]
            + _gather_hw(flat, cx1, cy0, w) * (wx1 * wy0)[..., None]
            + _gather_hw(flat, cx0, cy1, w) * (wx0 * wy1)[..., None]
            + _gather_hw(flat, cx1, cy1, w) * (wx1 * wy1)[..., None])


def grid_sample(feat: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                padding_mode: str = "zeros", align_corners: bool = False) -> torch.Tensor:
    """F.grid_sample's counterpart on NHWC maps: feat (N, H, W, C), grid
    (N, Ho, Wo, 2) of normalized (x, y) in [-1, 1] -> (N, Ho, Wo, C)."""
    n, h, w, _ = feat.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        px = (gx + 1.0) * 0.5 * (w - 1)
        py = (gy + 1.0) * 0.5 * (h - 1)
    else:
        px = ((gx + 1.0) * w - 1.0) * 0.5
        py = ((gy + 1.0) * h - 1.0) * 0.5
    xy = torch.stack([px, py], dim=-1).reshape(n, -1, 2)
    out = sample_at_pixels(feat, xy, mode=mode, padding_mode=padding_mode)
    return out.reshape(grid.shape[:-1] + (feat.shape[-1],))
