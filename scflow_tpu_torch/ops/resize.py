"""Bilinear resize with torch `F.interpolate` semantics, and 2x average
pooling: copies of scflow_tpu/ops/resize.py (interp_taps, the
interpolation matrices, resize_align_corners, interpolate_bilinear and
avg_pool2).  The resize applies the separable interpolation matrices rows
first, as the JAX package does."""

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def interp_taps(n_in: int, n_out: int, align_corners: bool = True):
    """Per-output-row bilinear taps: (lo, hi, w_lo, w_hi), int32/float32
    arrays of shape (n_out,).  align_corners=False takes the half-pixel
    source position, clipped into [0, n_in - 1].  Callers must not write to
    them: the cache hands the same arrays to every caller."""
    lo = np.zeros(n_out, np.int32)
    hi = np.zeros(n_out, np.int32)
    w_lo = np.ones(n_out, np.float32)
    w_hi = np.zeros(n_out, np.float32)
    if n_out == 1:
        return lo, hi, w_lo, w_hi
    for i in range(n_out):
        if align_corners:
            src = i * (n_in - 1) / (n_out - 1)
        else:
            src = max(0.0, min(n_in - 1.0, (i + 0.5) * n_in / n_out - 0.5))
        lo[i] = int(np.floor(src))
        hi[i] = min(lo[i] + 1, n_in - 1)
        frac = src - lo[i]
        w_lo[i] = 1.0 - frac
        w_hi[i] = frac
    return lo, hi, w_lo, w_hi


@lru_cache(maxsize=64)
def _interp_matrix(n_in: int, n_out: int, align_corners: bool = True) -> np.ndarray:
    """(n_out, n_in) matrix of the 2-tap blends (callers must not write to it)."""
    m = np.zeros((n_out, n_in), np.float32)
    lo, hi, w_lo, w_hi = interp_taps(n_in, n_out, align_corners)
    for i in range(n_out):
        m[i, lo[i]] += w_lo[i]
        m[i, hi[i]] += w_hi[i]
    return m


def resize_align_corners(x: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    """x (N, H, W, C) -> (N, h_out, w_out, C), bilinear with
    align_corners=True; x itself where the size is unchanged.  The float32
    matrices promote a bfloat16 x to float32, as jnp.einsum does."""
    n, h, w, c = x.shape
    if (h_out, w_out) == (h, w):
        return x
    dtype = torch.promote_types(x.dtype, torch.float32)
    mh = torch.from_numpy(_interp_matrix(h, h_out)).to(x.device, dtype)
    mw = torch.from_numpy(_interp_matrix(w, w_out)).to(x.device, dtype)
    x = torch.einsum("oh,nhwc->nowc", mh, x.to(dtype))
    return torch.einsum("pw,nowc->nopc", mw, x)


def interpolate_bilinear(x: torch.Tensor, scale: float) -> torch.Tensor:
    """F.interpolate(scale_factor=scale, mode='bilinear', align_corners=True)
    on x (N, H, W, C): (N, int(H * scale), int(W * scale), C)."""
    n, h, w, c = x.shape
    return resize_align_corners(x, int(h * scale), int(w * scale))


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool with stride 2 of x (N, H, W, C), nn.AvgPool2d(2, 2)
    on even sizes.  Below 2x2 raises ValueError, as JAX's does; an odd size
    raises ValueError too (JAX's reshape fails there)."""
    n, h, w, c = x.shape
    if h < 2 or w < 2:
        raise ValueError(
            f"avg_pool2 needs h, w >= 2, got {(h, w)} — with a 4-level "
            "correlation pyramid the crop must be at least 64px per side "
            "(feature maps are 1/8 scale and halve per level)")
    if h % 2 or w % 2:
        raise ValueError(f"avg_pool2 needs even h, w, got {(h, w)}")
    return x.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
