"""Bilinear resize with torch `F.interpolate(align_corners=True)` semantics:
copies of scflow_tpu/ops/resize.py::interp_taps (the align_corners=True
case, the only one the decoder uses) and interpolate_bilinear, which
applies the separable interpolation matrices rows first, as the JAX
package does."""

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def interp_taps(n_in: int, n_out: int):
    """Per-output-row bilinear taps: (lo, hi, w_lo, w_hi), int32/float32
    arrays of shape (n_out,).  Callers must not write to them: the cache
    hands the same arrays to every caller."""
    lo = np.zeros(n_out, np.int32)
    hi = np.zeros(n_out, np.int32)
    w_lo = np.ones(n_out, np.float32)
    w_hi = np.zeros(n_out, np.float32)
    if n_out == 1:
        return lo, hi, w_lo, w_hi
    for i in range(n_out):
        src = i * (n_in - 1) / (n_out - 1)
        lo[i] = int(np.floor(src))
        hi[i] = min(lo[i] + 1, n_in - 1)
        frac = src - lo[i]
        w_lo[i] = 1.0 - frac
        w_hi[i] = frac
    return lo, hi, w_lo, w_hi


@lru_cache(maxsize=64)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix of the 2-tap blends (callers must not write to it)."""
    m = np.zeros((n_out, n_in), np.float32)
    lo, hi, w_lo, w_hi = interp_taps(n_in, n_out)
    for i in range(n_out):
        m[i, lo[i]] += w_lo[i]
        m[i, hi[i]] += w_hi[i]
    return m


def interpolate_bilinear(x: torch.Tensor, scale: float) -> torch.Tensor:
    """x (N, H, W, C) -> (N, int(H * scale), int(W * scale), C), bilinear with
    align_corners=True.  The float32 matrices promote a bfloat16 x to
    float32, as jnp.einsum does."""
    n, h, w, c = x.shape
    h_out, w_out = int(h * scale), int(w * scale)
    if (h_out, w_out) == (h, w):
        return x
    dtype = torch.promote_types(x.dtype, torch.float32)
    mh = torch.from_numpy(_interp_matrix(h, h_out)).to(x.device, dtype)
    mw = torch.from_numpy(_interp_matrix(w, w_out)).to(x.device, dtype)
    x = torch.einsum("oh,nhwc->nowc", mh, x.to(dtype))
    return torch.einsum("pw,nowc->nopc", mw, x)
