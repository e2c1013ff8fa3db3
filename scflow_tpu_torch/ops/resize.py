"""Bilinear interpolation taps with torch `F.interpolate(align_corners=True)`
semantics (numpy; copy of scflow_tpu/ops/resize.py::interp_taps for the
align_corners=True case, the only one the decoder uses)."""

from functools import lru_cache

import numpy as np


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
