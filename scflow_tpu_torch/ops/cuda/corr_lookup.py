"""Kernel K1: windowed bilinear corr-pyramid lookup (csrc/corr_lookup.cu).

Port of scflow_tpu/ops/pallas/corr_lookup.py::corr_lookup_pallas_flat
(variant 'tent').  `corr_lookup_flat` launches the CUDA kernel for CUDA
tensors and runs the plain version, `corr_lookup_flat_plain`, for CPU
tensors; there is no other route.
"""

import ctypes
import math
from typing import Sequence

import torch

from scflow_tpu_torch.ops.cuda.build import CudaKernel

MAX_LEVELS = 4

KERNEL = CudaKernel(
    "corr_lookup.cu", "corr_lookup_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.c_longlong, ctypes.c_void_p],
)


def _level_sizes(pyramid: Sequence[torch.Tensor], rows: int):
    sizes = []
    for m in pyramid:
        s = math.isqrt(m.shape[1]) if m.dim() == 2 else -1
        if m.dim() != 2 or m.shape[0] != rows or s * s != m.shape[1]:
            raise ValueError(f"flat pyramid level must be ({rows}, S*S), got "
                             f"{tuple(m.shape)}")
        sizes.append(s)
    return sizes


def corr_lookup_flat_plain(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                           radius: int = 4) -> torch.Tensor:
    """The tent formulation of scflow_tpu/ops/corr.py::corr_lookup on flat
    levels: out[b, j*k + i] = sum_{h,w} wy[b,i,h] wx[b,j,w] m[b,h,w] with
    wx[b,j,w] = max(0, 1 - |x_b / 2^l + j - r - w|), j offsetting x."""
    b = coords.shape[0]
    k = 2 * radius + 1
    offs = torch.arange(-radius, radius + 1, dtype=coords.dtype, device=coords.device)
    outs = []
    for lvl, (m, s) in enumerate(zip(pyramid, _level_sizes(pyramid, b))):
        px = coords[:, 0] / 2.0**lvl
        py = coords[:, 1] / 2.0**lvl
        grid = torch.arange(s, dtype=coords.dtype, device=coords.device)
        wx = torch.clamp(1.0 - torch.abs(px[:, None, None] + offs[None, :, None]
                                         - grid[None, None, :]), min=0.0)
        wy = torch.clamp(1.0 - torch.abs(py[:, None, None] + offs[None, :, None]
                                         - grid[None, None, :]), min=0.0)
        tmp = torch.bmm(wy, m.reshape(b, s, s))  # (B, i, w)
        out = torch.bmm(wx, tmp.transpose(1, 2))  # (B, j, i)
        outs.append(out.reshape(b, k * k))
    return torch.cat(outs, dim=-1)


def corr_lookup_flat(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                     radius: int = 4) -> torch.Tensor:
    """pyramid: level l is (B, S_l*S_l) float32; coords: (B, 2) float32
    window centres (x, y) at level 0.  Returns (B, L*(2r+1)^2) float32,
    level-major, tap index j*(2r+1) + i with j offsetting x."""
    if coords.device.type == "cpu":
        return corr_lookup_flat_plain(pyramid, coords, radius)
    if coords.device.type != "cuda":
        raise ValueError(f"unsupported device {coords.device}")
    b = coords.shape[0]
    if coords.shape != (b, 2):
        raise ValueError(f"coords must be (B, 2), got {tuple(coords.shape)}")
    if not 1 <= len(pyramid) <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} pyramid levels supported, got {len(pyramid)}")
    sizes = _level_sizes(pyramid, b)
    for t in (coords, *pyramid):
        if t.device != coords.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("corr_lookup_flat needs contiguous float32 tensors "
                             "on one device")
    k = 2 * radius + 1
    out = torch.empty((b, len(pyramid) * k * k), dtype=torch.float32,
                      device=coords.device)
    if b == 0:
        return out
    pad = MAX_LEVELS - len(pyramid)
    ptrs = [m.data_ptr() for m in pyramid] + [None] * pad
    KERNEL.launch(coords.device, coords.data_ptr(), *ptrs, *(sizes + [0] * pad),
                  len(pyramid), radius, b, out.data_ptr())
    return out
