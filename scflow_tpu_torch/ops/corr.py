"""All-pairs correlation pyramid (flat layout) and its windowed lookup.

Ports of scflow_tpu/ops/corr.py::correlation_pyramid_flat and of the lookup
`corr_lookup_dispatch` sends to the TPU kernel.  The all-pairs product is
one large matmul, left to torch.matmul as the JAX package left it to XLA.
"""

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F

from scflow_tpu_torch.geometry import coords_grid
from scflow_tpu_torch.ops.cuda.corr_lookup import corr_lookup_flat


def correlation_pyramid_flat(feat1: torch.Tensor, feat2: torch.Tensor,
                             num_levels: int = 4) -> List[torch.Tensor]:
    """feat1, feat2: (N, H, W, C) -> levels (N*H*W, S_l*S_l), S_l = H / 2^l,
    level 0 = <feat1[n, s], feat2[n, t]> / sqrt(C), then 2x2 average pools."""
    n, h, w, c = feat1.shape
    if h != w or h % 2 ** (num_levels - 1):
        raise ValueError(f"square maps divisible by 2^{num_levels - 1} needed, "
                         f"got {h}x{w}")
    corr = torch.matmul(feat1.reshape(n, h * w, c),
                        feat2.reshape(n, h * w, c).transpose(1, 2)) / math.sqrt(c)
    pyramid = [corr.reshape(n * h * w, h * w)]
    s = h
    for _ in range(num_levels - 1):
        pooled = F.avg_pool2d(pyramid[-1].view(-1, 1, s, s), 2)
        s //= 2
        pyramid.append(pooled.reshape(-1, s * s))
    return pyramid


def corr_lookup(pyramid: Sequence[torch.Tensor], flow: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """flow (N, h, w, 2) at level-0 resolution -> (N, h, w, L*(2r+1)^2):
    the window of every level around pixel + flow, tap order as in
    corr_lookup_flat.  CUDA tensors go to kernel K1, CPU tensors to its
    plain version."""
    n, h, w, _ = flow.shape
    coords = (coords_grid(h, w, flow.dtype, flow.device)[None] + flow).reshape(-1, 2)
    out = corr_lookup_flat(pyramid, coords.contiguous(), radius)
    return out.reshape(n, h, w, -1)
