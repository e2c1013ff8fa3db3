"""Convex (learned) upsampling, NHWC: the port's copy of
scflow_tpu/ops/upsample.py.  Each output subpixel is a softmax-weighted
sum of the 3x3 neighbourhood of its coarse pixel (the reference's RAFT
decoder, raft_decoder.py:381-416).  Plain PyTorch, as the JAX package
leaves it to XLA: a softmax, nine shifted slices and one contraction.
torch.softmax, not exp / sum op by op as jax.nn.softmax: on the CPU a
process's first torch.exp call has been seen off by 3.7e-5 on these
probabilities under load, and a bf16 mask rounds within the bf16 bounds
the tests allow either way."""

import torch
import torch.nn.functional as F


def unfold3x3(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H, W, 9, C), zero-padded 3x3 neighbourhoods; tap
    t = ky * 3 + kx, torch F.unfold's channel order."""
    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack([xp[:, ky:ky + h, kx:kx + w, :] for ky in range(3) for kx in range(3)],
                       dim=3)


def convex_upsample(x: torch.Tensor, mask: torch.Tensor, scale: int = 8,
                    multiplier: float = None) -> torch.Tensor:
    """(N, H, W, C) -> (N, scale H, scale W, C).  mask: (N, H, W, 9 scale^2)
    logits, channel ((g * scale + i) * scale + j) for tap g and subpixel
    (i, j), the layout of the reference's mask head.  multiplier scales x
    first: `scale` (the default) for flow, 1.0 for an occlusion map.  The
    dtypes promote as the JAX function's einsum does (a bfloat16 mask on a
    float32 flow gives float32)."""
    if multiplier is None:
        multiplier = float(scale)
    n, h, w, c = x.shape
    m = torch.softmax(mask.reshape(n, h, w, 9, scale, scale), dim=3)
    taps = unfold3x3(x * multiplier)
    dtype = torch.promote_types(m.dtype, taps.dtype)
    up = torch.einsum("nhwgij,nhwgc->nhwijc", m.to(dtype), taps.to(dtype))
    return up.permute(0, 1, 3, 2, 4, 5).reshape(n, h * scale, w * scale, c)
