"""All-pairs correlation pyramid, its windowed lookup, and the local
correlation.

Ports of scflow_tpu/ops/corr.py: correlation_pyramid_flat (the flat levels
every decoder builds), correlation_pyramid (the same levels in the 4-D
layout, as views of the flat ones), `corr_lookup_dispatch` (here
`corr_lookup`), corr_lookup_gather (the reference's gather lookup, JAX's
numerical oracle for the lookup kernels) and local_correlation.  The
all-pairs product is one large matmul, left to torch.matmul as the JAX
package left it to XLA; corr_lookup_gather and local_correlation are plain
PyTorch too, as JAX computes them with XLA outside any Pallas kernel.
Maps that are not square take the JAX package's own route there: its 4-D
pyramid and its XLA tent lookup, outside any Pallas kernel (its kernels'
index math assumes square maps), here the same levels kept flat and the
'xla' formulation below; on the card only when 'xla' (or 'auto') is asked
for, since 'pallas' there would name a kernel that does not run.  The lookup is
differentiable on both backends:

- 'pallas': `corr_lookup_pallas_diff`'s pairing, the kernel of the chosen
  variant forward (K1, K7 or K8) and K1b backward, whose tent derivative is
  0 at the kinks (`_lookup_bwd`): the custom op `scflow::corr_lookup` and
  its registered autograd (ops/cuda/corr_lookup.py);
- 'xla': the tent tensor formulation under autograd, with the subgradients
  JAX's autodiff takes there: d|u|/du = +1 at u = 0 (lax.abs's rule picks
  u >= 0) and the max(0, 0) tie at |u| = 1 split in half.  torch's own
  rules (0 at u = 0, 0.5 or 1 at the tie by op) would differ at every
  integer window centre, which is every row of the first iteration.
"""

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from scflow_tpu_torch.device import resolve_backend
from scflow_tpu_torch.geometry import coords_grid
from scflow_tpu_torch.ops.cuda.corr_lookup import (check_variant, corr_lookup_flat,
                                                   corr_lookup_flat_plain)
from scflow_tpu_torch.ops.sampling import sample_at_pixels


def correlation_pyramid_flat(feat1: torch.Tensor, feat2: torch.Tensor,
                             num_levels: int = 4, out_dtype: Optional[torch.dtype] = None
                             ) -> List[torch.Tensor]:
    """feat1, feat2: (N, H, W, C) -> levels (N*H*W, H_l*W_l), H_l = H / 2^l,
    level 0 = <feat1[n, s], feat2[n, t]> / sqrt(C), then 2x2 average pools
    (the JAX package's flat pyramid on square maps, its 4-D one otherwise:
    the same values).

    out_dtype (the JAX function's): None is float32 on float32 features.
    With out_dtype bfloat16, as the JAX package does, the products
    accumulate in float32, the division by sqrt(C) is float32, and the
    level rounds once to bfloat16.  Where 1/sqrt(C) is a power of two (C =
    256: 2^-4) it is folded into feat1 before one bf16 GEMM, float32
    accumulation, one rounding (exact: a power of two scales a bf16 value
    without rounding, and commutes with the final rounding); for other C
    the product is formed in float32 and cast.  The pooled levels average
    in float32 and round once, as the JAX package's bf16 matmuls with the
    exact 0.25 pool matrix do (avg_pool2d accumulates bf16 in float32)."""
    n, h, w, c = feat1.shape
    if h % 2 ** (num_levels - 1) or w % 2 ** (num_levels - 1):
        raise ValueError(f"{num_levels} levels need maps divisible by 2^{num_levels - 1}, "
                         f"got {h}x{w}")
    f1 = feat1.reshape(n, h * w, c)
    f2t = feat2.reshape(n, h * w, c).transpose(1, 2)
    scale = 1.0 / math.sqrt(c)
    if out_dtype is None:
        corr = torch.matmul(f1, f2t) / math.sqrt(c)
    elif math.frexp(scale)[0] == 0.5:  # a power of two
        corr = torch.matmul(f1.to(out_dtype) * scale, f2t.to(out_dtype))
    else:
        corr = (torch.matmul(f1.float(), f2t.float()) / math.sqrt(c)).to(out_dtype)
    pyramid = [corr.reshape(n * h * w, h * w)]
    for _ in range(num_levels - 1):
        pooled = F.avg_pool2d(pyramid[-1].view(-1, 1, h, w), 2)
        h, w = h // 2, w // 2
        pyramid.append(pooled.reshape(-1, h * w))
    return pyramid


def correlation_pyramid(feat1: torch.Tensor, feat2: torch.Tensor, num_levels: int = 4,
                        out_dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """The levels of correlation_pyramid_flat in the JAX function's 4-D
    layout: (N*H*W, H_l, W_l, 1), each a view of the flat level, with
    corr[n*H*W + s, y, x, 0] = <feat1[n, s // W, s % W], feat2[n, y, x]> /
    sqrt(C)."""
    n, h, w, _ = feat1.shape
    flat = correlation_pyramid_flat(feat1, feat2, num_levels, out_dtype)
    return [m.view(n * h * w, h >> lvl, w >> lvl, 1) for lvl, m in enumerate(flat)]


def corr_lookup_gather(pyramid: Sequence[torch.Tensor], flow: torch.Tensor,
                       radius: int = 4) -> torch.Tensor:
    """The reference's gather lookup, JAX's numerical oracle for the lookup
    kernels: levels (N*H*W, H_l, W_l, 1), flow (N, H, W, 2) at level-0
    resolution -> (N, H, W, L*(2r+1)^2), level-major, each window sampled
    bilinearly with zeros padding (sample_at_pixels) around (pixel + flow)
    / 2^l.  Tap j*(2r+1) + i offsets x by j - r and y by i - r, the
    reference's order, which every lookup shares."""
    n, h, w, _ = flow.shape
    k = 2 * radius + 1
    coords = coords_grid(h, w, flow.dtype, flow.device)[None] + flow
    offs = torch.arange(-radius, radius + 1, dtype=flow.dtype, device=flow.device)
    dx = offs[:, None].expand(k, k)
    dy = offs[None, :].expand(k, k)
    delta = torch.stack([dx, dy], dim=-1).reshape(1, k * k, 2)
    base = coords.reshape(n * h * w, 1, 2)
    outs = []
    for lvl, corr in enumerate(pyramid):
        xy = base / (2.0**lvl) + delta
        sampled = sample_at_pixels(corr, xy, mode="bilinear", padding_mode="zeros")
        outs.append(sampled.reshape(n, h, w, k * k))
    return torch.cat(outs, dim=-1)


def local_correlation(feat1: torch.Tensor, feat2: torch.Tensor, max_displacement: int = 4,
                      normalize: bool = True) -> torch.Tensor:
    """Local-window correlation (mmcv's Correlation op behind the
    reference's CorrBlock, models/utils/corr_block.py:9-109): feat1, feat2
    (N, H, W, C) -> (N, H, W, (2d+1)^2), channel (dy+d)(2d+1) + (dx+d) =
    <feat1[p], feat2[p + (dy, dx)]>, zero outside the map.  normalize
    divides each feature by max(|f|, 1e-9) first.  Shifted slices of the
    zero-padded feat2, as the JAX function computes it."""
    n, h, w, _ = feat1.shape
    d = max_displacement
    if normalize:
        feat1 = feat1 / torch.clamp(torch.linalg.norm(feat1, dim=-1, keepdim=True), min=1e-9)
        feat2 = feat2 / torch.clamp(torch.linalg.norm(feat2, dim=-1, keepdim=True), min=1e-9)
    padded = F.pad(feat2, (0, 0, d, d, d, d))
    outs = [torch.sum(feat1 * padded[:, d + dy:d + dy + h, d + dx:d + dx + w, :], dim=-1)
            for dy in range(-d, d + 1) for dx in range(-d, d + 1)]
    return torch.stack(outs, dim=-1)


class _JaxTent(torch.autograd.Function):
    """max(0, 1 - |u|) with JAX autodiff's derivative: -s(u) where
    1 - |u| > 0, -s(u)/2 where it is 0, else 0, with s(u) = +1 for u >= 0."""

    @staticmethod
    def forward(ctx, u):
        ctx.save_for_backward(u)
        return torch.clamp(1.0 - torch.abs(u), min=0.0)

    @staticmethod
    def backward(ctx, g):
        (u,) = ctx.saved_tensors
        v = 1.0 - torch.abs(u)
        s = torch.where(u >= 0, 1.0, -1.0).to(u.dtype)
        slope = torch.where(v > 0, -s, torch.where(v == 0, -0.5 * s, torch.zeros_like(s)))
        return g * slope


def corr_lookup(pyramid: Sequence[torch.Tensor], flow: torch.Tensor, radius: int = 4,
                backend: str = "auto", variant: str = "tent") -> torch.Tensor:
    """flow (N, h, w, 2) at level-0 resolution -> (N, h, w, L*(2r+1)^2):
    the window of every level around pixel + flow, tap order as in
    corr_lookup_flat.  The levels are flat (N*h*w, h_l*w_l) or in
    correlation_pyramid's 4-D layout.  backend 'pallas' runs the kernels (their plain
    versions on CPU tensors), 'xla' the tent tensor formulation, 'auto'
    'pallas' on a card and 'xla' on the CPU.  Maps that are not square
    take 'xla', as JAX's dispatch does, on 'auto' and on CPU tensors; no
    kernel takes them, so 'pallas' on a CUDA tensor raises there rather
    than run the plain route unseen.  variant 'tent' |
    'shift' | 'bdiag' picks the forward kernel and means nothing on 'xla',
    where any other than 'tent' raises.  On bfloat16 levels the output is float32 on
    both backends: 'pallas' upcasts the cells, as the Pallas kernels do;
    'xla' also rounds the tent weights to bfloat16 first, as the JAX
    package's XLA lookup does (its einsums take the map's dtype)."""
    check_variant(variant)
    # the 4-D levels of correlation_pyramid (JAX's layout) read as flat ones
    pyramid = [m.reshape(m.shape[0], -1) if m.dim() == 4 else m for m in pyramid]
    n, h, w, _ = flow.shape
    if h != w:
        if variant != "tent":
            raise ValueError(f"lookup variant {variant!r} needs square maps, got {h}x{w}")
        if backend == "pallas" and flow.is_cuda:
            raise ValueError(f"backend 'pallas' needs square maps on the card, got {h}x{w}: "
                             f"no kernel takes them; pass 'xla' (the JAX package's own route)")
        backend = "xla"  # the JAX dispatch's fallback: its kernels assume square maps
    backend = resolve_backend(backend, flow.device)
    if backend == "xla" and variant != "tent":
        raise ValueError(f"lookup variant {variant!r} needs backend 'pallas'")
    coords = (coords_grid(h, w, flow.dtype, flow.device)[None] + flow).reshape(-1, 2)
    if backend == "pallas":
        # the custom op scflow::corr_lookup, whose registered backward is K1b
        out = corr_lookup_flat(pyramid, coords.contiguous(), radius, variant)
    else:
        # a square level is S x S whatever S; other levels halve the flow's
        # map per level (JAX's flat-level rule in corr_lookup_dispatch)
        shapes = None if h == w else [(h >> l, w >> l) for l in range(len(pyramid))]
        out = corr_lookup_flat_plain(pyramid, coords, radius, tent=_JaxTent.apply,
                                     round_weights=True, shapes=shapes)
    return out.reshape(n, h, w, -1)
