"""Building blocks (NCHW): mmcv-style ConvModule, a single-pass
InstanceNorm and a BatchNorm with flax's arithmetic.  Port of
scflow_tpu/models/layers.py; module and parameter names follow the
reference's mmcv state dicts (conv, bn / in / gn).

`dtype` is the JAX package's computation dtype, with flax's meaning:
parameters stay float32 in the module; a conv or linear layer with
dtype=torch.bfloat16 casts its input, weight and bias to bfloat16 at the
call, takes the product (float32 accumulation, one rounding) and adds the
bias in bfloat16, as nn.Conv / nn.Dense(dtype=bf16) do; a norm computes its
statistics and affine math in float32 on the upcast input and rounds the
output once to `dtype`.  None is float32, the modules' original arithmetic.
Explicit casts, not torch.autocast: autocast keeps its own op lists and a
cast cache, and would not follow flax op for op."""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from scflow_tpu_torch.parallel.dist import batch_sum, batch_world

NORM_ABBR = {"BN": "bn", "IN": "in", "GN": "gn"}

_ACTS = {
    None: lambda x: x,
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: Optional[torch.dtype] = None
           ) -> torch.Tensor:
    """`conv` on x in `dtype` (flax nn.Conv(dtype=...)); None runs the module
    as it is."""
    if dtype is None:
        return conv(x)
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride, conv.padding,
                 conv.dilation, conv.groups)
    return y if conv.bias is None else y + conv.bias.to(dtype)[:, None, None]


def linear(layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype] = None
           ) -> torch.Tensor:
    """`layer` on x in `dtype` (flax nn.Dense(dtype=...)); None promotes x to
    the float32 parameters, as nn.Dense with dtype None does."""
    if dtype is None:
        return layer(x.to(layer.weight.dtype))
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over H, W without affine
    parameters, with the JAX package's single-pass variance
    max(E[x^2] - mean^2, 0) (not torch's two-pass InstanceNorm2d).  The
    statistics are float32 whatever x's dtype, and the output takes x's
    dtype, as the JAX module does."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        sq = (xf * xf).mean(dim=(2, 3), keepdim=True)
        var = torch.clamp(sq - mean * mean, min=0.0)
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


def _batch_moments(x: torch.Tensor):
    """Per-channel mean and single-pass variance of x over (N, H, W).  In a
    data-parallel train step (parallel/dist.py::global_batch) the sums and
    counts are summed over the ranks first, with gradient, so the
    statistics are the global batch's, as in JAX's step on the sharded
    batch; elsewhere they are this batch's alone.  The ranks' sums are
    float64: with float32 ones a 2-rank RAFT step's context-encoder
    gradients sat 3e-3 from a float64 run of the step, where one process's
    float32 step sits 7e-6 from it, and tests/test_torch_parallel.py's
    1e-5 bound failed.  They are accumulated in float64 from x and x*x as
    they are, without a float64 copy of x; the statistics return in x's
    dtype."""
    if batch_world() == 1:
        mean = x.mean(dim=(0, 2, 3))
        return mean, torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    c, f64 = x.shape[1], torch.float64
    sums = batch_sum(torch.cat([x.sum(dim=(0, 2, 3), dtype=f64),
                                (x * x).sum(dim=(0, 2, 3), dtype=f64),
                                x.new_full((1,), x.numel() // c, dtype=f64)]))
    mean = sums[:c] / sums[-1]
    var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
    return mean.to(x.dtype), var.to(x.dtype)


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm (momentum 0.9, eps 1e-5) on NCHW, with the state
    dict of nn.BatchNorm2d.  Differs from nn.BatchNorm2d in training: the
    batch variance is single-pass, max(E[x^2] - mean^2, 0), and the running
    variance takes that biased variance (torch's takes the unbiased one).
    `momentum` is flax's: running = momentum * running + (1 - momentum) *
    batch (torch's 0.1 means the same update).  train=True normalizes by the
    batch statistics and updates the running ones in place; train=False
    uses the running ones.  With dtype the statistics and the affine math
    run in float32 on x upcast (the running statistics stay float32) and the
    output is cast to dtype."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.9,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps, self.momentum, self.dtype = eps, momentum, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.dtype is not None:
            x = x.float()
        if train:
            mean, var = _batch_moments(x)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y if self.dtype is None else y.to(self.dtype)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm (the state dict of the reference's GN layers); with dtype,
    flax's nn.GroupNorm(dtype=...): float32 statistics and affine math on x
    upcast, the output cast to dtype."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(num_groups, channels, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return super().forward(x)
        return super().forward(x.float()).to(self.dtype)


def apply_norm(norm: Optional[nn.Module], x: torch.Tensor, train: bool) -> torch.Tensor:
    """A norm layer on x (None: x as it is); only BatchNorm reads `train`."""
    if norm is None:
        return x
    return norm(x, train) if isinstance(norm, BatchNorm) else norm(x)


def make_norm(kind: Optional[str], channels: int, dtype: Optional[torch.dtype] = None
              ) -> Optional[nn.Module]:
    """The norm layer of `kind`: 'BN', 'IN', 'GN' (32 groups, as the JAX
    package's; channels that 32 does not divide raise ValueError, as flax's
    GroupNorm does) or None, no norm (the JAX _Norm(kind=None))."""
    if kind is None:
        return None
    if kind == "BN":
        return BatchNorm(channels, dtype=dtype)
    if kind == "IN":
        return InstanceNorm()
    if kind == "GN":
        return GroupNorm(32, channels, eps=1e-5, dtype=dtype)
    raise ValueError(f"unknown norm {kind}")


class ConvModule(nn.Module):
    """conv -> norm -> act; the conv has a bias only when no norm follows.
    dtype: the computation dtype (module docstring)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride: int = 1, padding=0, norm: Optional[str] = None,
                 act: Optional[str] = "relu", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              padding, bias=norm is None)
        self.norm_name = NORM_ABBR[norm] if norm else None
        if norm:
            self.add_module(self.norm_name, make_norm(norm, out_channels, dtype))
        self.act = _ACTS[act]

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = conv2d(self.conv, x, self.dtype)
        if self.norm_name:
            x = apply_norm(getattr(self, self.norm_name), x, train)
        return self.act(x)
