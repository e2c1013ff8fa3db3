"""Flow and mask losses: the port's copy of scflow_tpu/losses/basic.py
(raft_loss, l1_loss).  Flows are NHWC (N, H, W, 2), masks (N, H, W)."""

from typing import Optional

import torch

from scflow_tpu_torch.parallel.dist import batch_total, batch_world


def raft_loss(pred_flow: torch.Tensor, gt_flow: torch.Tensor,
              valid: Optional[torch.Tensor] = None, max_flow: float = 400.0,
              eps: float = 1e-10) -> torch.Tensor:
    """Masked L1 flow loss over the pixels with (valid >= 0.5) and
    |gt| < max_flow (reference sequence_loss.py:9-24).  In a data-parallel
    train step (parallel/dist.py::global_batch) the valid-pixel count is
    the global batch's, as in JAX's step, and each of the W ranks returns W
    times its share of the global loss, so the mean over the ranks of the
    losses and of their gradients is the global batch's."""
    v = torch.sqrt(torch.sum(gt_flow**2, dim=-1)) < max_flow
    if valid is not None:
        v = (valid >= 0.5) & v
    vf = v.to(gt_flow.dtype)
    num = (vf[..., None] * torch.abs(pred_flow - gt_flow)).sum()
    return num * batch_world() / (batch_total(vf.sum()) + eps)


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Plain mean L1.  Deliberately unmasked, as the reference's mask loss
    is (sequence_loss.py:35-37) and the JAX package keeps it; the JAX
    function takes a `valid` it ignores, which the port leaves out."""
    return torch.mean(torch.abs(pred - gt))
