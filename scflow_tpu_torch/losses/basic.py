"""Flow and mask losses: the port's copy of scflow_tpu/losses/basic.py
(raft_loss, l1_loss, endpoint_error, sequence_loss).  Flows are NHWC
(N, H, W, 2), masks (N, H, W)."""

from typing import Callable, List, Optional, Sequence, Tuple

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


def l1_loss(pred: torch.Tensor, gt: torch.Tensor,
            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain mean L1.  Deliberately unmasked: `valid` is taken and ignored,
    as the reference's mask loss (sequence_loss.py:35-37) and the JAX
    function do."""
    return torch.mean(torch.abs(pred - gt))


def endpoint_error(pred_flow: torch.Tensor, gt_flow: torch.Tensor, p: int = 2, q=None,
                   eps=None) -> torch.Tensor:
    """Per-pixel endpoint error map (N, H, W) of flows (N, H, W, 2)
    (reference models/loss/flow_loss.py:9-50): the L2 norm of the
    difference for p = 2, else its L1 norm; (err + eps) ** q only when both
    q and eps are set, as the reference applies it."""
    diff = pred_flow - gt_flow
    if p == 2:
        err = torch.sqrt(torch.sum(diff**2, dim=-1))
    else:
        err = torch.sum(torch.abs(diff), dim=-1)
    if q is not None and eps is not None:
        err = (err + eps) ** q
    return err


def sequence_loss(loss_fn: Callable[..., torch.Tensor], seq_preds: Sequence,
                  gamma: float = 0.8, **kwargs) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """sum_i gamma^(T-1-i) loss_fn(pred_i, **kwargs) over the T iterations
    (reference sequence_loss.py:42-82) and the per-iteration losses.
    seq_preds: a (T, ...) stacked tensor or a list of predictions, each a
    tensor or a tuple of loss_fn's positional arguments."""
    n = len(seq_preds)
    total = 0.0
    per_iter = []
    for i in range(n):
        pred = seq_preds[i]
        args = pred if isinstance(pred, tuple) else (pred,)
        li = loss_fn(*args, **kwargs)
        total = total + (gamma ** (n - 1 - i)) * li
        per_iter.append(li)
    return total, per_iter
