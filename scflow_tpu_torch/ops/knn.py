"""Brute-force nearest neighbours: the port's copy of scflow_tpu/ops/knn.py
(the point-matching losses' stand-in for pytorch3d's knn_points)."""

from typing import Optional, Tuple

import torch


def nn_points(query: torch.Tensor, ref: torch.Tensor,
              ref_valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each query point (..., M, 3) the index (int64) and squared
    distance of its nearest ref point (..., N, 3), skipping ref points where
    ref_valid (..., N) is False.  Ties go to the lowest index, as
    jnp.argmin's do."""
    q2 = torch.sum(query**2, dim=-1, keepdim=True)
    r2 = torch.sum(ref**2, dim=-1)[..., None, :]
    d2 = q2 + r2 - 2.0 * torch.matmul(query, ref.transpose(-1, -2))
    if ref_valid is not None:
        d2 = torch.where(ref_valid[..., None, :], d2, torch.full_like(d2, float("inf")))
    best, idx = torch.min(d2, dim=-1)
    return idx, best
