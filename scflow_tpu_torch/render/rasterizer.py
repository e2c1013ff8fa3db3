"""Projection and per-face gathers ahead of the raster kernel (ports of
scflow_tpu/render/rasterizer.py: project_to_screen, _gather_tri,
gather_corner_attrs)."""

from typing import Tuple

import torch


def project_to_screen(verts_cam: torch.Tensor, K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """verts_cam (N, V, 3), K (N, 3, 3) -> (xy (N, V, 2), z (N, V))."""
    z = verts_cam[..., 2]
    zsafe = torch.where(torch.abs(z) > 1e-8, z, torch.full_like(z, 1e-8))
    fx, fy = K[:, 0, 0, None], K[:, 1, 1, None]
    cx, cy = K[:, 0, 2, None], K[:, 1, 2, None]
    x = fx * verts_cam[..., 0] / zsafe + cx
    y = fy * verts_cam[..., 1] / zsafe + cy
    return torch.stack([x, y], dim=-1), z


def _gather_faces(attrs: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(N, V, C) per-vertex values, (N, F, 3) faces -> (N, F, 3, C)."""
    n, f, _ = faces.shape
    idx = faces.long().reshape(n, f * 3, 1).expand(-1, -1, attrs.shape[-1])
    return torch.gather(attrs, 1, idx).reshape(n, f, 3, attrs.shape[-1])


def gather_tri(xy: torch.Tensor, z: torch.Tensor, faces: torch.Tensor):
    """Screen corners (N, F, 3, 2) and corner depths (N, F, 3)."""
    return _gather_faces(xy, faces), _gather_faces(z[..., None], faces)[..., 0]


def gather_corner_attrs(attrs: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Per-vertex attributes (N, V, C) -> per-face corners (N, F, 3, C)."""
    return _gather_faces(attrs, faces)
