"""Per-pixel Phong lighting (port of scflow_tpu/render/shading.py::
phong_lighting; pytorch3d's HardPhongShader light model)."""

import torch

# pytorch3d PointLights defaults, which the reference's default lights use,
# and the reference renderer's background (configs/refine_datasets/ycbv_real.py)
AMBIENT, DIFFUSE, SPECULAR, SHININESS = 0.5, 0.3, 0.2, 64.0
BACKGROUND = (0.5, 0.5, 0.5)


def _normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def phong_lighting(
    pos: torch.Tensor,  # (N, H, W, 3) camera-frame surface positions
    nrm: torch.Tensor,  # (N, H, W, 3), need not be unit
    texel: torch.Tensor,  # (N, H, W, 3)
    light_pos_cam: torch.Tensor,  # (N, 3)
    fg_mask: torch.Tensor,  # (N, H, W) bool
) -> torch.Tensor:
    """color = texel (ambient + diffuse max(0, n.l)) + specular max(0, r.v)^s,
    background colour off the mask, clipped to [0, 1]."""
    nrm = _normalize(nrm)
    l = _normalize(light_pos_cam[:, None, None, :] - pos)
    v = _normalize(-pos)
    facing = torch.sum(nrm * v, dim=-1, keepdim=True) < 0
    nrm = nrm * torch.where(facing, -1.0, 1.0)
    ndl = torch.clamp(torch.sum(nrm * l, dim=-1, keepdim=True), min=0.0)
    r = 2.0 * ndl * nrm - l
    rdv = torch.clamp(torch.sum(r * v, dim=-1, keepdim=True), min=0.0)
    spec = SPECULAR * torch.where(ndl > 0, rdv**SHININESS, torch.zeros_like(rdv))
    rgb = texel * (AMBIENT + DIFFUSE * ndl) + spec
    bg = torch.tensor(BACKGROUND, dtype=rgb.dtype, device=rgb.device)
    rgb = torch.where(fg_mask[..., None], rgb, bg)
    return torch.clamp(rgb, 0.0, 1.0)
