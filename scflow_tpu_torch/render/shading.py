"""Phong, flat and Gouraud shading of rasterized fragments: port of
scflow_tpu/render/shading.py (pytorch3d's Hard{Phong,Flat,Gouraud}Shader
light model):
  color = texel (ambient + diffuse max(0, n.l)) + specular max(0, r.v)^s
in the camera frame, with pytorch3d's PointLights defaults."""

from typing import Tuple

import torch

from scflow_tpu_torch.render.rasterizer import Fragments, gather_corner_attrs

# pytorch3d PointLights defaults, which the reference's default lights use,
# and the reference renderer's background (configs/refine_datasets/ycbv_real.py)
AMBIENT, DIFFUSE, SPECULAR, SHININESS = 0.5, 0.3, 0.2, 64.0
BACKGROUND = (0.5, 0.5, 0.5)
SHADING_MODES = ("phong", "flat", "gouraud")


def _normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def interpolate_attributes(fragments: Fragments, faces: torch.Tensor,
                           vert_attr: torch.Tensor) -> torch.Tensor:
    """Barycentric interpolation of per-vertex attributes (N, V, C) ->
    (N, H, W, C); background pixels (face id -1) get zeros."""
    n, h, w = fragments.face_id.shape
    c = vert_attr.shape[-1]
    fa = gather_corner_attrs(vert_attr, faces).reshape(n, faces.shape[1], 3 * c)
    fid = torch.clamp(fragments.face_id.reshape(n, h * w), min=0).long()
    pix = torch.gather(fa, 1, fid[..., None].expand(-1, -1, 3 * c)).reshape(n, h * w, 3, c)
    out = (pix * fragments.bary.reshape(n, h * w, 3)[..., None]).sum(dim=2)
    valid = (fragments.face_id.reshape(n, h * w) >= 0)[..., None]
    return torch.where(valid, out, torch.zeros_like(out)).reshape(n, h, w, c)


def phong_lighting(
    pos: torch.Tensor,  # (N, H, W, 3) camera-frame surface positions
    nrm: torch.Tensor,  # (N, H, W, 3), need not be unit
    texel: torch.Tensor,  # (N, H, W, 3)
    light_pos_cam: torch.Tensor,  # (N, 3)
    fg_mask: torch.Tensor,  # (N, H, W) bool
    ambient: float = AMBIENT,
    diffuse: float = DIFFUSE,
    specular: float = SPECULAR,
    shininess: float = SHININESS,
    background_color: Tuple[float, float, float] = BACKGROUND,
) -> torch.Tensor:
    """Per-pixel Phong colour, the background colour off the mask, clipped
    to [0, 1]."""
    nrm = _normalize(nrm)
    l = _normalize(light_pos_cam[:, None, None, :] - pos)
    v = _normalize(-pos)
    facing = torch.sum(nrm * v, dim=-1, keepdim=True) < 0
    nrm = nrm * torch.where(facing, -1.0, 1.0)
    ndl = torch.clamp(torch.sum(nrm * l, dim=-1, keepdim=True), min=0.0)
    r = 2.0 * ndl * nrm - l
    rdv = torch.clamp(torch.sum(r * v, dim=-1, keepdim=True), min=0.0)
    spec = specular * torch.where(ndl > 0, rdv**shininess, torch.zeros_like(rdv))
    rgb = texel * (ambient + diffuse * ndl) + spec
    bg = torch.tensor(background_color, dtype=rgb.dtype, device=rgb.device)
    rgb = torch.where(fg_mask[..., None], rgb, bg)
    return torch.clamp(rgb, 0.0, 1.0)


def shade_phong(
    fragments: Fragments,
    faces: torch.Tensor,  # (N, F, 3)
    verts_cam: torch.Tensor,  # (N, V, 3)
    normals_cam: torch.Tensor,  # (N, V, 3)
    colors: torch.Tensor,  # (N, V, 3) texel colours in [0, 1]
    light_pos_cam: torch.Tensor,  # (N, 3)
    ambient: float = AMBIENT,
    diffuse: float = DIFFUSE,
    specular: float = SPECULAR,
    shininess: float = SHININESS,
    background_color: Tuple[float, float, float] = BACKGROUND,
    flat_shading: bool = False,
    mode: str = "phong",
) -> torch.Tensor:
    """RGB (N, H, W, 3) in [0, 1].  'phong' lights each pixel with its
    interpolated normal, 'flat' with its face's normal, 'gouraud' lights
    the vertices and interpolates their colours; flat_shading forces
    'flat'."""
    if flat_shading:
        mode = "flat"
    if mode not in SHADING_MODES:
        raise ValueError(f"shading mode must be one of {SHADING_MODES}, got {mode!r}")
    n, h, w = fragments.face_id.shape
    fg = fragments.face_id >= 0
    light = dict(ambient=ambient, diffuse=diffuse, specular=specular, shininess=shininess,
                 background_color=background_color)

    if mode == "gouraud":
        vert_rgb = phong_lighting(
            verts_cam[:, :, None], normals_cam[:, :, None], colors[:, :, None], light_pos_cam,
            torch.ones(verts_cam.shape[:2] + (1,), dtype=torch.bool, device=verts_cam.device),
            **light)[:, :, 0]  # (N, V, 3)
        rgb = interpolate_attributes(fragments, faces, vert_rgb)
        bg = torch.tensor(background_color, dtype=rgb.dtype, device=rgb.device)
        return torch.clamp(torch.where(fg[..., None], rgb, bg), 0.0, 1.0)

    attr = interpolate_attributes(fragments, faces,
                                  torch.cat([verts_cam, normals_cam, colors], dim=-1))
    pos, nrm, texel = attr[..., 0:3], attr[..., 3:6], attr[..., 6:9]
    if mode == "flat":
        v0, v1, v2 = gather_corner_attrs(verts_cam, faces).unbind(2)
        fnrm = torch.linalg.cross(v1 - v0, v2 - v0)  # (N, F, 3)
        fid = torch.clamp(fragments.face_id.reshape(n, h * w), min=0).long()
        nrm = torch.gather(fnrm, 1, fid[..., None].expand(-1, -1, 3)).reshape(n, h, w, 3)
    return phong_lighting(pos, nrm, texel, light_pos_cam, fg, **light)
