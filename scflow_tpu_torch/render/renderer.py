"""Batched renderer: (R, t, K, labels) -> images, depths, masks.

Port of scflow_tpu/render/renderer.py::render_batch on its fused-kernel
branch (`_render_pallas`, raster version 3): project, gather corners, pack
and bin the faces, rasterize with kernel K2, then Phong-light each pixel
with the surface point rebuilt from the depth ray.  The brute-force
rasterizer the JAX package uses for other crop sizes is not ported, so a
crop whose height is not a multiple of 8 or width not a multiple of 128
raises.
"""

from typing import Dict

import torch

from scflow_tpu_torch.ops.cuda.rasterize import (TH, TW, id_bits_for,
                                                 pack_shaded_and_bin,
                                                 rasterize_shaded_v3)
from scflow_tpu_torch.render.rasterizer import (gather_corner_attrs, gather_tri,
                                                project_to_screen)
from scflow_tpu_torch.render.shading import phong_lighting


def render_batch(
    bank_verts: torch.Tensor,  # (C, V, 3)
    bank_faces: torch.Tensor,  # (C, F, 3)
    bank_face_valid: torch.Tensor,  # (C, F)
    bank_colors: torch.Tensor,  # (C, V, 3)
    bank_normals: torch.Tensor,  # (C, V, 3)
    bank_vert_valid: torch.Tensor,  # (C, V)
    rotations: torch.Tensor,  # (N, 3, 3)
    translations: torch.Tensor,  # (N, 3)
    K: torch.Tensor,  # (N, 3, 3)
    labels: torch.Tensor,  # (N,)
    h: int,
    w: int,
    cull_backfaces: bool = False,
) -> Dict[str, torch.Tensor]:
    """Returns images (N, H, W, 3) in [0, 1], depths (N, H, W) (0 off the
    object) and masks (N, H, W).  cull_backfaces is for closed, consistently
    wound meshes only: it drops faces that cannot win the depth test."""
    if h % TH or w % TW:
        raise ValueError(f"the raster kernel tiles the crop as {TH}x{TW}; "
                         f"a {h}x{w} crop is not supported")
    labels = labels.long()
    verts = bank_verts[labels]
    faces = bank_faces[labels]
    face_valid = bank_face_valid[labels]
    colors = bank_colors[labels]
    normals = bank_normals[labels]
    vert_valid = bank_vert_valid[labels]

    verts_cam = torch.einsum("nij,nvj->nvi", rotations, verts) + translations[:, None]
    normals_cam = torch.einsum("nij,nvj->nvi", rotations, normals)

    # one point light per object at R @ (0, 0, max(znear - 400, 0)) in the
    # world frame; the camera-frame light is R @ that + t, so R is applied
    # twice.  That is the reference's own placement, kept knowingly.
    z = torch.where(vert_valid, verts_cam[..., 2], torch.full_like(verts_cam[..., 2], float("inf")))
    lz = torch.clamp(z.amin(dim=1) - 400.0, min=0.0)
    light_local = torch.stack([torch.zeros_like(lz), torch.zeros_like(lz), lz], dim=-1)
    light_world = torch.einsum("nij,nj->ni", rotations, light_local)
    light_cam = torch.einsum("nij,nj->ni", rotations, light_world) + translations

    xy, zv = project_to_screen(verts_cam, K)
    tri_xy, tri_z = gather_tri(xy, zv, faces)
    corner_attrs = gather_corner_attrs(torch.cat([normals_cam, colors], dim=-1), faces)
    rows, active, _ = pack_shaded_and_bin(tri_xy, tri_z, face_valid, corner_attrs,
                                          h, w, cull_backfaces=cull_backfaces)
    maps = rasterize_shaded_v3(rows, active, h, w, id_bits_for(rows.shape[-1]))

    depths = maps[:, 0]
    fg = maps[:, 1] > 0.5
    nrm = maps[:, 3:6].permute(0, 2, 3, 1)
    texel = maps[:, 6:9].permute(0, 2, 3, 1)
    ys = torch.arange(h, dtype=depths.dtype, device=depths.device)
    xs = torch.arange(w, dtype=depths.dtype, device=depths.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    homo = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    rays = torch.einsum("nij,hwj->nhwi", torch.linalg.inv(K), homo)
    images = phong_lighting(rays * depths[..., None], nrm, texel, light_cam, fg)
    return {"images": images, "depths": depths, "masks": fg.to(images.dtype)}
