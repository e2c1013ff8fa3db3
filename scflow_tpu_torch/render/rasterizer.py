"""Batched z-buffer triangle rasterizer: port of scflow_tpu/render/rasterizer.py.

Two backends give the same fragments (see device.resolve_backend):
- 'xla', the brute-force tensor path: every face against every pixel as a
  min over packed (z bits | face id) keys, in plain PyTorch, chunked over
  faces so that the (N, faces, H*W) volume stays bounded;
- 'pallas', the tile-binned path: pack_faces_and_bin, then kernel K4
  (`rasterize_packed`) for the winner keys, mapped back to original faces.
Either way a second pass gathers each winner's corners and recomputes exact
barycentrics and camera-space z.  Outputs: camera z (0 = background), face
id (-1 = background), screen-space barycentrics.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from scflow_tpu_torch.device import resolve_backend
from scflow_tpu_torch.ops.cuda.rasterize import INT32_MAX, rasterize_packed
from scflow_tpu_torch.ops.raster_pack import (FRONT_FACE_DET_SIGN, id_bits_for,
                                              pack_faces_and_bin, pick_face_chunk)

# most (image, face, pixel) elements one chunk of the brute-force pass
# holds in each of its temporaries
XLA_CHUNK_ELEMENTS = 1 << 24


class Fragments(NamedTuple):
    zbuf: torch.Tensor  # (N, H, W) camera-space depth, 0 = background
    face_id: torch.Tensor  # (N, H, W) int32, -1 = background
    bary: torch.Tensor  # (N, H, W, 3)


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


def _bary(px, py, x0, y0, x1, y1, x2, y2):
    """Barycentric coords of pixels (px, py) in the triangle; broadcasts."""
    det = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
    det_ok = torch.abs(det) > 1e-9
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    w0 = ((y1 - y2) * (px - x2) + (x2 - x1) * (py - y2)) / det_safe
    w1 = ((y2 - y0) * (px - x2) + (x0 - x2) * (py - y2)) / det_safe
    w2 = 1.0 - w0 - w1
    return w0, w1, w2, det_ok


def _depth_pass(tri_xy, tri_z, face_valid, px, py, id_mask: int,
                cull_backfaces: bool = False) -> torch.Tensor:
    """(N, HW) least packed (z bits | face id) key over all faces, INT32_MAX
    where none covers; faces in chunks of XLA_CHUNK_ELEMENTS / (N * HW)."""
    n, f = face_valid.shape
    step = max(1, XLA_CHUNK_ELEMENTS // max(1, n * px.shape[0]))
    best = torch.full((n, px.shape[0]), INT32_MAX, dtype=torch.int32, device=px.device)
    big = torch.tensor(INT32_MAX, dtype=torch.int32, device=px.device)
    for f0 in range(0, f, step):
        a = tri_xy[:, f0:f0 + step, :, :, None]  # broadcast against pixels
        x0, y0 = a[:, :, 0, 0], a[:, :, 0, 1]
        x1, y1 = a[:, :, 1, 0], a[:, :, 1, 1]
        x2, y2 = a[:, :, 2, 0], a[:, :, 2, 1]
        w0, w1, w2, det_ok = _bary(px, py, x0, y0, x1, y1, x2, y2)
        tz = tri_z[:, f0:f0 + step]
        zpix = w0 * tz[:, :, 0, None] + w1 * tz[:, :, 1, None] + w2 * tz[:, :, 2, None]
        front = tz.amin(dim=2)[:, :, None] > 1e-6
        cover = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0) & det_ok & front
                 & face_valid[:, f0:f0 + step, None])
        if cull_backfaces:
            det = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
            cover = cover & (det * FRONT_FACE_DET_SIGN > 0)
        zbits = torch.clamp(zpix, min=1e-6).view(torch.int32)
        fid = torch.arange(f0, f0 + tz.shape[1], dtype=torch.int32, device=px.device)
        packed = (zbits & ~id_mask) | fid[None, :, None]
        best = torch.minimum(best, torch.where(cover, packed, big).amin(dim=1))
    return best


def rasterize(verts_cam: torch.Tensor, faces: torch.Tensor, face_valid: torch.Tensor,
              K: torch.Tensor, h: int, w: int, chunk: Optional[int] = None,
              backend: str = "xla", cull_backfaces: bool = False) -> Fragments:
    """verts_cam (N, V, 3) camera-frame vertices, faces (N, F, 3), face_valid
    (N, F), K (N, 3, 3) -> Fragments at h x w.  chunk is accepted for the
    JAX package's signature and unused.  cull_backfaces is for closed,
    consistently wound meshes only."""
    backend = resolve_backend(backend, verts_cam.device)
    xy, z = project_to_screen(verts_cam, K)
    n, f, _ = faces.shape
    tri_xy, tri_z = gather_tri(xy, z, faces)
    gy, gx = torch.meshgrid(torch.arange(h, dtype=xy.dtype, device=xy.device),
                            torch.arange(w, dtype=xy.dtype, device=xy.device), indexing="ij")
    px, py = gx.reshape(-1), gy.reshape(-1)

    if backend == "pallas":
        fc = pick_face_chunk(f)
        th = 8 if h % 8 == 0 else h
        tw = 128 if w % 128 == 0 else w
        rows, active, perm = pack_faces_and_bin(tri_xy, tri_z, face_valid, h, w, th, tw, fc,
                                                cull_backfaces=cull_backfaces)
        id_bits = id_bits_for(rows.shape[-1])
        win = rasterize_packed(rows, active, h, w, th=th, tw=tw, fc=fc,
                               id_bits=id_bits).reshape(n, h * w)
        background = win == INT32_MAX
        fid_sorted = torch.where(background, 0, win & ((1 << id_bits) - 1))
        # the sorted face index back to the original face order
        fid = torch.gather(perm, 1, fid_sorted.long())
        fid = torch.where(background, -1, fid)
    else:
        id_mask = (1 << id_bits_for(f)) - 1
        win = _depth_pass(tri_xy, tri_z, face_valid, px, py, id_mask,
                          cull_backfaces=cull_backfaces)
        background = win == INT32_MAX
        fid = torch.where(background, -1, win & id_mask)

    # pass 2: exact z and barycentrics of each pixel's winner
    safe = torch.clamp(fid, min=0).long()
    wxy = torch.gather(tri_xy.reshape(n, f, 6), 1, safe[..., None].expand(-1, -1, 6))
    wz = torch.gather(tri_z, 1, safe[..., None].expand(-1, -1, 3))
    w0e, w1e, w2e, _ = _bary(px[None], py[None], wxy[..., 0], wxy[..., 1], wxy[..., 2],
                             wxy[..., 3], wxy[..., 4], wxy[..., 5])
    z_exact = w0e * wz[..., 0] + w1e * wz[..., 1] + w2e * wz[..., 2]
    zero = torch.zeros_like(z_exact)
    bary = torch.stack([torch.where(background, zero, b) for b in (w0e, w1e, w2e)], dim=-1)
    return Fragments(zbuf=torch.where(background, zero, z_exact).reshape(n, h, w),
                     face_id=fid.to(torch.int32).reshape(n, h, w),
                     bary=bary.reshape(n, h, w, 3))
