"""Kernel K2: tile-binned shaded rasterizer (csrc/rasterize_v3.cu), and the
face packing that feeds it.

Ports of scflow_tpu/ops/pallas/rasterize.py: `_face_plane_coeffs`,
`pack_faces_and_bin`, `pack_shaded_and_bin` (plain PyTorch: a stable sort of
the faces by tile, a row gather, the chunk-bbox activity) and
`rasterize_shaded_pallas_v3` (`rasterize_shaded_v3`: the CUDA kernel for
CUDA tensors, the plain version `rasterize_shaded_v3_plain` for CPU ones).
"""

import ctypes
import math

import torch

from scflow_tpu_torch.ops.cuda.build import CudaKernel

INT32_MAX = 2**31 - 1
# screen-space winding sign of a front face (x right, y down, +z into the
# scene) for the mesh banks' outward winding; see the reference module
FRONT_FACE_DET_SIGN = -1.0
# tile and face-chunk shape compiled into the kernel
TH, TW, FC = 8, 128, 128

KERNEL = CudaKernel(
    "rasterize_v3.cu", "raster_v3_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6,
)


def id_bits_for(num_faces: int) -> int:
    """Low key bits that hold the sorted face id (renderer.py's rule)."""
    return max(1, math.ceil(math.log2(max(num_faces, 2))))


def _face_plane_coeffs(tri_xy, tri_z, face_valid, cull_backfaces=False):
    """Per-face affine coefficients of w0, w1 and z in screen space, with
    validity (orientation, |det| > 1e-9, min corner z > 1e-6, and optionally
    the front-face winding) folded in: an invalid face gets w0 == -1 at
    every pixel.  Returns 10 (N, F) tensors, the last the valid row."""
    ax, ay = tri_xy[:, :, 0, 0], tri_xy[:, :, 0, 1]
    bx, by = tri_xy[:, :, 1, 0], tri_xy[:, :, 1, 1]
    ccx, ccy = tri_xy[:, :, 2, 0], tri_xy[:, :, 2, 1]
    z0, z1, z2 = tri_z[:, :, 0], tri_z[:, :, 1], tri_z[:, :, 2]
    det = (by - ccy) * (ax - ccx) + (ccx - bx) * (ay - ccy)
    det_ok = torch.abs(det) > 1e-9
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    e0x = (by - ccy) * inv_det
    e0y = (ccx - bx) * inv_det
    e0c = -(e0x * ccx + e0y * ccy)
    e1x = (ccy - ay) * inv_det
    e1y = (ax - ccx) * inv_det
    e1c = -(e1x * ccx + e1y * ccy)
    dz0, dz1 = z0 - z2, z1 - z2
    zx = e0x * dz0 + e1x * dz1
    zy = e0y * dz0 + e1y * dz1
    zc = z2 + e0c * dz0 + e1c * dz1
    front = torch.minimum(torch.minimum(z0, z1), z2) > 1e-6
    ok = face_valid & det_ok & front
    if cull_backfaces:
        ok = ok & (det * FRONT_FACE_DET_SIGN > 0)
    zero = torch.zeros_like(e0x)
    coeffs = [torch.where(ok, v, zero) for v in (e0x, e0y)]
    coeffs.append(torch.where(ok, e0c, torch.full_like(e0c, -1.0)))
    coeffs += [torch.where(ok, v, zero) for v in (e1x, e1y, e1c, zx, zy, zc)]
    return (*coeffs, ok.to(torch.float32))


def pack_faces_and_bin(tri_xy, tri_z, face_valid, extra_cols, h: int, w: int,
                       cull_backfaces: bool = False):
    """Sort the faces by the tile of their bbox centre (stable; invalid
    faces last), pack the per-face rows and mark which face chunks touch
    which tile; extra_cols (N, E, F) ride the same sort.  Returns (rows
    (N, 16, F'), active (N, TY, TX, NC) int32, perm (N, F') sorted ->
    original face index, sorted extra_cols (N, E, F')), F' padded to a
    multiple of FC."""
    th, tw, fc = TH, TW, FC
    n, f = face_valid.shape
    pad = (-f) % fc
    if pad:
        tri_xy = torch.cat([tri_xy, tri_xy.new_zeros((n, pad, 3, 2))], dim=1)
        tri_z = torch.cat([tri_z, tri_z.new_zeros((n, pad, 3))], dim=1)
        face_valid = torch.cat([face_valid, face_valid.new_zeros((n, pad))], dim=1)
        extra_cols = torch.cat(
            [extra_cols, extra_cols.new_zeros((n, extra_cols.shape[1], pad))], dim=2)
        f += pad
    ty, tx = h // th, w // tw

    xmin = tri_xy[..., 0].amin(dim=2)
    xmax = tri_xy[..., 0].amax(dim=2)
    ymin = tri_xy[..., 1].amin(dim=2)
    ymax = tri_xy[..., 1].amax(dim=2)

    planes = _face_plane_coeffs(tri_xy, tri_z, face_valid, cull_backfaces)
    if cull_backfaces:
        # culled faces also leave the tile sort and the chunk bboxes
        face_valid = face_valid & (planes[9] > 0.5)

    cy = torch.div(torch.clamp((ymin + ymax) * 0.5, 0, h - 1), th, rounding_mode="floor")
    cx = torch.div(torch.clamp((xmin + xmax) * 0.5, 0, w - 1), tw, rounding_mode="floor")
    key = torch.where(face_valid, cy * tx + cx, torch.full_like(cy, 1e9))
    big = torch.full_like(xmin, 1e9)
    cols = list(planes) + [
        torch.where(face_valid, xmin, big), torch.where(face_valid, xmax, -big),
        torch.where(face_valid, ymin, big), torch.where(face_valid, ymax, -big),
    ] + list(extra_cols.unbind(1))
    perm = torch.sort(key, dim=1, stable=True).indices
    payload = torch.stack(cols, dim=-1)  # (N, F, C) face-major
    s = torch.gather(payload, 1, perm[..., None].expand(-1, -1, payload.shape[-1]))
    s = s.unbind(-1)
    xmin, xmax, ymin, ymax = s[10:14]

    sorted_id = torch.arange(f, dtype=torch.float32, device=key.device).expand(n, f)
    zeros = tri_z.new_zeros((n, f))
    rows = torch.stack(list(s[0:9]) + [sorted_id, s[9]] + [zeros] * 5, dim=1)

    nc = f // fc
    cxmin = xmin.reshape(n, nc, fc).amin(2)
    cxmax = xmax.reshape(n, nc, fc).amax(2)
    cymin = ymin.reshape(n, nc, fc).amin(2)
    cymax = ymax.reshape(n, nc, fc).amax(2)
    tile_x0 = (torch.arange(tx, device=key.device) * tw)[None, :, None]
    tile_y0 = (torch.arange(ty, device=key.device) * th)[None, :, None]
    hit_x = (cxmax[:, None] >= tile_x0) & (cxmin[:, None] <= tile_x0 + tw - 1)
    hit_y = (cymax[:, None] >= tile_y0) & (cymin[:, None] <= tile_y0 + th - 1)
    active = (hit_y[:, :, None, :] & hit_x[:, None, :, :]).to(torch.int32)
    return rows, active, perm.to(torch.int32), torch.stack(s[14:], dim=1)


def pack_shaded_and_bin(tri_xy, tri_z, face_valid, corner_attrs, h: int, w: int,
                        cull_backfaces: bool = False):
    """pack_faces_and_bin plus the corner attributes the shaded kernel
    reads: rows 11-19 corner-major normals, 20-28 colours.  corner_attrs is
    (N, F, 3, 6) per-corner [normal, colour].  Returns (rows (N, 32, F'),
    active, perm)."""
    n, f0 = face_valid.shape
    ca = corner_attrs.reshape(n, f0, 3, 6)
    attr_cols = torch.cat([ca[..., 0:3].reshape(n, f0, 9),
                           ca[..., 3:6].reshape(n, f0, 9)], dim=-1).transpose(1, 2)
    rows16, active, perm, attr_rows = pack_faces_and_bin(
        tri_xy, tri_z, face_valid, attr_cols, h, w, cull_backfaces=cull_backfaces)
    f = perm.shape[1]
    rows = torch.cat([rows16[:, :11], attr_rows, rows16.new_zeros((n, 3, f))], dim=1)
    return rows.contiguous(), active, perm


def _emit_maps(rec, fg, px, py):
    """The 16 output maps from each pixel's winner record (32, P) and mask,
    in the reference's arithmetic order."""
    fgf = fg.to(torch.float32)
    w0 = rec[0] * px + rec[1] * py + rec[2]
    w1 = rec[3] * px + rec[4] * py + rec[5]
    w2 = 1.0 - w0 - w1
    z = rec[6] * px + rec[7] * py + rec[8]
    out = [z * fgf, fgf, rec[9]]
    for base in (11, 20):  # normals, colours
        for a in range(3):
            out.append(w0 * rec[base + a] + w1 * rec[base + 3 + a] + w2 * rec[base + 6 + a])
    out += [w0 * fgf, w1 * fgf, w2 * fgf]
    out += [torch.zeros_like(z)] * (16 - len(out))
    return torch.stack(out, dim=0)


def rasterize_shaded_v3_plain(rows: torch.Tensor, active: torch.Tensor, h: int,
                              w: int, id_bits: int) -> torch.Tensor:
    """Every face chunk against every pixel of an image, keeping each
    pixel's least key among the faces of chunks active for its tile: the
    same keys, winners and maps as the kernel.  Loops over images and
    chunks to bound memory."""
    th, tw, fc = TH, TW, FC
    n, _, f = rows.shape
    nc = f // fc
    id_mask = (1 << id_bits) - 1
    dev = rows.device
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    py = ys[:, None].expand(h, w).reshape(-1).to(torch.float32)
    px = xs[None, :].expand(h, w).reshape(-1).to(torch.float32)
    tile = ((ys // th)[:, None] * (w // tw) + (xs // tw)[None, :]).reshape(-1)
    act = active.reshape(n, -1, nc).bool()
    maps = torch.empty((n, 16, h * w), dtype=torch.float32, device=dev)
    big = torch.tensor(INT32_MAX, dtype=torch.int32, device=dev)
    for i in range(n):
        best = torch.full((h * w,), INT32_MAX, dtype=torch.int32, device=dev)
        pix_act = act[i][tile]  # (HW, NC)
        for c in range(nc):
            blk = rows[i, :10, c * fc:(c + 1) * fc, None]  # (10, FC, 1)
            w0 = blk[0] * px + blk[1] * py + blk[2]
            w1 = blk[3] * px + blk[4] * py + blk[5]
            z = blk[6] * px + blk[7] * py + blk[8]
            w2 = 1.0 - w0 - w1
            cover = torch.minimum(torch.minimum(w0, w1), w2) >= 0
            zbits = torch.clamp(z, min=1e-6).view(torch.int32)
            key = (zbits & ~id_mask) | blk[9].to(torch.int32)
            key = torch.where(cover & pix_act[None, :, c], key, big)
            best = torch.minimum(best, key.amin(dim=0))
        fg = best != INT32_MAX
        rec = rows[i][:, torch.where(fg, best & id_mask, 0).long()]  # (32, HW)
        rec = torch.where(fg[None], rec, torch.zeros_like(rec))
        maps[i] = _emit_maps(rec, fg, px, py)
    return maps.reshape(n, 16, h, w)


def rasterize_shaded_v3(rows: torch.Tensor, active: torch.Tensor, h: int, w: int,
                        id_bits: int) -> torch.Tensor:
    """rows (N, 32, F') float32 and active (N, H/8, W/128, F'/128) int32 from
    pack_shaded_and_bin -> maps (N, 16, H, W) float32: z*fg, fg, sorted id,
    normal (3), colour (3), barycentrics*fg (3), zeros."""
    if rows.device.type == "cpu":
        return rasterize_shaded_v3_plain(rows, active, h, w, id_bits)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    n, nrows, f = rows.shape
    nc = f // FC
    if nrows != 32 or f % FC or h % TH or w % TW:
        raise ValueError(f"rows (N, 32, k*{FC}) and an image of (8i, 128j) "
                         f"pixels needed, got rows {tuple(rows.shape)}, {h}x{w}")
    if active.shape != (n, h // TH, w // TW, nc):
        raise ValueError(f"active must be {(n, h // TH, w // TW, nc)}, got "
                         f"{tuple(active.shape)}")
    if f > 1 << id_bits or not 0 < n <= 65535:
        raise ValueError(f"{f} faces need more than {id_bits} id bits, or "
                         f"batch {n} is out of range")
    if (rows.dtype != torch.float32 or active.dtype != torch.int32
            or active.device != rows.device
            or not (rows.is_contiguous() and active.is_contiguous())):
        raise ValueError("rasterize_shaded_v3 needs contiguous float32 rows and "
                         "int32 active on one device")
    out = torch.empty((n, 16, h, w), dtype=torch.float32, device=rows.device)
    KERNEL.launch(rows.device, rows.data_ptr(), active.data_ptr(), out.data_ptr(),
                  n, f, h, w, nc, (1 << id_bits) - 1)
    return out
