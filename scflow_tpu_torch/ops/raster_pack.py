"""Face packing and tile binning ahead of the raster kernels (plain PyTorch).

Ports of scflow_tpu/ops/pallas/rasterize.py: `pick_face_chunk`,
`_face_plane_coeffs`, `pack_faces_and_bin` and `pack_shaded_and_bin` (faces
sorted by the tile of their bbox centre, chunk-bbox activity per tile; the
input of kernels K2, K4 and K5/K6) and `pack_shaded_exact` (one entry per
covered tile, sorted by tile, plus an overflow segment; the input of K3).
The JAX module's `SCFLOW_PACK_SORT` knob picks between two sorts that give
bit-identical packs; the port keeps the one sort.
"""

import math

import torch

# screen-space winding sign of a front face (x right, y down, +z into the
# scene) for the mesh banks' outward winding; see the reference module
FRONT_FACE_DET_SIGN = -1.0
SORT_MODES = ("fused", "two_op")


def id_bits_for(num_faces: int) -> int:
    """Low key bits that hold the sorted face (or entry) id."""
    return max(1, math.ceil(math.log2(max(num_faces, 2))))


def pick_face_chunk(num_faces: int, max_fc: int = 512) -> int:
    """Face-chunk size of the binned kernels: a multiple of 128, at most
    max_fc."""
    return min(max_fc, ((num_faces + 127) // 128) * 128)


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


def _bbox(tri_xy):
    """Per-face screen bbox: xmin, xmax, ymin, ymax, each (N, F)."""
    x, y = tri_xy[..., 0], tri_xy[..., 1]
    return x.amin(dim=2), x.amax(dim=2), y.amin(dim=2), y.amax(dim=2)


def _chunk_tile_activity(xmin, xmax, ymin, ymax, fc, ty, tx, th, tw):
    """(N, TY, TX, NC) int32: does chunk c's bbox (the union of its faces'
    bboxes) touch tile (ty, tx)?"""
    n, f = xmin.shape
    nc = f // fc
    cxmin = xmin.reshape(n, nc, fc).amin(2)
    cxmax = xmax.reshape(n, nc, fc).amax(2)
    cymin = ymin.reshape(n, nc, fc).amin(2)
    cymax = ymax.reshape(n, nc, fc).amax(2)
    tile_x0 = (torch.arange(tx, device=xmin.device) * tw)[None, :, None]
    tile_y0 = (torch.arange(ty, device=xmin.device) * th)[None, :, None]
    hit_x = (cxmax[:, None] >= tile_x0) & (cxmin[:, None] <= tile_x0 + tw - 1)
    hit_y = (cymax[:, None] >= tile_y0) & (cymin[:, None] <= tile_y0 + th - 1)
    return (hit_y[:, :, None, :] & hit_x[:, None, :, :]).to(torch.int32)


def pack_faces_and_bin(tri_xy, tri_z, face_valid, h: int, w: int, th: int, tw: int,
                       fc: int, extra_cols=None, cull_backfaces: bool = False):
    """Sort the faces by the tile of their bbox centre (stable; invalid
    faces last), pack the per-face rows and mark which face chunks touch
    which tile; extra_cols (N, E, F) ride the same sort.  Returns rows
    (N, 16, F') [E0 (3), E1 (3), Z (3), sorted id, valid, zeros], active
    (N, H/th, W/tw, F'/fc) int32, perm (N, F') sorted -> original face
    index, and, when extra_cols is given, the sorted extra_cols (N, E, F');
    F' is F padded to a multiple of fc."""
    n, f = face_valid.shape
    pad = (-f) % fc
    if pad:
        tri_xy = torch.cat([tri_xy, tri_xy.new_zeros((n, pad, 3, 2))], dim=1)
        tri_z = torch.cat([tri_z, tri_z.new_zeros((n, pad, 3))], dim=1)
        face_valid = torch.cat([face_valid, face_valid.new_zeros((n, pad))], dim=1)
        if extra_cols is not None:
            extra_cols = torch.cat(
                [extra_cols, extra_cols.new_zeros((n, extra_cols.shape[1], pad))], dim=2)
        f += pad
    ty, tx = h // th, w // tw

    xmin, xmax, ymin, ymax = _bbox(tri_xy)
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
    ]
    if extra_cols is not None:
        cols += list(extra_cols.unbind(1))
    perm = torch.sort(key, dim=1, stable=True).indices
    payload = torch.stack(cols, dim=-1)  # (N, F, C) face-major
    s = torch.gather(payload, 1, perm[..., None].expand(-1, -1, payload.shape[-1])).unbind(-1)

    sorted_id = torch.arange(f, dtype=torch.float32, device=key.device).expand(n, f)
    zeros = tri_z.new_zeros((n, f))
    rows = torch.stack(list(s[0:9]) + [sorted_id, s[9]] + [zeros] * 5, dim=1)
    active = _chunk_tile_activity(*s[10:14], fc, ty, tx, th, tw)
    if extra_cols is None:
        return rows, active, perm.to(torch.int32)
    return rows, active, perm.to(torch.int32), torch.stack(s[14:], dim=1)


def _attr_cols(corner_attrs):
    """(N, F, 3, 6) per-corner [normal, colour] -> (N, F, 18): the 9
    corner-major normal components, then the 9 colour components."""
    n, f0 = corner_attrs.shape[:2]
    ca = corner_attrs.reshape(n, f0, 3, 6)
    return torch.cat([ca[..., 0:3].reshape(n, f0, 9), ca[..., 3:6].reshape(n, f0, 9)], dim=-1)


def pack_shaded_and_bin(tri_xy, tri_z, face_valid, corner_attrs, h: int, w: int,
                        th: int, tw: int, fc: int, cull_backfaces: bool = False):
    """pack_faces_and_bin plus the corner attributes the shaded kernels
    read: rows 11-19 corner-major normals, 20-28 colours.  corner_attrs is
    (N, F, 3, 6) per-corner [normal, colour].  Returns (rows (N, 32, F'),
    active, perm)."""
    n = face_valid.shape[0]
    rows16, active, perm, attr_rows = pack_faces_and_bin(
        tri_xy, tri_z, face_valid, h, w, th, tw, fc,
        extra_cols=_attr_cols(corner_attrs).transpose(1, 2), cull_backfaces=cull_backfaces)
    f = perm.shape[1]
    rows = torch.cat([rows16[:, :11], attr_rows, rows16.new_zeros((n, 3, f))], dim=1)
    return rows.contiguous(), active, perm


def pack_shaded_exact(tri_xy, tri_z, face_valid, corner_attrs, h: int, w: int, th: int,
                      tw: int, fc: int, dup: int = 8, sort_mode: str = "fused",
                      cull_backfaces: bool = False):
    """Exact per-tile binning by bounded face duplication (the input of
    K3).  Each live face emits one entry per tile its bbox covers (row-major
    over its tile span, at most `dup`); entries sort by tile, so a tile's
    work is one contiguous chunk range.  A face spanning more than `dup`
    tiles emits one entry keyed T + its centre tile (the overflow segment,
    evaluated through chunk-bbox activity lists); dead faces and unused
    slots are keyed DEAD = 2T and sort last, outside every range.

    sort_mode 'fused' sorts one int32 key << fbits | face id (when it fits
    in 31 bits; otherwise it sorts as 'two_op'), 'two_op' sorts the keys
    stably and carries the face ids.

    Returns rows (N, 32, E) (row 9 the sorted entry id), seg_start,
    seg_count and ov_counts (N, TY, TX) int32, ov_order (N, TY, TX, NOV)
    int32 and perm (N, E) int32, entry -> original face id."""
    if sort_mode not in SORT_MODES:
        raise ValueError(f"sort_mode must be one of {SORT_MODES}, got {sort_mode!r}")
    n, f0 = face_valid.shape
    dev = tri_xy.device
    tyc, txc = h // th, w // tw
    T = tyc * txc
    DEAD = 2 * T
    fbits = id_bits_for(f0)
    fused = sort_mode == "fused" and (2 * T + 1) < (1 << (31 - fbits))

    planes = _face_plane_coeffs(tri_xy, tri_z, face_valid, cull_backfaces=cull_backfaces)
    valid_row = planes[9]
    xmin, xmax, ymin, ymax = _bbox(tri_xy)

    on_screen = (xmax >= 0) & (xmin <= w - 1) & (ymax >= 0) & (ymin <= h - 1)
    alive = (valid_row > 0.5) & on_screen
    tx0 = torch.clamp(torch.floor(xmin / tw), 0, txc - 1).to(torch.int32)
    tx1 = torch.clamp(torch.floor(xmax / tw), 0, txc - 1).to(torch.int32)
    ty0 = torch.clamp(torch.floor(ymin / th), 0, tyc - 1).to(torch.int32)
    ty1 = torch.clamp(torch.floor(ymax / th), 0, tyc - 1).to(torch.int32)
    ncx = tx1 - tx0 + 1
    ndup = ncx * (ty1 - ty0 + 1)
    overflow = alive & (ndup > dup)
    normal = alive & (ndup <= dup)

    # entry keys (N, F, dup): row-major enumeration of the face's tile span
    d = torch.arange(dup, dtype=torch.int32, device=dev)[None, None, :]
    etile = ((ty0[..., None] + d // ncx[..., None]) * txc
             + (tx0[..., None] + d % ncx[..., None]))
    key = torch.where(normal[..., None] & (d < ndup[..., None]), etile,
                      torch.full_like(etile, DEAD))
    # an overflow face: one entry keyed by its centre tile, after every tile
    cy = torch.div(torch.clamp((ymin + ymax) * 0.5, 0, h - 1), th, rounding_mode="floor")
    cx = torch.div(torch.clamp((xmin + xmax) * 0.5, 0, w - 1), tw, rounding_mode="floor")
    ctile = (cy * txc + cx).to(torch.int32)
    key[:, :, 0] = torch.where(overflow, T + ctile, key[:, :, 0])
    fid = torch.arange(f0, dtype=torch.int32, device=dev)[None, :, None].expand(n, f0, dup)

    e = f0 * dup
    pad = (-e) % fc
    key_flat = key.reshape(n, e)
    fid_flat = fid.reshape(n, e)
    if pad:
        key_flat = torch.cat([key_flat, key_flat.new_full((n, pad), DEAD)], dim=1)
        fid_flat = torch.cat([fid_flat, fid_flat.new_zeros((n, pad))], dim=1)
        e += pad
    if fused:
        sc = torch.sort((key_flat << fbits) | fid_flat, dim=1).values
        sk = sc >> fbits
        sfid = sc & ((1 << fbits) - 1)
    else:
        sk, order = torch.sort(key_flat, dim=1, stable=True)
        sfid = torch.gather(fid_flat, 1, order)

    # per-face data rows gathered by the sorted entries' face ids
    fdata = torch.cat([torch.stack(planes, dim=-1), _attr_cols(corner_attrs),
                       torch.stack([xmin, xmax, ymin, ymax], dim=-1)], dim=-1)  # (N, F, 32)
    sfdT = torch.gather(fdata, 1, sfid.long()[..., None].expand(-1, -1, 32)).transpose(1, 2)
    entry_id = torch.arange(e, dtype=torch.float32, device=dev).expand(n, 1, e)
    rows = torch.cat([sfdT[:, 0:9], entry_id, sfdT[:, 9:10], sfdT[:, 10:28],
                      sfdT.new_zeros((n, 3, e))], dim=1).contiguous()  # (N, 32, E)

    # each tile's contiguous chunk range from its segment of the sorted keys
    tiles = torch.arange(T + 1, dtype=torch.int32, device=dev).expand(n, T + 1).contiguous()
    bounds = torch.searchsorted(sk.contiguous(), tiles)  # left side
    start, end = bounds[:, :-1], bounds[:, 1:]
    seg_start = (start // fc).reshape(n, tyc, txc).to(torch.int32)
    seg_count = torch.where(end > start, (end - 1) // fc - start // fc + 1,
                            torch.zeros_like(start)).reshape(n, tyc, txc).to(torch.int32)

    # overflow chunks: chunk-bbox activity over the overflow entries only;
    # the other entries get inverted bboxes, so they never widen a chunk's
    is_ov = (sk >= T) & (sk < 2 * T)
    big = torch.full_like(sfdT[:, 28], 1e9)
    active_ov = _chunk_tile_activity(
        torch.where(is_ov, sfdT[:, 28], big), torch.where(is_ov, sfdT[:, 29], -big),
        torch.where(is_ov, sfdT[:, 30], big), torch.where(is_ov, sfdT[:, 31], -big),
        fc, tyc, txc, th, tw)
    # at most f0 overflow entries (one per face) span at most f0/fc + 2 chunks
    nov = min(e // fc, f0 // fc + 2)
    ov_order = torch.sort(-active_ov, dim=-1, stable=True).indices[..., :nov]
    ov_counts = torch.clamp(active_ov.sum(dim=-1), max=nov)
    return (rows, seg_start, seg_count, ov_counts.to(torch.int32),
            ov_order.to(torch.int32).contiguous(), sfid)
