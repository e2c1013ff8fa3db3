"""The raster kernels and their plain PyTorch versions.

Ports of scflow_tpu/ops/pallas/rasterize.py's Pallas kernels (their inputs
come from scflow_tpu_torch/ops/raster_pack.py):

  K2 `rasterize_shaded_v3` (csrc/rasterize_v3.cu)     <- rasterize_shaded_pallas_v3
  K3 `rasterize_shaded_v4` (csrc/rasterize_v4.cu)     <- rasterize_shaded_pallas_v4
  K4 `rasterize_packed` (csrc/rasterize_packed.cu)    <- rasterize_packed_pallas
  K5/K6 `rasterize_shaded` (csrc/rasterize_v12.cu)    <- rasterize_shaded_pallas(version=1|2)

Each wrapper runs its plain version (`*_plain`) for CPU tensors; for CUDA
tensors it checks its inputs and launches the kernel, or raises.  The plain
versions repeat the kernels' arithmetic operation for operation, so on the
card kernel and plain version agree bit for bit.
"""

import ctypes

import torch

from scflow_tpu_torch.ops.cuda.build import CudaKernel

INT32_MAX = 2**31 - 1
TH, TW, FC = 8, 128, 128  # K2's tile and face chunk, compiled into its kernel
PIECE = 128  # faces a kernel stages at once; every fc is a multiple of it
_P, _I = ctypes.c_void_p, ctypes.c_int

# K2
V3_KERNEL = CudaKernel("rasterize_v3.cu", "raster_v3_launch", [_P] * 3 + [_I] * 6)
# K3
V4_KERNEL = CudaKernel("rasterize_v4.cu", "raster_v4_launch", [_P] * 6 + [_I] * 9)
# K4
PACKED_KERNEL = CudaKernel("rasterize_packed.cu", "raster_packed_launch", [_P] * 3 + [_I] * 8)
# K5 and K6: one kernel, one launch count per version
V12_KERNELS = {v: CudaKernel("rasterize_v12.cu", "raster_v12_launch", [_P] * 3 + [_I] * 9)
               for v in (1, 2)}


def _pixel_grid(h: int, w: int, th: int, tw: int, dev):
    """Flat (H*W,) pixel x, y (float32) and tile index (row-major tiles)."""
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    py = ys[:, None].expand(h, w).reshape(-1).to(torch.float32)
    px = xs[None, :].expand(h, w).reshape(-1).to(torch.float32)
    tile = ((ys // th)[:, None] * (w // tw) + (xs // tw)[None, :]).reshape(-1)
    return px, py, tile


def _least_keys(rows_i, pix_act, px, py, fc: int, id_mask: int, use_valid: bool):
    """Each pixel's least key over the faces of the chunks active for it:
    rows_i (R, F) one image's rows, pix_act (HW, NC) bool.  Each chunk is
    tested on the pixels it is active for, 128 faces at a time."""
    best = torch.full((px.shape[0],), INT32_MAX, dtype=torch.int32, device=px.device)
    big = torch.tensor(INT32_MAX, dtype=torch.int32, device=px.device)
    for c in range(pix_act.shape[1]):
        sel = pix_act[:, c].nonzero().squeeze(1)
        if sel.numel() == 0:
            continue
        sx, sy = px[sel], py[sel]
        for f0 in range(c * fc, (c + 1) * fc, PIECE):
            blk = rows_i[:11, f0:f0 + PIECE, None]  # (11, PIECE, 1)
            w0 = blk[0] * sx + blk[1] * sy + blk[2]
            w1 = blk[3] * sx + blk[4] * sy + blk[5]
            z = blk[6] * sx + blk[7] * sy + blk[8]
            w2 = 1.0 - w0 - w1
            cover = torch.minimum(torch.minimum(w0, w1), w2) >= 0
            if use_valid:
                cover = cover & (blk[10] > 0.5)
            zbits = torch.clamp(z, min=1e-6).view(torch.int32)
            key = (zbits & ~id_mask) | blk[9].to(torch.int32)
            key = torch.where(cover, key, big).amin(dim=0)
            best[sel] = torch.minimum(best[sel], key)
    return best


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


def _raster_plain(rows, active, h, w, th, tw, fc, id_bits, use_valid, maps):
    """Every image's least keys over its tiles' active chunks; then either
    the keys (N, H, W) or the 16 maps (N, 16, H, W) of the winners.
    active is (N, TY, TX, NC) with any integer or bool type."""
    n = rows.shape[0]
    id_mask = (1 << id_bits) - 1
    px, py, tile = _pixel_grid(h, w, th, tw, rows.device)
    act = active.reshape(n, -1, active.shape[-1]).bool()
    out = []
    for i in range(n):
        best = _least_keys(rows[i], act[i][tile], px, py, fc, id_mask, use_valid)
        if not maps:
            out.append(best.reshape(h, w))
            continue
        fg = best != INT32_MAX
        rec = rows[i][:, torch.where(fg, best & id_mask, 0).long()]  # (32, HW)
        rec = torch.where(fg[None], rec, torch.zeros_like(rec))
        out.append(_emit_maps(rec, fg, px, py).reshape(16, h, w))
    return torch.stack(out)


def rasterize_shaded_v3_plain(rows, active, h: int, w: int, id_bits: int):
    """K2's plain version: the same keys, winners and maps as the kernel."""
    return _raster_plain(rows, active, h, w, TH, TW, FC, id_bits, False, True)


def rasterize_shaded_plain(rows, active, h: int, w: int, th: int, tw: int, fc: int,
                           id_bits: int):
    """K5/K6's plain version (both versions compute these maps)."""
    return _raster_plain(rows, active, h, w, th, tw, fc, id_bits, True, True)


def rasterize_packed_plain(rows, active, h: int, w: int, th: int, tw: int, fc: int,
                           id_bits: int):
    """K4's plain version: least keys (N, H, W) int32."""
    return _raster_plain(rows, active, h, w, th, tw, fc, id_bits, True, False)


def v4_activity(seg_start, seg_count, ov_counts, ov_order, num_chunks: int):
    """(N, TY, TX, NC) bool: the chunks K3 walks for each tile, its
    contiguous range and its overflow list."""
    ch = torch.arange(num_chunks, device=seg_start.device)
    act = (ch >= seg_start[..., None]) & (ch < (seg_start + seg_count)[..., None])
    slot = torch.arange(ov_order.shape[-1], device=ov_order.device)
    listed = slot < ov_counts[..., None]
    ov = torch.zeros(act.shape, dtype=torch.int32, device=act.device)
    ov.scatter_add_(-1, torch.where(listed, ov_order, 0).long().clamp(0, num_chunks - 1),
                    listed.to(torch.int32))
    return act | (ov > 0)


def rasterize_shaded_v4_plain(rows, seg_start, seg_count, ov_counts, ov_order, h: int,
                              w: int, th: int, tw: int, fc: int, id_bits: int):
    """K3's plain version: the maps of the winners among each tile's range
    and overflow chunks (the valid row is not read, as in the kernel)."""
    act = v4_activity(seg_start, seg_count, ov_counts, ov_order, rows.shape[-1] // fc)
    return _raster_plain(rows, act, h, w, th, tw, fc, id_bits, False, True)


def _check(name, rows, nrows, ints, h, w, th, tw, fc, id_bits):
    """Raise unless the kernel takes these inputs: contiguous float32 rows
    (N, nrows, F) and int32 tensors of the given shapes on rows' CUDA
    device, tiles that divide the crop, fc a multiple of 128 that divides F,
    F ids inside id_bits, 0 < N <= 65535."""
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    if rows.dim() != 3 or rows.shape[1] != nrows:
        raise ValueError(f"{name}: rows must be (N, {nrows}, F), got {tuple(rows.shape)}")
    n, _, f = rows.shape
    if (th <= 0 or tw <= 0 or h % th or w % tw or fc <= 0 or fc % PIECE or f % fc
            or (h // th) * (w // tw) > 65535):
        raise ValueError(f"{name}: {th}x{tw} tiles must divide the {h}x{w} crop and fc={fc} "
                         f"(a multiple of {PIECE}) the {f} faces")
    if not 1 <= id_bits <= 30 or f > 1 << id_bits or not 0 < n <= 65535:
        raise ValueError(f"{name}: {f} faces need more than {id_bits} id bits, or batch {n} "
                         "is out of range")
    if rows.dtype != torch.float32 or not rows.is_contiguous():
        raise ValueError(f"{name}: rows must be contiguous float32")
    for label, (t, shape) in ints.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.int32 or t.device != rows.device or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous int32 on {rows.device}")


def rasterize_shaded_v3(rows: torch.Tensor, active: torch.Tensor, h: int, w: int,
                        id_bits: int) -> torch.Tensor:
    """K2.  rows (N, 32, F') float32 and active (N, H/8, W/128, F'/128)
    int32 from pack_shaded_and_bin at 8x128 tiles and fc 128 -> maps
    (N, 16, H, W) float32: z*fg, fg, sorted id, normal (3), colour (3),
    barycentrics*fg (3), zeros."""
    if rows.device.type == "cpu":
        return rasterize_shaded_v3_plain(rows, active, h, w, id_bits)
    n, f = rows.shape[0], rows.shape[-1]
    _check("rasterize_shaded_v3", rows, 32,
           {"active": (active, (n, h // TH, w // TW, f // FC))}, h, w, TH, TW, FC, id_bits)
    out = torch.empty((n, 16, h, w), dtype=torch.float32, device=rows.device)
    V3_KERNEL.launch(rows.device, rows.data_ptr(), active.data_ptr(), out.data_ptr(),
                     n, f, h, w, f // FC, (1 << id_bits) - 1)
    return out


def rasterize_shaded(rows: torch.Tensor, active: torch.Tensor, h: int, w: int,
                     th: int = 8, tw: int = 128, fc: int = 128, id_bits: int = 11,
                     version: int = 2) -> torch.Tensor:
    """K5 (version 1) and K6 (version 2): K2's maps from the same packs,
    every chunk of a tile tested against active and the valid row, tiles
    th x tw, chunks of fc faces.  Any version but 1 or 2 raises."""
    if version not in V12_KERNELS:
        raise ValueError(f"rasterize_shaded: version must be 1 or 2, got {version!r}")
    if rows.device.type == "cpu":
        return rasterize_shaded_plain(rows, active, h, w, th, tw, fc, id_bits)
    n, f = rows.shape[0], rows.shape[-1]
    _check("rasterize_shaded", rows, 32,
           {"active": (active, (n, h // max(th, 1), w // max(tw, 1), f // max(fc, 1)))},
           h, w, th, tw, fc, id_bits)
    out = torch.empty((n, 16, h, w), dtype=torch.float32, device=rows.device)
    V12_KERNELS[version].launch(rows.device, rows.data_ptr(), active.data_ptr(),
                                out.data_ptr(), n, f, h, w, th, tw, fc, (1 << id_bits) - 1,
                                version)
    return out


def rasterize_packed(rows: torch.Tensor, active: torch.Tensor, h: int, w: int,
                     th: int = 32, tw: int = 128, fc: int = 128,
                     id_bits: int = 11) -> torch.Tensor:
    """K4.  rows (N, 16, F') and active (N, H/th, W/tw, F'/fc) from
    pack_faces_and_bin -> packed winner keys (N, H, W) int32, INT32_MAX
    where no face covers."""
    if rows.device.type == "cpu":
        return rasterize_packed_plain(rows, active, h, w, th, tw, fc, id_bits)
    n, f = rows.shape[0], rows.shape[-1]
    _check("rasterize_packed", rows, 16,
           {"active": (active, (n, h // max(th, 1), w // max(tw, 1), f // max(fc, 1)))},
           h, w, th, tw, fc, id_bits)
    out = torch.empty((n, h, w), dtype=torch.int32, device=rows.device)
    PACKED_KERNEL.launch(rows.device, rows.data_ptr(), active.data_ptr(), out.data_ptr(),
                         n, f, h, w, th, tw, fc, (1 << id_bits) - 1)
    return out


def rasterize_shaded_v4(rows: torch.Tensor, seg_start: torch.Tensor, seg_count: torch.Tensor,
                        ov_counts: torch.Tensor, ov_order: torch.Tensor, h: int, w: int,
                        th: int = 8, tw: int = 128, fc: int = 128,
                        id_bits: int = 14) -> torch.Tensor:
    """K3.  Entry rows (N, 32, E) and the tile segments from
    pack_shaded_exact -> maps (N, 16, H, W) as K2's, except that channel 2
    holds the sorted ENTRY id (pack_shaded_exact's perm maps it to the
    original face)."""
    if rows.device.type == "cpu":
        return rasterize_shaded_v4_plain(rows, seg_start, seg_count, ov_counts, ov_order,
                                         h, w, th, tw, fc, id_bits)
    n, f = rows.shape[0], rows.shape[-1]
    tiles = (n, h // max(th, 1), w // max(tw, 1))
    nov = ov_order.shape[-1] if ov_order.dim() == 4 else -1
    _check("rasterize_shaded_v4", rows, 32,
           {"seg_start": (seg_start, tiles), "seg_count": (seg_count, tiles),
            "ov_counts": (ov_counts, tiles), "ov_order": (ov_order, tiles + (nov,))},
           h, w, th, tw, fc, id_bits)
    out = torch.empty((n, 16, h, w), dtype=torch.float32, device=rows.device)
    V4_KERNEL.launch(rows.device, rows.data_ptr(), seg_start.data_ptr(), seg_count.data_ptr(),
                     ov_counts.data_ptr(), ov_order.data_ptr(), out.data_ptr(),
                     n, f, h, w, th, tw, fc, nov, (1 << id_bits) - 1)
    return out
