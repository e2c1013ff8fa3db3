// K3: exact-binned shaded z-buffer: each tile walks its own contiguous
// range of entry chunks, then its overflow chunks.
//
// Replaces: scflow_tpu/ops/pallas/rasterize.py::_kernel_shaded_v4, through
// rasterize_shaded_pallas_v4 (render_batch with raster_version=4).
//
// Input from pack_shaded_exact: entry rows (N, 32, E), one entry per
// (face, covered tile) sorted by tile, row 9 the sorted ENTRY id; seg_start
// and seg_count (N, TY, TX): the tile's chunks [seg_start, seg_start +
// seg_count) of fc entries; ov_counts (N, TY, TX) and ov_order (N, TY, TX,
// NOV): the overflow chunks (faces wider than `dup` tiles) whose bbox
// touches the tile.  Output: (N, 16, H, W) maps as K2's, channel 2 the
// winner's entry id (keys, maps and rounding: csrc/raster_common.cuh).
//
// Duplicates: one face's entries give identical z at a pixel with distinct
// entry ids, and the least key keeps the lowest entry id, whatever order the
// chunks are walked in; a chunk listed in both the range and the overflow
// list is tested twice to the same effect.
//
// Bound on an H100 SXM: the arithmetic, 14 fp32 operations per entry-pixel
// of every chunk a tile walks, against the 64 bytes per pixel of output;
// chip_smoke.py counts the (tile, chunk) pairs of its scene.
//
// Design: K5/K6's blocks (1024 pixels of one tile each, chunks staged 128
// entries at a time), with the tile's range and overflow list read from
// global memory by each block in place of the TPU's scalar prefetch; a
// chunk id outside [0, E/fc) is skipped.  The valid row is not read: dead
// entries carry w0 == -1.

#include "raster_common.cuh"

#define ROWS_IN 32
#define COEF_ROWS 10

__global__ void __launch_bounds__(RC_THREADS)
raster_v4_kernel(const float* __restrict__ rows, const int* __restrict__ seg_start,
                 const int* __restrict__ seg_count, const int* __restrict__ ov_counts,
                 const int* __restrict__ ov_order, float* __restrict__ out, int F, int H,
                 int W, int th, int tw, int fc, int nov, int id_mask) {
  const int tile = blockIdx.y, n = blockIdx.z, T = gridDim.y, NC = F / fc;
  const size_t t = (size_t)n * T + tile;
  const float* rn = rows + (size_t)n * ROWS_IN * F;
  __shared__ float coef[COEF_ROWS][RC_PIECE];

  float px[RC_PPT], py[RC_PPT];
  int x[RC_PPT], y[RC_PPT], best[RC_PPT];
  bool in[RC_PPT];
  rc_tile_pixels(tile, W / tw, th, tw, px, py, x, y, in);
#pragma unroll
  for (int k = 0; k < RC_PPT; ++k) best[k] = INT_MAX;

  const int s0 = seg_start[t], sc = seg_count[t];
  for (int c = s0; c < s0 + sc; ++c) {
    if (c < 0 || c >= NC) continue;
    for (int f0 = c * fc; f0 < (c + 1) * fc; f0 += RC_PIECE)
      rc_test_piece<COEF_ROWS>(coef, rn, F, f0, px, py, best, id_mask);
  }
  const int m = min(ov_counts[t], nov);
  for (int i = 0; i < m; ++i) {
    const int c = ov_order[t * nov + i];
    if (c < 0 || c >= NC) continue;
    for (int f0 = c * fc; f0 < (c + 1) * fc; f0 += RC_PIECE)
      rc_test_piece<COEF_ROWS>(coef, rn, F, f0, px, py, best, id_mask);
  }

  const size_t plane = (size_t)H * W;
  float* on = out + (size_t)n * 16 * plane;
#pragma unroll
  for (int k = 0; k < RC_PPT; ++k)
    if (in[k])
      rc_emit_maps(rn, F, best[k], id_mask, px[k], py[k], on + (size_t)y[k] * W + x[k], plane);
}

extern "C" int raster_v4_launch(const float* rows, const int* seg_start, const int* seg_count,
                                const int* ov_counts, const int* ov_order, float* out, int N,
                                int F, int H, int W, int th, int tw, int fc, int nov,
                                int id_mask, cudaStream_t stream) {
  if (nov < 0 || !rc_shape_ok(N, F, H, W, th, tw, fc)) return (int)cudaErrorInvalidValue;
  raster_v4_kernel<<<rc_grid(N, H, W, th, tw), RC_THREADS, 0, stream>>>(
      rows, seg_start, seg_count, ov_counts, ov_order, out, F, H, W, th, tw, fc, nov, id_mask);
  return (int)cudaGetLastError();
}
