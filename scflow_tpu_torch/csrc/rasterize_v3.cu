// Tile-binned z-buffer rasterizer with shaded fragment maps.
//
// Replaces: scflow_tpu/ops/pallas/rasterize.py::_kernel_shaded_v3 (with its
// helpers _eval_chunk_value_carry and _emit_maps).
//
// Input: packed face rows (N, 32, F) from pack_shaded_and_bin, sorted by
// tile: rows 0-8 are the affine plane coefficients of w0, w1 and z
// (w = a px + b py + c), row 9 the sorted face id, rows 11-28 the corner
// normals and colours; and active (N, TY, TX, NC): does chunk c's bounding
// box touch tile (ty, tx).  Output: (N, 16, H, W) maps: z*fg, fg, sorted id,
// normal (3), colour (3), barycentrics*fg (3), zeros.
//
// Per pixel, the winner is the covering face with the least int32 key
//   (bits(max(z, 1e-6)) & ~id_mask) | sorted_id,
// so keys are unique and the order in which chunks are visited does not
// change the result.  Invalid or culled faces carry w0 == -1 and never cover.
//
// Bound on an H100 SXM: the arithmetic.  Every (tile, active chunk) pair
// costs 128 faces x 1024 pixels x 14 fp32 operations; at the flagship shape
// (N = 64, 256^2, 1024 faces, culling on) chip_smoke.py's scene activates
// 4,545 of 32,768 pairs: 8.3 GFLOP, 124 us at 67 TFLOP/s, above the 80 us
// that the 268 MB of output take at 3.35 TB/s.  chip_smoke.py counts the
// active pairs of each run.
//
// Design: one block of 256 threads per (image, 8x128 tile), 4 pixels per
// thread, keys in registers.  The block walks the tile's active chunks in
// place of the TPU kernel's scalar-prefetched compacted list, staging rows
// 0-9 of each chunk (5 KB) in shared memory, read as broadcasts.  At the end
// each thread reads its winner's record from global memory (an exact copy,
// where the TPU kernel used a one-hot matmul) and writes the 16 maps,
// neighbouring threads on neighbouring pixels.
//
// Rounding and the shared device code: csrc/raster_common.cuh.

#include "raster_common.cuh"

#define TH 8
#define TW 128
#define FC 128
#define COEF_ROWS 10

static_assert(TH * TW == RC_BLOCK_PIX && FC == RC_PIECE, "one block per tile, one piece per chunk");

__global__ void __launch_bounds__(RC_THREADS)
raster_v3_kernel(const float* __restrict__ rows, const int* __restrict__ active,
                 float* __restrict__ out, int F, int H, int W, int NC, int id_mask) {
  const int tx = blockIdx.x, ty = blockIdx.y, n = blockIdx.z;
  const int TX = gridDim.x, TY = gridDim.y;
  const float* rn = rows + (size_t)n * 32 * F;
  const int* act = active + (((size_t)n * TY + ty) * TX + tx) * NC;
  __shared__ float coef[COEF_ROWS][RC_PIECE];

  float px[RC_PPT], py[RC_PPT];
  int best[RC_PPT];
#pragma unroll
  for (int k = 0; k < RC_PPT; ++k) {
    const int p = threadIdx.x + k * RC_THREADS;
    px[k] = (float)(tx * TW + p % TW);
    py[k] = (float)(ty * TH + p / TW);
    best[k] = INT_MAX;
  }

  for (int c = 0; c < NC; ++c) {
    if (act[c] == 0) continue;  // the same for every thread of the block
    rc_test_piece<COEF_ROWS>(coef, rn, F, c * FC, px, py, best, id_mask);
  }

  const size_t plane = (size_t)H * W;
  float* on = out + (size_t)n * 16 * plane;
#pragma unroll
  for (int k = 0; k < RC_PPT; ++k) {
    const int p = threadIdx.x + k * RC_THREADS;
    const int x = tx * TW + p % TW, y = ty * TH + p / TW;
    rc_emit_maps(rn, F, best[k], id_mask, px[k], py[k], on + (size_t)y * W + x, plane);
  }
}

extern "C" int raster_v3_launch(const float* rows, const int* active, float* out,
                                int N, int F, int H, int W, int NC, int id_mask,
                                cudaStream_t stream) {
  if (H % TH != 0 || W % TW != 0 || F != NC * FC || N > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(W / TW, H / TH, N);
  raster_v3_kernel<<<grid, RC_THREADS, 0, stream>>>(rows, active, out, F, H, W, NC, id_mask);
  return (int)cudaGetLastError();
}
