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
// Rounding: every a*b + c here is written as __fmul_rn/__fadd_rn, and the
// file is compiled with -fmad=false, so nothing is contracted into an FMA.
// Keys, depth, mask and id then equal the plain PyTorch version's (one
// rounding per operation) bit for bit.

#include <cuda_runtime.h>
#include <limits.h>

#define TH 8
#define TW 128
#define FC 128
#define THREADS 256
#define PPT (TH * TW / THREADS)  // pixels per thread
#define COEF_ROWS 10

__device__ __forceinline__ float affine(float a, float b, float c, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

__device__ __forceinline__ float blend3(float w0, float w1, float w2, float a0,
                                        float a1, float a2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(w0, a0), __fmul_rn(w1, a1)), __fmul_rn(w2, a2));
}

__global__ void __launch_bounds__(THREADS)
raster_v3_kernel(const float* __restrict__ rows, const int* __restrict__ active,
                 float* __restrict__ out, int F, int H, int W, int NC, int id_mask) {
  const int tx = blockIdx.x, ty = blockIdx.y, n = blockIdx.z;
  const int TX = gridDim.x, TY = gridDim.y;
  const float* rn = rows + (size_t)n * 32 * F;
  const int* act = active + (((size_t)n * TY + ty) * TX + tx) * NC;
  __shared__ float coef[COEF_ROWS][FC];

  float px[PPT], py[PPT];
  int best[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * THREADS;
    px[k] = (float)(tx * TW + p % TW);
    py[k] = (float)(ty * TH + p / TW);
    best[k] = INT_MAX;
  }

  for (int c = 0; c < NC; ++c) {
    if (act[c] == 0) continue;  // the same for every thread of the block
    __syncthreads();            // the previous chunk is no longer read
    for (int e = threadIdx.x; e < COEF_ROWS * FC; e += THREADS) {
      const int r = e / FC, f = e - r * FC;
      coef[r][f] = rn[(size_t)r * F + c * FC + f];
    }
    __syncthreads();
    for (int f = 0; f < FC; ++f) {
      const int id = (int)coef[9][f];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float w0 = affine(coef[0][f], coef[1][f], coef[2][f], px[k], py[k]);
        const float w1 = affine(coef[3][f], coef[4][f], coef[5][f], px[k], py[k]);
        const float z = affine(coef[6][f], coef[7][f], coef[8][f], px[k], py[k]);
        const float w2 = __fsub_rn(__fsub_rn(1.f, w0), w1);
        // min(min(w0, w1), w2) >= 0, false for NaN as in the reference
        const bool cover = (w0 >= 0.f) && (w1 >= 0.f) && (w2 >= 0.f);
        const float zc = isnan(z) ? z : fmaxf(z, 1e-6f);
        const int key = (__float_as_int(zc) & ~id_mask) | id;
        if (cover && key < best[k]) best[k] = key;
      }
    }
  }

  const size_t plane = (size_t)H * W;
  float* on = out + (size_t)n * 16 * plane;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * THREADS;
    const int x = tx * TW + p % TW, y = ty * TH + p / TW;
    const bool fg = best[k] != INT_MAX;
    // the winner's record; a background pixel keeps zeros, like the
    // reference's zero-initialised carry
    float a[29];
#pragma unroll
    for (int r = 0; r < 29; ++r) a[r] = 0.f;
    if (fg) {
      const int id = best[k] & id_mask;
#pragma unroll
      for (int r = 0; r < 29; ++r)
        if (r != 10) a[r] = rn[(size_t)r * F + id];
    }
    const float fgf = fg ? 1.f : 0.f;
    const float w0 = affine(a[0], a[1], a[2], px[k], py[k]);
    const float w1 = affine(a[3], a[4], a[5], px[k], py[k]);
    const float w2 = __fsub_rn(__fsub_rn(1.f, w0), w1);
    const float z = affine(a[6], a[7], a[8], px[k], py[k]);
    float* o = on + (size_t)y * W + x;
    o[0 * plane] = __fmul_rn(z, fgf);
    o[1 * plane] = fgf;
    o[2 * plane] = a[9];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      o[(3 + ch) * plane] = blend3(w0, w1, w2, a[11 + ch], a[14 + ch], a[17 + ch]);
      o[(6 + ch) * plane] = blend3(w0, w1, w2, a[20 + ch], a[23 + ch], a[26 + ch]);
    }
    o[9 * plane] = __fmul_rn(w0, fgf);
    o[10 * plane] = __fmul_rn(w1, fgf);
    o[11 * plane] = __fmul_rn(w2, fgf);
#pragma unroll
    for (int ch = 12; ch < 16; ++ch) o[ch * plane] = 0.f;
  }
}

extern "C" int raster_v3_launch(const float* rows, const int* active, float* out,
                                int N, int F, int H, int W, int NC, int id_mask,
                                cudaStream_t stream) {
  if (H % TH != 0 || W % TW != 0 || F != NC * FC || N > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(W / TW, H / TH, N);
  raster_v3_kernel<<<grid, THREADS, 0, stream>>>(rows, active, out, F, H, W, NC, id_mask);
  return (int)cudaGetLastError();
}
