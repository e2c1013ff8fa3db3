// Device code shared by the raster kernels K2 (rasterize_v3.cu), K3
// (rasterize_v4.cu), K4 (rasterize_packed.cu) and K5/K6 (rasterize_v12.cu):
// the per-face z-test of a staged piece of faces, and the 16 output maps of
// a pixel from its winner's record.  The counterpart of the JAX module's
// shared _eval_chunk_value_carry and _emit_maps
// (scflow_tpu/ops/pallas/rasterize.py:388-460).
//
// Keys: per pixel, the winner is the covering face with the least int32 key
//   (bits(max(z, 1e-6)) & ~id_mask) | sorted_id,
// so keys are unique and the order in which faces are visited does not
// change the result.  Invalid or culled faces carry w0 == -1 and never
// cover; the kernels that AND the explicit valid row (K4, K5/K6) also skip
// a face whose row 10 is not > 0.5.
//
// Rounding: every a*b + c is written as __fmul_rn/__fadd_rn and the files
// build with -fmad=false, so nothing is contracted into an FMA and keys and
// maps equal the plain PyTorch versions' (one rounding per operation) bit
// for bit.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>

#define RC_THREADS 256
#define RC_PPT 4                            // pixels per thread
#define RC_BLOCK_PIX (RC_THREADS * RC_PPT)  // pixels per block
#define RC_PIECE 128                        // faces staged in shared memory at once

__device__ __forceinline__ float rc_affine(float a, float b, float c, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

__device__ __forceinline__ float rc_blend3(float w0, float w1, float w2, float a0, float a1,
                                           float a2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(w0, a0), __fmul_rn(w1, a1)), __fmul_rn(w2, a2));
}

// Stage rows 0..ROWS-1 of faces [f0, f0 + RC_PIECE) of one image's rows
// (row stride F) in shared memory and min-merge their keys into each
// thread's RC_PPT pixels.  ROWS == 10 reads the plane coefficients and the
// id; ROWS == 11 adds the valid row and skips invalid faces.  Every thread
// of the block must call it (it synchronises).
template <int ROWS>
__device__ __forceinline__ void rc_test_piece(float (*coef)[RC_PIECE],
                                              const float* __restrict__ rn, int F, int f0,
                                              const float* px, const float* py, int* best,
                                              int id_mask) {
  __syncthreads();  // the previous piece is no longer read
  for (int e = threadIdx.x; e < ROWS * RC_PIECE; e += RC_THREADS) {
    const int r = e / RC_PIECE, f = e - r * RC_PIECE;
    coef[r][f] = rn[(size_t)r * F + f0 + f];
  }
  __syncthreads();
  for (int f = 0; f < RC_PIECE; ++f) {
    if (ROWS > 10 && !(coef[10][f] > 0.5f)) continue;  // the same for every thread
    const int id = (int)coef[9][f];
#pragma unroll
    for (int k = 0; k < RC_PPT; ++k) {
      const float w0 = rc_affine(coef[0][f], coef[1][f], coef[2][f], px[k], py[k]);
      const float w1 = rc_affine(coef[3][f], coef[4][f], coef[5][f], px[k], py[k]);
      const float z = rc_affine(coef[6][f], coef[7][f], coef[8][f], px[k], py[k]);
      const float w2 = __fsub_rn(__fsub_rn(1.f, w0), w1);
      // min(min(w0, w1), w2) >= 0, false for NaN as in the reference
      const bool cover = (w0 >= 0.f) && (w1 >= 0.f) && (w2 >= 0.f);
      const float zc = isnan(z) ? z : fmaxf(z, 1e-6f);
      const int key = (__float_as_int(zc) & ~id_mask) | id;
      if (cover && key < best[k]) best[k] = key;
    }
  }
}

// The pixels of one block inside a tile of any shape: block blockIdx.x of
// the tile covers its flat pixels [blockIdx.x * RC_BLOCK_PIX, ...), row-major
// over the tile, neighbouring threads on neighbouring pixels.  A pixel past
// the tile's end gets in[k] = false and the tile's first pixel's
// coordinates (it is tested but never written).
__device__ __forceinline__ void rc_tile_pixels(int tile, int TX, int th, int tw, float* px,
                                               float* py, int* x, int* y, bool* in) {
  const int ty = tile / TX, tx = tile - ty * TX;
#pragma unroll
  for (int k = 0; k < RC_PPT; ++k) {
    const int p = blockIdx.x * RC_BLOCK_PIX + threadIdx.x + k * RC_THREADS;
    in[k] = p < th * tw;
    const int q = in[k] ? p : 0;
    x[k] = tx * tw + q % tw;
    y[k] = ty * th + q / tw;
    px[k] = (float)x[k];
    py[k] = (float)y[k];
  }
}

// Write the 16 maps of one pixel (z*fg, fg, sorted id, normal (3), colour
// (3), barycentrics*fg (3), zeros) at o, channel stride `plane`, from its
// least key.  The winner's record is read from global memory, an exact copy;
// a background pixel keeps zeros, like the reference's zero-initialised
// carry.
__device__ __forceinline__ void rc_emit_maps(const float* __restrict__ rn, int F, int best,
                                             int id_mask, float px, float py, float* o,
                                             size_t plane) {
  const bool fg = best != INT_MAX;
  float a[29];
#pragma unroll
  for (int r = 0; r < 29; ++r) a[r] = 0.f;
  if (fg) {
    const int id = best & id_mask;
#pragma unroll
    for (int r = 0; r < 29; ++r)
      if (r != 10) a[r] = rn[(size_t)r * F + id];
  }
  const float fgf = fg ? 1.f : 0.f;
  const float w0 = rc_affine(a[0], a[1], a[2], px, py);
  const float w1 = rc_affine(a[3], a[4], a[5], px, py);
  const float w2 = __fsub_rn(__fsub_rn(1.f, w0), w1);
  const float z = rc_affine(a[6], a[7], a[8], px, py);
  o[0 * plane] = __fmul_rn(z, fgf);
  o[1 * plane] = fgf;
  o[2 * plane] = a[9];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    o[(3 + ch) * plane] = rc_blend3(w0, w1, w2, a[11 + ch], a[14 + ch], a[17 + ch]);
    o[(6 + ch) * plane] = rc_blend3(w0, w1, w2, a[20 + ch], a[23 + ch], a[26 + ch]);
  }
  o[9 * plane] = __fmul_rn(w0, fgf);
  o[10 * plane] = __fmul_rn(w1, fgf);
  o[11 * plane] = __fmul_rn(w2, fgf);
#pragma unroll
  for (int ch = 12; ch < 16; ++ch) o[ch * plane] = 0.f;
}

// Checks shared by the launch functions of the tile-generic kernels.
static inline bool rc_shape_ok(int N, int F, int H, int W, int th, int tw, int fc) {
  if (N <= 0 || N > 65535 || th <= 0 || tw <= 0 || fc <= 0 || F <= 0) return false;
  if (H % th != 0 || W % tw != 0 || fc % RC_PIECE != 0 || F % fc != 0) return false;
  const long long tiles = (long long)(H / th) * (W / tw);
  return tiles > 0 && tiles <= 65535 && (long long)th * tw <= INT_MAX / 2;
}

static inline dim3 rc_grid(int N, int H, int W, int th, int tw) {
  return dim3((unsigned)((th * tw + RC_BLOCK_PIX - 1) / RC_BLOCK_PIX),
              (unsigned)((H / th) * (W / tw)), (unsigned)N);
}
