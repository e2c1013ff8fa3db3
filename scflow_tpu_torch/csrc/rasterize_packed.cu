// K4: tile-binned depth-only z-buffer pass; packed winner keys per pixel.
//
// Replaces: scflow_tpu/ops/pallas/rasterize.py::_kernel (the depth pass of
// rasterize_packed_pallas, consumed by render/rasterizer.py::rasterize with
// backend='pallas').
//
// Input: packed face rows (N, 16, F) from pack_faces_and_bin, sorted by
// tile: rows 0-8 the affine plane coefficients of w0, w1 and z, row 9 the
// sorted face id, row 10 the valid flag; active (N, TY, TX, NC): does chunk
// c (fc faces) touch tile (ty, tx).  Output: (N, H, W) int32 least keys
// (keys and rounding: csrc/raster_common.cuh), INT_MAX where no face covers.
//
// Tiles are th x tw pixels of any shape: rasterize() takes 8 x 128 where the
// crop allows and th = H or tw = W where it does not (a 192^2 crop tiles as
// 24 tiles of 8 x 192, a 100^2 crop is one 100 x 100 tile).
//
// Bound on an H100 SXM: the arithmetic, 14 fp32 operations per face-pixel
// of every active (tile, chunk) pair, against the output's 4 bytes per
// pixel.  chip_smoke.py counts both from its scene.
//
// Design: blockIdx.y is the tile, blockIdx.z the image, and blockIdx.x
// one of the ceil(th*tw / 1024) blocks that split the tile's pixels, 256
// threads with 4 pixels each and their keys in registers.  Each block
// walks every chunk of its tile and skips the inactive ones (in place of
// the TPU kernel's lax.cond), staging a chunk 128 faces at a time (11 rows,
// 5.5 KB of shared memory, whatever fc is) and testing the valid row as the
// TPU kernel does.  The keys are written once at the end.

#include "raster_common.cuh"

#define ROWS_IN 16
#define COEF_ROWS 11

__global__ void __launch_bounds__(RC_THREADS)
raster_packed_kernel(const float* __restrict__ rows, const int* __restrict__ active,
                     int* __restrict__ out, int F, int H, int W, int th, int tw, int fc,
                     int id_mask) {
  const int tile = blockIdx.y, n = blockIdx.z, T = gridDim.y, NC = F / fc;
  const float* rn = rows + (size_t)n * ROWS_IN * F;
  const int* act = active + ((size_t)n * T + tile) * NC;
  __shared__ float coef[COEF_ROWS][RC_PIECE];

  float px[RC_PPT], py[RC_PPT];
  int x[RC_PPT], y[RC_PPT], best[RC_PPT];
  bool in[RC_PPT];
  rc_tile_pixels(tile, W / tw, th, tw, px, py, x, y, in);
#pragma unroll
  for (int k = 0; k < RC_PPT; ++k) best[k] = INT_MAX;

  for (int c = 0; c < NC; ++c) {
    if (act[c] == 0) continue;  // the same for every thread of the block
    for (int f0 = c * fc; f0 < (c + 1) * fc; f0 += RC_PIECE)
      rc_test_piece<COEF_ROWS>(coef, rn, F, f0, px, py, best, id_mask);
  }

  int* on = out + (size_t)n * H * W;
#pragma unroll
  for (int k = 0; k < RC_PPT; ++k)
    if (in[k]) on[(size_t)y[k] * W + x[k]] = best[k];
}

extern "C" int raster_packed_launch(const float* rows, const int* active, int* out, int N,
                                    int F, int H, int W, int th, int tw, int fc, int id_mask,
                                    cudaStream_t stream) {
  if (!rc_shape_ok(N, F, H, W, th, tw, fc)) return (int)cudaErrorInvalidValue;
  raster_packed_kernel<<<rc_grid(N, H, W, th, tw), RC_THREADS, 0, stream>>>(
      rows, active, out, F, H, W, th, tw, fc, id_mask);
  return (int)cudaGetLastError();
}
