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
// Bound on an H100 SXM: the bytes.  The work these inputs need is 14 fp32
// operations per (face, pixel) pair with the pixel inside the face's
// bounding box, a few MFLOP at the flagship scene, against the rows, the
// chunk flags and the 4-byte keys: about 21 MB, 0.006 ms at 3.35 TB/s.
// chip_smoke.py counts both from its scene.
//
// Design: blockIdx.y is the tile, blockIdx.z the image, and blockIdx.x one
// of the 8 x 128 pieces that split the tile, 256 threads with 4
// neighbouring pixels each and their keys in registers, each warp on an
// 8 x 16 rectangle (padding pixels of a piece that overhangs its tile are
// left out of the rectangle and never written).  Each block walks every
// chunk of its tile and skips the inactive ones (in place of the TPU
// kernel's lax.cond), staging up to 512 faces of a chunk at once (11 rows,
// 22.5 KB of shared memory: one piece and two barriers for rasterize()'s
// fc = 512, where the brute-force design took four).  Each warp rejects the
// faces that are invalid or cannot cover its rectangle and runs the
// per-pixel test on the rest (raster_common.cuh): 1.1% of the (warp, face)
// pairs at the flagship scene, so the rejection itself now takes most of
// the time.  The keys are written once at the end, 16 bytes per thread
// where the pixels allow.

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
  __shared__ __align__(16) float coef[COEF_ROWS][RC_STAGE];

  const RcPixels p = rc_tile_pixels(tile, W / tw, th, tw);
  const RcRect rect = rc_warp_rect(p);
  int best[RC_PPT];
#pragma unroll
  for (int k = 0; k < RC_PPT; ++k) best[k] = INT_MAX;

  for (int c = 0; c < NC; ++c) {
    if (act[c] == 0) continue;  // the same for every thread of the block
    for (int f0 = c * fc; f0 < (c + 1) * fc; f0 += RC_STAGE)
      rc_test_faces<COEF_ROWS, RC_STAGE>(coef, rn, F, f0,
                                               min(RC_STAGE, (c + 1) * fc - f0), rect, p, best,
                                               id_mask);
  }

  int* o = out + (size_t)n * H * W + (size_t)p.y * W + p.x;
  rc_store4<int, int4>(o, best, rc_vec_ok(o, 0, p), p.in);
}

extern "C" int raster_packed_launch(const float* rows, const int* active, int* out, int N,
                                    int F, int H, int W, int th, int tw, int fc, int id_mask,
                                    cudaStream_t stream) {
  if (!rc_shape_ok(N, F, H, W, th, tw, fc)) return (int)cudaErrorInvalidValue;
  raster_packed_kernel<<<rc_grid(N, H, W, th, tw), RC_THREADS, 0, stream>>>(
      rows, active, out, F, H, W, th, tw, fc, id_mask);
  return (int)cudaGetLastError();
}
