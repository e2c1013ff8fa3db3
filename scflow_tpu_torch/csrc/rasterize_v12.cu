// K5/K6: tile-binned shaded z-buffer over every chunk of the tile, with the
// explicit valid row; one kernel for both versions.
//
// Replaces: scflow_tpu/ops/pallas/rasterize.py::_kernel_shaded (v1) and
// _kernel_shaded_v2 (v2), through rasterize_shaded_pallas(version=1|2).  The
// two TPU kernels compute the same maps as K2 from the same packs and differ
// only in how the TPU's matrix unit selects the winner's record (v1 a
// Precision.HIGHEST one-hot matmul, v2 masked reductions plus a
// default-precision matmul whose bf16 passes round the normals).  The card
// has no such passes: the winner's record is copied, exactly, so both
// versions run this one kernel; the launch takes the version only to
// refuse any other value.
//
// Input: packed face rows (N, 32, F) from pack_shaded_and_bin (rows 0-8
// plane coefficients, 9 sorted id, 10 valid, 11-28 corner normals and
// colours) and active (N, TY, TX, NC) over chunks of fc faces.  Output:
// (N, 16, H, W) maps, as K2's (keys, maps and rounding:
// csrc/raster_common.cuh).  Tiles are th x tw pixels of any shape.
//
// Bound on an H100 SXM: the bytes, as K2's (the rows, the chunk flags and
// 64 bytes per pixel of output); the work these inputs need, 14 fp32
// operations per (face, pixel) pair inside the face's bounding box, is a
// few MFLOP.
//
// Design: K4's (one block per 8 x 128 piece of a tile, every chunk tested
// against active, up to 512 faces staged at once with the valid row, each
// warp testing per pixel only the faces that can cover its 8 x 16
// rectangle: raster_common.cuh), then K2's epilogue: each thread copies its
// winners' records from global memory and writes the 16 maps, 16 bytes per
// store where the pixels allow.  The per-chunk flags are read as they were:
// their redesign is open (ROADMAP).

#include "raster_common.cuh"

#define ROWS_IN 32
#define COEF_ROWS 11

__global__ void __launch_bounds__(RC_THREADS)
raster_v12_kernel(const float* __restrict__ rows, const int* __restrict__ active,
                  float* __restrict__ out, int F, int H, int W, int th, int tw, int fc,
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

  const size_t plane = (size_t)H * W;
  float* o = out + (size_t)n * 16 * plane + (size_t)p.y * W + p.x;
  rc_emit_maps(rn, F, best, id_mask, p, o, plane, rc_vec_ok(o, plane, p));
}

extern "C" int raster_v12_launch(const float* rows, const int* active, float* out, int N,
                                 int F, int H, int W, int th, int tw, int fc, int id_mask,
                                 int version, cudaStream_t stream) {
  if ((version != 1 && version != 2) || !rc_shape_ok(N, F, H, W, th, tw, fc))
    return (int)cudaErrorInvalidValue;
  raster_v12_kernel<<<rc_grid(N, H, W, th, tw), RC_THREADS, 0, stream>>>(
      rows, active, out, F, H, W, th, tw, fc, id_mask);
  return (int)cudaGetLastError();
}
