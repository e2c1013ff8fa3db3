// K2: tile-binned z-buffer rasterizer with shaded fragment maps.
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
// so keys are unique and neither the order in which faces are visited nor
// skipping a face that covers none of a warp's pixels changes the result.
// Invalid or culled faces carry w0 == -1 and never cover.
//
// Bound on an H100 SXM: the bytes.  The work these inputs need is 14 fp32
// operations per (face, pixel) pair with the pixel inside the face's
// bounding box, a few MFLOP at the flagship scene (N = 64, 256^2,
// 1024-face uvsphere bank, culling on), against the 8.4 MB of rows, the
// chunk flags and the 268 MB of output: about 0.083 ms at 3.35 TB/s.
// chip_smoke.py counts both from its scene, and the (tile, chunk) pairs the
// kernel walks.
//
// Design: one block of 256 threads per (image, 8x128 tile), 4 neighbouring
// pixels per thread, keys in registers, each warp on an 8 x 16 rectangle.
// The block walks the tile's active chunks in place of the TPU kernel's
// scalar-prefetched compacted list, staging rows 0-9 of each chunk (5 KB)
// in shared memory.  Each warp rejects the staged faces that cannot cover
// its rectangle (raster_common.cuh: one face per lane in fp64, a ballot)
// and runs the per-pixel test only on the survivors, so the test loop that
// bounded the brute-force design (128 faces x 1024 pixels per active
// chunk) shrinks to the faces near each warp: 2.8% of the (warp, face)
// pairs at the flagship scene.  At the end each thread reads its winners'
// records from global memory (an exact copy, where the TPU kernel used a
// one-hot matmul) and writes each of the 16 maps with one 16-byte
// streaming store.  The stores set the pace: the winners' gathers add 5%
// to them, and the test loop overlaps them (chip_smoke.py's split).
//
// raster_v3_probe_launch runs the same kernel in parts, for chip_smoke.py's
// split of the time: the test loop alone (writing the keys, and counting
// the surviving (warp, face) pairs), or the emit alone from given keys.
//
// Rounding and the shared device code: csrc/raster_common.cuh.

#include "raster_common.cuh"

#define TH 8
#define TW 128
#define FC 128
#define COEF_ROWS 10

static_assert(TH == RC_BLOCK_H && TW == RC_BLOCK_W && FC == RC_PIECE,
              "one block per tile, one chunk per staged piece");

enum { MODE_FULL, MODE_TEST, MODE_EMIT };

template <int MODE>
__global__ void __launch_bounds__(RC_THREADS)
raster_v3_kernel(const float* __restrict__ rows, const int* __restrict__ active,
                 float* __restrict__ out, int* __restrict__ keys,
                 unsigned long long* __restrict__ kept, int F, int H, int W, int NC,
                 int id_mask) {
  const int tx = blockIdx.x, ty = blockIdx.y, n = blockIdx.z;
  const int TX = gridDim.x, TY = gridDim.y;
  const float* rn = rows + (size_t)n * 32 * F;
  const int* act = active + (((size_t)n * TY + ty) * TX + tx) * NC;
  __shared__ __align__(16) float coef[COEF_ROWS][FC];

  const RcPixels p = rc_block_pixels(tx * TW, ty * TH, TW, TH);
  const size_t pix = (size_t)p.y * W + p.x;
  int best[RC_PPT];
  if (MODE == MODE_EMIT) {
    const int4 b = *reinterpret_cast<const int4*>(keys + (size_t)n * H * W + pix);
    best[0] = b.x, best[1] = b.y, best[2] = b.z, best[3] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < RC_PPT; ++k) best[k] = INT_MAX;
    const RcRect rect = rc_warp_rect(p);
    unsigned long long nk = 0;
    for (int c = 0; c < NC; ++c) {
      if (act[c] == 0) continue;  // the same for every thread of the block
      nk += rc_test_faces<COEF_ROWS, FC>(coef, rn, F, c * FC, FC, rect, p, best, id_mask);
    }
    if (MODE != MODE_FULL) {
      if ((threadIdx.x & 31) == 0 && nk) atomicAdd(kept, nk);
      *reinterpret_cast<int4*>(keys + (size_t)n * H * W + pix) =
          make_int4(best[0], best[1], best[2], best[3]);
      return;
    }
  }
  // out comes from the wrapper (16-byte aligned) and W % 128 == 0: every
  // store may take 16 bytes
  const size_t plane = (size_t)H * W;
  rc_emit_maps(rn, F, best, id_mask, p, out + (size_t)n * 16 * plane + pix, plane, true);
}

static bool v3_shape_ok(int N, int F, int H, int W, int NC) {
  return N > 0 && N <= 65535 && H > 0 && W > 0 && H % TH == 0 && W % TW == 0 && NC > 0 &&
         F == NC * FC && H / TH <= 65535;
}

extern "C" int raster_v3_launch(const float* rows, const int* active, float* out,
                                int N, int F, int H, int W, int NC, int id_mask,
                                cudaStream_t stream) {
  if (!v3_shape_ok(N, F, H, W, NC)) return (int)cudaErrorInvalidValue;
  dim3 grid(W / TW, H / TH, N);
  raster_v3_kernel<MODE_FULL><<<grid, RC_THREADS, 0, stream>>>(rows, active, out, nullptr,
                                                               nullptr, F, H, W, NC, id_mask);
  return (int)cudaGetLastError();
}

// mode 1: the test loop alone -> keys (N, H, W), adding the surviving
// (warp, face) pairs to *kept; mode 2: the emit alone, from keys -> out.
// keys must be 16-byte aligned.
extern "C" int raster_v3_probe_launch(const float* rows, const int* active, float* out,
                                      int* keys, unsigned long long* kept, int N, int F, int H,
                                      int W, int NC, int id_mask, int mode,
                                      cudaStream_t stream) {
  if (!v3_shape_ok(N, F, H, W, NC) || (reinterpret_cast<size_t>(keys) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(W / TW, H / TH, N);
  switch (mode) {
    case MODE_TEST:
      raster_v3_kernel<MODE_TEST><<<grid, RC_THREADS, 0, stream>>>(rows, active, out, keys,
                                                                   kept, F, H, W, NC, id_mask);
      break;
    case MODE_EMIT:
      raster_v3_kernel<MODE_EMIT><<<grid, RC_THREADS, 0, stream>>>(rows, active, out, keys,
                                                                   kept, F, H, W, NC, id_mask);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
