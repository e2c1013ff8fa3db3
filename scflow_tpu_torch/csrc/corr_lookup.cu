// Windowed bilinear lookup in a multi-level correlation pyramid.
//
// Replaces: scflow_tpu/ops/pallas/corr_lookup.py::_kernel (the TPU "tent"
// kernel).  That kernel builds each 9x9 window as two matmuls against 0/1
// selection matrices, because a gather is slow on a TPU.  On Hopper a
// gather is cheap, so this kernel reads the four corners of every tap
// directly.
//
// Contract (same as the TPU kernel): for row b, level l and tap (j, i) of
// the k x k window (k = 2r + 1),
//   x = cx_b / 2^l + (j - r),  y = cy_b / 2^l + (i - r),
//   out[b, l*k*k + j*k + i] = bilinear(level_l[b], x, y), zeros outside.
// j offsets x: this tap order is what the motion encoder's weights expect.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  At the flagship shape
// (B = 65,536 rows, levels 32^2/16^2/8^2/4^2, r = 4) one launch writes
// 85 MB and reads at most 10x10 cells per row and level (about 37 us for
// chip_smoke.py's coordinates, which computes the bound each run); the
// arithmetic (3 lerps per tap) is far below the fp32 rate.
//
// Design: one thread per output column (level, tap) of a block of ROWS
// rows; threads of one row write consecutive addresses.  Each thread first
// loads its ROWS window centres, then issues the 4*ROWS corner loads before
// blending, so that many independent loads are in flight: one row per
// thread, where each thread waits on a centre load and then on its corners,
// took 0.30-0.36 ms at the flagship shape in two thread layouts, this one
// 0.106 ms (PERF.md).  A corner outside the map is never loaded: it reads
// as 0 (grid_sample's zeros padding).

#include "corr_common.cuh"

#define ROWS 8  // rows per block

__global__ void corr_lookup_kernel(const float* __restrict__ coords, Levels lv,
                                   int num_levels, int radius, long long rows,
                                   float* __restrict__ out) {
  const int k = 2 * radius + 1;
  const int taps = k * k;
  const int per_row = num_levels * taps;
  const int c = threadIdx.x;  // output column: l*k*k + j*k + i
  if (c >= per_row) return;
  const int l = c / taps;
  const int tap = c - l * taps;
  const int j = tap / k;  // offsets x
  const int i = tap - j * k;  // offsets y
  const int s = lv.size[l];
  const float inv = ldexpf(1.f, -l);  // exact power of two
  const float* map = lv.map[l];
  const long long b0 = (long long)blockIdx.x * ROWS;

  float x[ROWS], y[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long b = b0 + r < rows ? b0 + r : rows - 1;
    x[r] = coords[2 * b] * inv + (float)(j - radius);
    y[r] = coords[2 * b + 1] * inv + (float)(i - radius);
  }
  float v00[ROWS], v01[ROWS], v10[ROWS], v11[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long b = b0 + r < rows ? b0 + r : rows - 1;
    const float x0f = floorf(x[r]), y0f = floorf(y[r]);
    // false for NaN and for a window wholly outside the map, which also
    // keeps the int casts in range
    const bool near = x0f >= -1.f && x0f <= (float)(s - 1) && y0f >= -1.f &&
                      y0f <= (float)(s - 1);
    const int x0 = near ? (int)x0f : -2, y0 = near ? (int)y0f : -2;
    const float* m = map + b * (long long)s * s;
    const bool inx0 = x0 >= 0, inx1 = x0 + 1 < s && x0 + 1 >= 0;
    const bool iny0 = y0 >= 0, iny1 = y0 + 1 < s && y0 + 1 >= 0;
    v00[r] = (inx0 && iny0) ? m[y0 * s + x0] : 0.f;
    v01[r] = (inx1 && iny0) ? m[y0 * s + x0 + 1] : 0.f;
    v10[r] = (inx0 && iny1) ? m[(y0 + 1) * s + x0] : 0.f;
    v11[r] = (inx1 && iny1) ? m[(y0 + 1) * s + x0 + 1] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (b0 + r >= rows) break;
    const float fx = x[r] - floorf(x[r]), fy = y[r] - floorf(y[r]);
    // y first, then x: the order of the tent formulation's two contractions
    const float r0 = (1.f - fy) * v00[r] + fy * v10[r];
    const float r1 = (1.f - fy) * v01[r] + fy * v11[r];
    float v = (1.f - fx) * r0 + fx * r1;
    if (isnan(x[r]) || isnan(y[r])) v = x[r] + y[r];  // NaN, as the tent form gives
    out[(b0 + r) * per_row + c] = v;
  }
}

extern "C" int corr_lookup_launch(const float* coords, const float* m0,
                                  const float* m1, const float* m2,
                                  const float* m3, int s0, int s1, int s2,
                                  int s3, int num_levels, int radius,
                                  long long rows, float* out,
                                  cudaStream_t stream) {
  if (num_levels < 1 || num_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Levels lv = {{m0, m1, m2, m3}, {s0, s1, s2, s3}};
  const int per_row = num_levels * (2 * radius + 1) * (2 * radius + 1);
  const int threads = (per_row + 31) / 32 * 32;
  const long long blocks = (rows + ROWS - 1) / ROWS;
  if (threads > 1024 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  corr_lookup_kernel<<<(unsigned)blocks, threads, 0, stream>>>(coords, lv, num_levels,
                                                              radius, rows, out);
  return (int)cudaGetLastError();
}
