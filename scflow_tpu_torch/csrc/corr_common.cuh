// Shared pieces of the corr-lookup kernels: K1 (corr_lookup.cu), K7
// (corr_lookup_shift.cu), K8 (corr_lookup_bdiag.cu) and K1's backward
// (corr_lookup_bwd.cu).
//
// Contract of every lookup kernel: row b has a window centre (cx_b, cy_b)
// at level 0; level l is a flat S_l x S_l map per row; tap (j, i) of the
// k x k window (k = 2r + 1) samples level l at
//   x = cx_b / 2^l + (j - r),  y = cy_b / 2^l + (i - r),
// bilinearly with zeros outside, into column l*k*k + j*k + i.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define MAX_LEVELS 4

struct Levels {
  const float* map[MAX_LEVELS];
  int size[MAX_LEVELS];
};

// The window stage of K7 and K8.  For each of a block's rows and each level
// it keeps the level's centre (px, py) and floor(px), floor(py), and the
// (k+1) x (k+1) integer cells the window can touch,
//   patch[d][e] = map[floor(py) - r + d][floor(px) - r + e],  0 outside,
// so that every tap reads its corners from shared memory.  All of a row's
// cells come in together, several rows to a block, so many loads are in
// flight at once.  Cells are tested as floats: a centre far outside the map
// (or NaN) never reaches an int cast.
//
// Shared layout: cen[(row * L + l) * 4 + {px, py, x0f, y0f}], then
// patch[((row * L + l) * (k+1) + d) * (k+1) + e].
__device__ __forceinline__ void stage_windows(const float* __restrict__ coords,
                                              const Levels& lv, int num_levels,
                                              int radius, long long rows,
                                              long long b0, int nrows, float* cen,
                                              float* patch) {
  const int kp = 2 * radius + 2;
  for (int t = threadIdx.x; t < nrows * num_levels; t += blockDim.x) {
    const int l = t % num_levels;
    const long long b = b0 + t / num_levels;
    const long long bc = b < rows ? b : rows - 1;
    const float inv = ldexpf(1.f, -l);  // exact power of two
    const float px = coords[2 * bc] * inv, py = coords[2 * bc + 1] * inv;
    cen[4 * t] = px;
    cen[4 * t + 1] = py;
    cen[4 * t + 2] = floorf(px);
    cen[4 * t + 3] = floorf(py);
  }
  __syncthreads();
  const int cells = kp * kp;
  for (int t = threadIdx.x; t < nrows * num_levels * cells; t += blockDim.x) {
    const int win = t / cells;  // row * L + l
    const int c = t - win * cells;
    const int d = c / kp, e = c - d * kp;
    const int l = win % num_levels;
    const long long b = b0 + win / num_levels;
    const int s = lv.size[l];
    const float yy = cen[4 * win + 3] - (float)radius + (float)d;
    const float xx = cen[4 * win + 2] - (float)radius + (float)e;
    float v = 0.f;
    if (b < rows && yy >= 0.f && yy <= (float)(s - 1) && xx >= 0.f && xx <= (float)(s - 1))
      v = lv.map[l][b * (long long)s * s + (long long)yy * s + (long long)xx];
    patch[t] = v;
  }
  __syncthreads();
}

// Dynamic shared memory of a K7/K8 block of `nrows` rows: centres, patches
// and the row-blended taps T[i][e] (k x (k+1) per window).
inline size_t window_smem_bytes(int nrows, int num_levels, int radius) {
  const size_t k = 2 * radius + 1;
  return sizeof(float) * nrows * num_levels * (4 + (k + 1) * (k + 1) + k * (k + 1));
}
