// K7: the corr lookup in its "shift" formulation.
//
// Replaces: scflow_tpu/ops/pallas/corr_lookup.py::_kernel_shift (`:147`).
// The TPU kernel picks the k+1 integer rows of each window with exact 0/1
// one-hot products (cheaper on its vector unit than k dense tent products),
// blends adjacent rows with the shared fraction fy, then does the same for
// columns:
//   T[i][w]    = (1 - fy) * m[y0 - r + i][w] + fy * m[y0 - r + i + 1][w]
//   out[j*k+i] = (1 - fx) * T[i][x0 - r + j] + fx * T[i][x0 - r + j + 1]
// with x0 = floor(px), fx = px - x0 (likewise y), zeros outside the map.
// The one-hot pass has nothing to save on Hopper, where a gather is cheap;
// what carries over is the arithmetic, which this kernel keeps exactly:
// built with -fmad=false, each blend is two products and a sum rounded as
// the plain PyTorch version rounds them, so the two agree bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s): memory, as K1.  At the flagship shape
// (65,536 rows, levels 32^2..4^2, r = 4) it writes 85 MB and reads at most
// (k+1)^2 cells per row and level.
//
// Design: a block takes ROWS rows; stage_windows (corr_common.cuh) brings
// every row's (k+1)^2 window cells of all levels into shared memory at
// once, then the row blends and the column blends run from shared memory,
// and the block writes its ROWS * L*k*k outputs as one contiguous range.

#include "corr_common.cuh"

#define ROWS 8

__global__ void corr_lookup_shift_kernel(const float* __restrict__ coords, Levels lv,
                                         int num_levels, int radius, long long rows,
                                         float* __restrict__ out) {
  extern __shared__ float smem[];
  const int k = 2 * radius + 1, kp = k + 1;
  const long long b0 = (long long)blockIdx.x * ROWS;
  const int nrows = rows - b0 < ROWS ? (int)(rows - b0) : ROWS;
  const int wins = ROWS * num_levels;
  float* cen = smem;
  float* patch = cen + 4 * wins;
  float* tmp = patch + wins * kp * kp;  // tmp[(win * k + i) * kp + e]
  stage_windows(coords, lv, num_levels, radius, rows, b0, nrows, cen, patch);

  for (int t = threadIdx.x; t < nrows * num_levels * k * kp; t += blockDim.x) {
    const int win = t / (k * kp);
    const int c = t - win * k * kp;
    const int i = c / kp, e = c - i * kp;
    const float fy = cen[4 * win + 1] - cen[4 * win + 3];
    const float* p = patch + win * kp * kp;
    tmp[t] = (1.f - fy) * p[i * kp + e] + fy * p[(i + 1) * kp + e];
  }
  __syncthreads();

  const int per_row = num_levels * k * k;
  for (int t = threadIdx.x; t < nrows * per_row; t += blockDim.x) {
    const int r = t / per_row;
    const int c = t - r * per_row;
    const int l = c / (k * k);
    const int tap = c - l * k * k;
    const int j = tap / k, i = tap - j * k;
    const int win = r * num_levels + l;
    const float fx = cen[4 * win] - cen[4 * win + 2];
    const float* row = tmp + (win * k + i) * kp;
    out[b0 * per_row + t] = (1.f - fx) * row[j] + fx * row[j + 1];
  }
}

extern "C" int corr_lookup_shift_launch(const float* coords, const float* m0,
                                        const float* m1, const float* m2,
                                        const float* m3, int s0, int s1, int s2,
                                        int s3, int num_levels, int radius,
                                        long long rows, float* out,
                                        cudaStream_t stream) {
  if (num_levels < 1 || num_levels > MAX_LEVELS || radius < 0)
    return (int)cudaErrorInvalidValue;
  Levels lv = {{m0, m1, m2, m3}, {s0, s1, s2, s3}};
  const size_t smem = window_smem_bytes(ROWS, num_levels, radius);
  const long long blocks = (rows + ROWS - 1) / ROWS;
  if (smem > 48 * 1024 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  corr_lookup_shift_kernel<<<(unsigned)blocks, 256, smem, stream>>>(coords, lv, num_levels,
                                                                   radius, rows, out);
  return (int)cudaGetLastError();
}
