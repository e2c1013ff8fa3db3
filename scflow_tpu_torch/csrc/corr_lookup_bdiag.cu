// K8: the corr lookup with K1's tent numerics over all levels in one pass.
//
// Replaces: scflow_tpu/ops/pallas/corr_lookup.py::_kernel_bdiag (`:41`).
// The TPU kernel concatenates the levels on the contraction axis so that
// one block-diagonal matmul per tap serves all four levels: 2k matrix-unit
// dispatches in place of 2kL, a fix for dispatch latency on tiny levels.
// Its numbers are the tent kernel's:
//   out[j*k+i] = sum_{h,w} wy[i,h] wx[j,w] m[h,w],
//   wy[i,h] = max(0, 1 - |(py + i - r) - h|)  (likewise wx),
// rows first, then columns.  Hopper has no dispatch cost to amortise; what
// carries over is one pass over all levels: a block stages the window
// cells of every level of its rows together (stage_windows in
// corr_common.cuh, (k+1)^2 cells per row and level, zeros outside) and
// evaluates the two nonzero tent weights per axis on them.  The other
// cells' weights are exactly 0 (the centre plus an integer offset rounds
// into [floor + offset, floor + offset + 1]), so the sums are the tent
// sums.  Held to the plain tent version at K1's atol 1e-4 (the plain
// version's matrix products may sum with FMAs; this file builds with
// -fmad=false).
//
// Bound on an H100 SXM (3.35 TB/s): memory, as K1 and K7.

#include "corr_common.cuh"

#define ROWS 8

__device__ __forceinline__ float tent(float u) { return fmaxf(0.f, 1.f - fabsf(u)); }

__global__ void corr_lookup_bdiag_kernel(const float* __restrict__ coords, Levels lv,
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

  // rows: tmp[i][e] = wy[i, h0] m[h0][.] + wy[i, h0 + 1] m[h0 + 1][.],
  // h0 = floor(py) - r + i
  for (int t = threadIdx.x; t < nrows * num_levels * k * kp; t += blockDim.x) {
    const int win = t / (k * kp);
    const int c = t - win * k * kp;
    const int i = c / kp, e = c - i * kp;
    const float y = cen[4 * win + 1] + (float)(i - radius);
    const float h0 = cen[4 * win + 3] + (float)(i - radius);
    const float* p = patch + win * kp * kp;
    tmp[t] = tent(y - h0) * p[i * kp + e] + tent(y - (h0 + 1.f)) * p[(i + 1) * kp + e];
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
    const float px = cen[4 * win], py = cen[4 * win + 1];
    const float x = px + (float)(j - radius);
    const float w0 = cen[4 * win + 2] + (float)(j - radius);
    const float* row = tmp + (win * k + i) * kp;
    float v = tent(x - w0) * row[j] + tent(x - (w0 + 1.f)) * row[j + 1];
    if (isnan(px) || isnan(py)) v = px + py;  // NaN, as the tent form gives
    out[b0 * per_row + t] = v;
  }
}

extern "C" int corr_lookup_bdiag_launch(const float* coords, const float* m0,
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
  corr_lookup_bdiag_kernel<<<(unsigned)blocks, 256, smem, stream>>>(coords, lv, num_levels,
                                                                   radius, rows, out);
  return (int)cudaGetLastError();
}
