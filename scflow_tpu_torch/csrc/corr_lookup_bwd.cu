// K1b: the backward of the corr lookup (K1, K7 and K8 share it).
//
// Replaces: scflow_tpu/ops/pallas/corr_lookup.py::_lookup_bwd (`:346-394`),
// the XLA einsums that corr_lookup_pallas_diff pairs with the Pallas
// forward.  With g the output gradient (row b, level l, tap (j, i)) and the
// tent weights wx[j,w] = max(0, 1 - |ux|), ux = (px + j - r) - w (likewise
// wy), it computes
//   grad_m[h,w] = sum_i wy[i,h] * a[i,w],  a[i,w] = sum_j g[j,i] wx[j,w],
// for every cell of every level (0 where no tap reaches), and, if asked,
//   d/dcx = sum_l 2^-l sum_{j,i,w} g[j,i] dwx[j,w] t2[i,w],
//   t2[i,w] = sum_h wy[i,h] m[h,w],  dwx = -sign(ux) where |ux| < 1, else 0
// (likewise d/dcy with t3[j,h] = sum_w wx[j,w] m[h,w]).  The derivative is
// 0 at the tent's kinks: an integer window centre (ux = 0) gives 0, as
// _lookup_bwd's jnp.sign does.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  The dense gradient is written
// whole, every cell of every level: at the training shape (16 x 32^2 =
// 16,384 rows, levels 32^2..4^2) 16,384 x 1,360 x 4 B = 89 MB, about 27 us;
// g (21 MB) and the window cells add little.
//
// Design: one block per row.  The row's g (L*k*k floats) is staged in
// shared memory; each thread then owns cells of the dense row and computes
// its cell's sum from the (at most 2 x 2) taps whose weights reach it, in
// _lookup_bwd's order (over j, then over i).  Rows never share a cell, so
// there are no atomics and every write is a coalesced run of the row.  For
// the flow gradient the row's (k+1)^2 window cells of each level are staged
// too; a thread per tap forms its two terms, and one thread per level sums
// its level's taps in tap order, so the result does not depend on timing.
// Built with -fmad=false, as the plain version's separate products and sums.

#include "corr_common.cuh"

#define THREADS 256

struct GradLevels {
  float* map[MAX_LEVELS];
};

__device__ __forceinline__ float tent(float u) { return fmaxf(0.f, 1.f - fabsf(u)); }

__device__ __forceinline__ float dtent(float u) {
  // -sign(u) where |u| < 1; 0 at u = 0 and outside
  return fabsf(u) < 1.f ? (u > 0.f ? -1.f : (u < 0.f ? 1.f : 0.f)) : 0.f;
}

__global__ void corr_lookup_bwd_kernel(const float* __restrict__ coords,
                                       const float* __restrict__ grad_out, Levels lv,
                                       GradLevels gl, int num_levels, int radius,
                                       float* __restrict__ grad_coords) {
  extern __shared__ float smem[];
  __shared__ float cen[MAX_LEVELS][4];  // px, py, floor(px), floor(py)
  __shared__ float lev_sum[MAX_LEVELS][2];
  const int k = 2 * radius + 1, kp = k + 1, kk = k * k;
  const int per_row = num_levels * kk;
  const long long b = blockIdx.x;
  float* g = smem;                              // per_row, [l][j][i]
  float* patch = g + per_row;                   // L * kp * kp
  float* tap_x = patch + num_levels * kp * kp;  // per_row
  float* tap_y = tap_x + per_row;               // per_row

  const float cx = coords[2 * b], cy = coords[2 * b + 1];
  const bool nan_row = isnan(cx) || isnan(cy);
  for (int t = threadIdx.x; t < per_row; t += blockDim.x) g[t] = grad_out[b * per_row + t];
  if (threadIdx.x < num_levels) {
    const float inv = ldexpf(1.f, -(int)threadIdx.x);
    const float px = cx * inv, py = cy * inv;
    cen[threadIdx.x][0] = px;
    cen[threadIdx.x][1] = py;
    cen[threadIdx.x][2] = floorf(px);
    cen[threadIdx.x][3] = floorf(py);
  }
  __syncthreads();

  // dense gradient of every level
  for (int l = 0; l < num_levels; ++l) {
    const int s = lv.size[l];
    const float px = cen[l][0], py = cen[l][1];
    const float x0 = cen[l][2] - (float)radius, y0 = cen[l][3] - (float)radius;
    const float* gll = g + l * kk;
    float* dst = gl.map[l] + b * (long long)s * s;
    for (int c = threadIdx.x; c < s * s; c += blockDim.x) {
      const int h = c / s, w = c - h * s;
      const float d = (float)h - y0, e = (float)w - x0;  // place in the window
      float v = 0.f;
      if (nan_row) {
        v = cx + cy;
      } else if (d >= 0.f && d <= (float)k && e >= 0.f && e <= (float)k) {
        const int di = (int)d, ei = (int)e;
        for (int i = max(di - 1, 0); i <= min(di, k - 1); ++i) {
          float a = 0.f;
          for (int j = max(ei - 1, 0); j <= min(ei, k - 1); ++j)
            a = a + gll[j * k + i] * tent((px + (float)(j - radius)) - (float)w);
          v = v + tent((py + (float)(i - radius)) - (float)h) * a;
        }
      }
      dst[c] = v;
    }
  }
  if (grad_coords == nullptr) return;

  // the window cells of every level, zeros outside
  for (int t = threadIdx.x; t < num_levels * kp * kp; t += blockDim.x) {
    const int l = t / (kp * kp);
    const int c = t - l * kp * kp;
    const int d = c / kp, e = c - d * kp;
    const int s = lv.size[l];
    const float yy = cen[l][3] - (float)radius + (float)d;
    const float xx = cen[l][2] - (float)radius + (float)e;
    float v = 0.f;
    if (yy >= 0.f && yy <= (float)(s - 1) && xx >= 0.f && xx <= (float)(s - 1))
      v = lv.map[l][b * (long long)s * s + (long long)yy * s + (long long)xx];
    patch[t] = v;
  }
  __syncthreads();

  // each tap's terms of d/dpx and d/dpy: the cells with a nonzero
  // derivative are the window columns j, j+1 (rows i, i+1)
  for (int t = threadIdx.x; t < per_row; t += blockDim.x) {
    const int l = t / kk;
    const int tap = t - l * kk;
    const int j = tap / k, i = tap - j * k;
    const float* p = patch + l * kp * kp;
    const float x = cen[l][0] + (float)(j - radius), y = cen[l][1] + (float)(i - radius);
    const float w0 = cen[l][2] + (float)(j - radius), h0 = cen[l][3] + (float)(i - radius);
    const float wy0 = tent(y - h0), wy1 = tent(y - (h0 + 1.f));
    const float wx0 = tent(x - w0), wx1 = tent(x - (w0 + 1.f));
    float sx = 0.f, sy = 0.f;
    for (int e = 0; e < 2; ++e) {  // t2[i, w0 + e]
      const float t2 = wy0 * p[i * kp + j + e] + wy1 * p[(i + 1) * kp + j + e];
      sx = sx + dtent(x - (w0 + (float)e)) * t2;
    }
    for (int d = 0; d < 2; ++d) {  // t3[j, h0 + d]
      const float t3 = wx0 * p[(i + d) * kp + j] + wx1 * p[(i + d) * kp + j + 1];
      sy = sy + dtent(y - (h0 + (float)d)) * t3;
    }
    tap_x[t] = g[t] * sx;
    tap_y[t] = g[t] * sy;
  }
  __syncthreads();
  if (threadIdx.x < num_levels) {
    const int l = threadIdx.x;
    float sx = 0.f, sy = 0.f;
    for (int t = l * kk; t < (l + 1) * kk; ++t) {
      sx = sx + tap_x[t];
      sy = sy + tap_y[t];
    }
    lev_sum[l][0] = sx;
    lev_sum[l][1] = sy;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float gx = 0.f, gy = 0.f;
    for (int l = 0; l < num_levels; ++l) {
      const float inv = ldexpf(1.f, -l);
      gx = gx + lev_sum[l][0] * inv;
      gy = gy + lev_sum[l][1] * inv;
    }
    if (nan_row) gx = gy = cx + cy;  // NaN, as the tent form gives
    grad_coords[2 * b] = gx;
    grad_coords[2 * b + 1] = gy;
  }
}

extern "C" int corr_lookup_bwd_launch(const float* coords, const float* grad_out,
                                      const float* m0, const float* m1, const float* m2,
                                      const float* m3, int s0, int s1, int s2, int s3,
                                      float* g0, float* g1, float* g2, float* g3,
                                      int num_levels, int radius, long long rows,
                                      float* grad_coords, cudaStream_t stream) {
  if (num_levels < 1 || num_levels > MAX_LEVELS || radius < 0)
    return (int)cudaErrorInvalidValue;
  Levels lv = {{m0, m1, m2, m3}, {s0, s1, s2, s3}};
  GradLevels gl = {{g0, g1, g2, g3}};
  const size_t k = 2 * radius + 1;
  const size_t smem = sizeof(float) * num_levels * (3 * k * k + (k + 1) * (k + 1));
  if (smem > 48 * 1024 || rows > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  corr_lookup_bwd_kernel<<<(unsigned)rows, THREADS, smem, stream>>>(
      coords, grad_out, lv, gl, num_levels, radius, grad_coords);
  return (int)cudaGetLastError();
}
