// K1b: the backward of the corr lookup (K1, K7 and K8 share it).
//
// Replaces: scflow_tpu/ops/pallas/corr_lookup.py::_lookup_bwd (`:346-394`),
// the XLA einsums that corr_lookup_pallas_diff pairs with the Pallas
// forward.  With g the output gradient (row b, level l, tap (j, i)) and the
// tent weights wx[j,w] = max(0, 1 - |ux|), ux = (px + j - r) - w (likewise
// wy), it computes
//   grad_m[h,w] = sum_i wy[i,h] a[i,w],  a[i,w] = sum_j g[j,i] wx[j,w],
// for every cell of every level (0 where no tap reaches), and, if asked,
//   d/dcx = sum_l 2^-l sum_{j,i,w} g[j,i] dwx[j,w] t2[i,w],
//   t2[i,w] = sum_h wy[i,h] m[h,w],  dwx = -sign(ux) where |ux| < 1, else 0
// (likewise d/dcy with t3[j,h] = sum_w wx[j,w] m[h,w]).  The derivative is
// 0 at the tent's kinks: an integer window centre (ux = 0) gives 0, as
// _lookup_bwd's jnp.sign does.  A NaN centre makes its row's gradients NaN.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  The dense gradient is written
// whole, every cell of every level: at the training shape (16 x 32^2 =
// 16,384 rows, levels 32^2..4^2) 16,384 x 1,360 x 4 B = 89 MB, and g is read
// once (21 MB): about 33 us.  Only the (k+1)^2 cells of each row's window
// are non-zero (at most a fifth of the 89 MB at that shape), so the kernel
// is a dense write of mostly zeros behind a little arithmetic.
//
// Design.  The first K1b (one 256-thread block per row) started each of its
// 16,384 short blocks with a dependent load of the row's g and a barrier,
// paid a run-time division per dense cell, stored 4 bytes at a time and
// left 75-94% of its threads idle on the 8^2 and 4^2 maps.  Here:
// - the radius is a template argument (0-15) and the level count (up to
//   four) a run-time one; each thread splits its work once,
//   before the loops, and walks (row, h, w) incrementally, so no loop
//   divides at run time (windows are indexed level-major, win = l*G + row,
//   so every other split divides by a compile-time constant);
// - blocks are persistent over groups of G rows (8, 4 or 2 by radius):
//   the group's g (one contiguous range of G*L*k*k floats: 16-byte
//   cp.async where aligned), centres (and, for the flow gradient, its
//   window cells, 4-byte cp.async with src-size 0 outside the map) arrive
//   in one stage of a two-stage ring while the previous group is written;
// - the window first, then the stream: for each (row, level) the (k+1)^2
//   non-zero cells are formed once into shared memory, in _lookup_bwd's
//   order (the sum over j, then over i), and every thread of the block then
//   writes the dense maps of the group, level by level (a level's G rows
//   are one contiguous range), zeros outside the window, with 16-byte
//   streaming stores where S^2 % 4 == 0 and the level is 16-byte aligned
//   (every flagship level), 4-byte stores otherwise.  One launch writes
//   every cell: no memset, no scatter, no atomics;
// - the flow gradient: one thread per tap forms its two terms, and one
//   thread per (row, level) sums its level's taps in tap order, the row's
//   levels then in level order (warp shuffles), so two launches give the
//   same bits.
// Built with -fmad=false, as the plain version's separate products and sums.
//
// bfloat16 maps (corr_lookup_bwd_bf16_launch): `_lookup_bwd` returns each
// level's gradient in the map's dtype, `.astype(corr.dtype)` of its fp32
// sums, and reads the map upcast for the flow gradient.  So the bf16
// instance sums in fp32 as above and rounds each dense value once, to
// nearest even (__float2bfloat16_rn), storing 8 values per 16-byte store
// where S^2 % 8 == 0 and the level is 16-byte aligned (2-byte stores
// otherwise): the dense stores, most of the bound, halve.  For the flow
// gradient the window cells arrive as the forward kernels stage them, in
// aligned 4-byte words (cp.async has no 2-byte form), and are upcast into a
// float patch before the tap terms read them.  g, the centres and the flow
// gradient stay fp32.

#include "corr_common.cuh"

#define BWD_THREADS 256
#define BWD_MAX_RADIUS 15  // the pipeline instances this source builds: radius 0-15
// Any other window (a larger radius, more than four levels, or stages past a
// block's shared memory) takes the generic kernels at the end of this file.

template <class T>
struct GradLevelsT {
  T* map[GROUP_LEVELS];
};

__device__ __forceinline__ float tent(float u) { return fmaxf(0.f, 1.f - fabsf(u)); }

__device__ __forceinline__ float dtent(float u) {
  // -sign(u) where |u| < 1; 0 at u = 0 and outside
  return fabsf(u) < 1.f ? (u > 0.f ? -1.f : (u < 0.f ? 1.f : 0.f)) : 0.f;
}

// 2^-l, exactly
__device__ __forceinline__ float level_scale(int l) { return __int_as_float((127 - l) << 23); }

// bfloat16 maps: the window (origin floor(px) - R, floor(py) - R) of row b
// (on: b exists) as the forward kernels stage it (corr_common.cuh), one
// word (row d, word column w) per call.  xs and yb as floats, tested before
// any int cast, so a NaN or far-away centre reads nothing.
template <int R>
__device__ __forceinline__ void word_of(long long b, bool on, int s, float x0f, float y0f, int d,
                                        int w, long long* lo, int* e, bool* row_in, int* xs) {
  const bool xok = x0f >= -(float)(R + 2) && x0f <= (float)(s + R);
  const float yf = y0f - (float)R + (float)d;
  *row_in = on && xok && yf >= 0.f && yf <= (float)(s - 1);
  *xs = *row_in ? (int)x0f - R : 0;
  const long long first = *row_in ? b * (long long)s * s + (long long)(int)yf * s + *xs : 0;
  const int par = (int)(first & 1);
  *lo = first - par + 2 * w;
  *e = 2 * w - par;
}

template <int R>
__device__ __forceinline__ void stage_word_r(uint32_t* dst, const __nv_bfloat16* map, long long b,
                                             bool on, long long rows, int s, float x0f, float y0f,
                                             int d, int w) {
  long long lo;
  int e, xs;
  bool row_in;
  word_of<R>(b, on, s, x0f, y0f, d, w, &lo, &e, &row_in, &xs);
  const bool any =
      row_in && ((unsigned)(xs + e) < (unsigned)s || (unsigned)(xs + e + 1) < (unsigned)s);
  const long long total = rows * (long long)s * s;
  cp_async_word(dst, map + (any ? lo : 0), any ? (lo + 2 <= total ? 4 : 2) : 0);
}

// row d of a window's float cells (cells[e], e = 0..k) from its word w
template <int R>
__device__ __forceinline__ void upcast_word_r(float* cells, uint32_t word, long long b, bool on,
                                              int s, float x0f, float y0f, int d, int w) {
  constexpr int KP = 2 * R + 2;
  long long lo;
  int e, xs;
  bool row_in;
  word_of<R>(b, on, s, x0f, y0f, d, w, &lo, &e, &row_in, &xs);
  if (e >= 0 && e < KP)
    cells[e] = row_in && (unsigned)(xs + e) < (unsigned)s ? bf16_lo(word) : 0.f;
  if (e + 1 < KP)
    cells[e + 1] = row_in && (unsigned)(xs + e + 1) < (unsigned)s ? bf16_hi(word) : 0.f;
}

// The shared-memory layout at radius R on maps of cell type T.  Floats of
// one ring stage at L levels: g (G*L*k*k, padded to 4), the centres (2G),
// for the flow gradient the window cells of the maps (G*L*(k+1)^2; for
// bfloat16 maps the 4-byte words that hold them, G*L*(k+1)*(r+2), as the
// forward kernels stage them: corr_common.cuh).  Then the formed windows
// (two buffers of G*L*(k+1)^2), their origins (two buffers of G*L int4:
// x, y, fill value), for the flow gradient the tap terms (2*G*L*k*k) and,
// for bfloat16 maps, the window cells upcast to float (G*L*(k+1)^2).
template <int R, class T = float>
struct BwdWindow {
  static constexpr int K = 2 * R + 1, KP = K + 1, KK = K * K, KP2 = KP * KP, NW = R + 2;
  static constexpr bool BF = is_bf16<T>();
  // 4-byte units of one window's staged cells
  static constexpr int RAW = BF ? KP * NW : KP2;
  // cells per 16-byte store of the dense gradient
  static constexpr int VW = 16 / sizeof(T);
  // rows per group: 8 up to radius 4 (at the training shape 0.0629 ms of
  // device time against 0.0660 with 4 rows, H100 700 W), 4 up to radius 9,
  // then 2, so that two stages of four levels fit up to radius 14 with the
  // flow gradient (223 KB)
  static constexpr int G = R <= 4 ? 8 : (R <= 9 ? 4 : 2);
  __host__ __device__ static constexpr int gpad(int L) { return (G * L * KK + 3) / 4 * 4; }
  __host__ __device__ static constexpr int stage(int L, bool c) {
    return gpad(L) + 2 * G + (c ? G * L * RAW : 0);
  }
  static constexpr size_t smem(int L, bool c) {
    return sizeof(float) * (2 * stage(L, c) + 2 * G * L * KP2 + 2 * G * L * 4 +
                            (c ? 2 * G * L * KK : 0) + (c && BF ? G * L * KP2 : 0));
  }
};

template <int R, bool COORDS, class C>
__global__ void __launch_bounds__(BWD_THREADS)
    lookup_bwd_kernel(const float* __restrict__ coords, const float* __restrict__ grad_out,
                      LevelsT<C> lv, GradLevelsT<C> gl, int L, long long rows, long long groups,
                      int vec_g, int vec_out, float* __restrict__ grad_coords) {
  using W = BwdWindow<R, C>;
  constexpr int G = W::G, K = W::K, KP = W::KP, KK = W::KK, KP2 = W::KP2, NW = W::NW;
  constexpr int T = BWD_THREADS, VW = W::VW;
  constexpr bool BF = W::BF;
  extern __shared__ __align__(16) float smem[];
  __shared__ int lsize[GROUP_LEVELS];
  __shared__ const C* lmap[GROUP_LEVELS];
  const int tid = threadIdx.x;
  const int nwin = G * L;  // windows of a group, level-major: win = l * G + row
  const int gsz = G * L * KK;
  const int gpad = W::gpad(L), stage_f = W::stage(L, COORDS);
  float* const winbuf = smem + 2 * stage_f;                           // [2][nwin * KP2]
  int4* const orgbuf = reinterpret_cast<int4*>(winbuf + 2 * nwin * KP2);  // [2][nwin]
  float* const taps = reinterpret_cast<float*>(orgbuf + 2 * nwin);     // [2][nwin * KK]
  float* const fpatch = taps + 2 * nwin * KK;  // bf16, flow gradient: [nwin * KP2]
  if (tid < GROUP_LEVELS) {
    lsize[tid] = lv.size[tid];
    lmap[tid] = lv.map[tid];
  }

  // This thread's dense-write walk of each level, split once: its first
  // cell (row, h, w) of the group's level block, and the step between its
  // chunks (T chunks of V cells) as (rows, h, w); V = VW (4 floats or 8
  // bfloat16s) where the level takes 16-byte stores.
  int r0[GROUP_LEVELS], h0[GROUP_LEVELS], w0[GROUP_LEVELS];
  int dr[GROUP_LEVELS], dh[GROUP_LEVELS], dw[GROUP_LEVELS];
#pragma unroll
  for (int l = 0; l < GROUP_LEVELS; ++l) {
    const int s = l < L ? lv.size[l] : 1, s2 = s * s;
    const int v = (vec_out >> l) & 1 ? VW : 1;
    int c = tid * v;
    r0[l] = c / s2;
    c -= r0[l] * s2;
    h0[l] = c / s;
    w0[l] = c - h0[l] * s;
    c = T * v;
    dr[l] = c / s2;
    c -= dr[l] * s2;
    dh[l] = c / s;
    dw[l] = c - dh[l] * s;
  }
  __syncthreads();  // lsize, lmap

  auto stage_group = [&](long long grp, int buf) {
    float* st = smem + buf * stage_f;
    const long long b0 = grp * G;
    const int nrows = rows - b0 < G ? (int)(rows - b0) : G;
    const float* src = grad_out + b0 * (L * KK);
    if (vec_g && nrows == G) {
      for (int q = tid; q < gsz / 4; q += T) cp_async16(st + 4 * q, src + 4 * q);
    } else {
      const int valid = nrows * L * KK;
      for (int q = tid; q < gsz; q += T) cp_async4(st + q, src + (q < valid ? q : 0), q < valid);
    }
    if (tid < 2 * G)
      cp_async4(st + gpad + tid, coords + 2 * b0 + (tid < 2 * nrows ? tid : 0), tid < 2 * nrows);
    if constexpr (COORDS && BF) {
      // the 4-byte words that hold the window cells: window win, row d,
      // word column w (corr_common.cuh's bf16 staging)
      uint32_t* raw = reinterpret_cast<uint32_t*>(st + gpad + 2 * G);
      for (int q = tid; q < nwin * KP * NW; q += T) {
        const int win = q / (KP * NW), c = q - win * (KP * NW);
        const int d = c / NW, w = c - d * NW;
        const int l = win / G, row = win - l * G;
        const int s = lsize[l];
        const long long b = b0 + (row < nrows ? row : 0);
        const float sc = level_scale(l);
        stage_word_r<R>(raw + win * W::RAW + d * NW + w, lmap[l], b, row < nrows, rows, s,
                        floorf(coords[2 * b] * sc), floorf(coords[2 * b + 1] * sc), d, w);
      }
    } else if constexpr (COORDS) {
      // the window cells of the maps, m[floor(py) - R + d][floor(px) - R + e]
      float* patch = st + gpad + 2 * G;
      for (int q = tid; q < nwin * KP2; q += T) {
        const int win = q / KP2, c = q - win * KP2;
        const int d = c / KP, e = c - d * KP;
        const int l = win / G, row = win - l * G;
        const int s = lsize[l];
        const long long b = b0 + (row < nrows ? row : 0);
        const float sc = level_scale(l);
        const float xx = floorf(coords[2 * b] * sc) - (float)R + (float)e;
        const float yy = floorf(coords[2 * b + 1] * sc) - (float)R + (float)d;
        const bool in = row < nrows && xx >= 0.f && xx <= (float)(s - 1) && yy >= 0.f &&
                        yy <= (float)(s - 1);
        const float* cp = lmap[l] + (in ? b * (long long)s * s + (int)yy * s + (int)xx : 0LL);
        cp_async4(patch + q, cp, in);
      }
    }
  };

  long long g = blockIdx.x;
  stage_group(g, 0);
  cp_async_commit();
  for (int n = 0; g < groups; ++n, g += gridDim.x) {
    const int buf = n & 1;
    const long long gn = g + gridDim.x;
    if (gn < groups) stage_group(gn, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of group g are in
    __syncthreads();

    const float* st = smem + buf * stage_f;
    const float* xy = st + gpad;
    float* win = winbuf + buf * nwin * KP2;
    int4* org = orgbuf + buf * nwin;
    const long long b0 = g * G;
    const int nrows = rows - b0 < G ? (int)(rows - b0) : G;

    if constexpr (COORDS && BF) {
      // upcast the window cells of the group, 0 outside the map
      const uint32_t* raw = reinterpret_cast<const uint32_t*>(xy + 2 * G);
      for (int q = tid; q < nwin * KP * NW; q += T) {
        const int wn = q / (KP * NW), c = q - wn * (KP * NW);
        const int d = c / NW, w = c - d * NW;
        const int l = wn / G, row = wn - l * G;
        const int s = lsize[l];
        const long long b = b0 + (row < nrows ? row : 0);
        const float sc = level_scale(l);
        upcast_word_r<R>(fpatch + wn * KP2 + d * KP, raw[wn * W::RAW + d * NW + w], b,
                         row < nrows, s, floorf(xy[2 * row] * sc), floorf(xy[2 * row + 1] * sc),
                         d, w);
      }
    }
    // each window's origin and the value outside it: 0, or NaN for a NaN
    // centre; a window that misses the map (or a NaN one) gets an origin
    // that leaves every cell outside
    if (tid < nwin) {
      const int l = tid / G, row = tid - l * G;
      const float cx = xy[2 * row], cy = xy[2 * row + 1], sc = level_scale(l);
      const float xo = floorf(cx * sc) - (float)R, yo = floorf(cy * sc) - (float)R;
      const float hi = (float)(lsize[l] - 1);
      const bool on = xo + (float)K >= 0.f && xo <= hi && yo + (float)K >= 0.f && yo <= hi;
      const float fill = (isnan(cx) || isnan(cy)) ? cx + cy : 0.f;
      org[tid] = on ? make_int4((int)xo, (int)yo, __float_as_int(fill), 0)
                    : make_int4(-(1 << 30), -(1 << 30), __float_as_int(fill), 0);
    }
    // the window's cells: cell (d, e) is map cell (yo + d, xo + e); taps
    // i in {d-1, d} and j in {e-1, e} reach it, summed over j, then over i
    for (int q = tid; q < nwin * KP2; q += T) {
      const int w_ = q / KP2, c = q - w_ * KP2;
      const int d = c / KP, e = c - d * KP;
      const int l = w_ / G, row = w_ - l * G;
      const float sc = level_scale(l);
      const float px = xy[2 * row] * sc, py = xy[2 * row + 1] * sc;
      const float w = floorf(px) - (float)R + (float)e, h = floorf(py) - (float)R + (float)d;
      const float* gw = st + row * (L * KK) + l * KK;  // g[j * K + i]
      float v = 0.f;
#pragma unroll
      for (int di = 1; di >= 0; --di) {
        const int i = d - di;
        if (i < 0 || i >= K) continue;
        float a = 0.f;
#pragma unroll
        for (int dj = 1; dj >= 0; --dj) {
          const int j = e - dj;
          if (j < 0 || j >= K) continue;
          a = a + gw[j * K + i] * tent((px + (float)(j - R)) - w);
        }
        v = v + tent((py + (float)(i - R)) - h) * a;
      }
      win[q] = v;
    }
    if constexpr (COORDS && BF) __syncthreads();  // the upcast cells
    if (COORDS) {
      // each tap's terms of d/dpx and d/dpy: the cells with a nonzero
      // derivative are the window columns j, j+1 (rows i, i+1)
      const float* patch = BF ? fpatch : st + gpad + 2 * G;
      for (int q = tid; q < nwin * KK; q += T) {
        const int w_ = q / KK, t = q - w_ * KK;
        const int j = t / K, i = t - j * K;
        const int l = w_ / G, row = w_ - l * G;
        const float sc = level_scale(l);
        const float px = xy[2 * row] * sc, py = xy[2 * row + 1] * sc;
        const float* p = patch + w_ * KP2;
        const float x = px + (float)(j - R), y = py + (float)(i - R);
        const float xw = floorf(px) + (float)(j - R), yh = floorf(py) + (float)(i - R);
        const float wy0 = tent(y - yh), wy1 = tent(y - (yh + 1.f));
        const float wx0 = tent(x - xw), wx1 = tent(x - (xw + 1.f));
        float sx = 0.f, sy = 0.f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // t2[i, xw + e]
          const float t2 = wy0 * p[i * KP + j + e] + wy1 * p[(i + 1) * KP + j + e];
          sx = sx + dtent(x - (xw + (float)e)) * t2;
        }
#pragma unroll
        for (int d = 0; d < 2; ++d) {  // t3[j, yh + d]
          const float t3 = wx0 * p[(i + d) * KP + j] + wx1 * p[(i + d) * KP + j + 1];
          sy = sy + dtent(y - (yh + (float)d)) * t3;
        }
        const float gv = st[row * (L * KK) + l * KK + t];
        taps[q] = gv * sx;
        taps[nwin * KK + q] = gv * sy;
      }
    }
    __syncthreads();

    if (COORDS && tid < 32) {
      // one lane per window sums its taps in tap order; the row's lane then
      // sums its levels in level order
      float sx = 0.f, sy = 0.f;
      if (tid < nwin) {
        for (int t = 0; t < KK; ++t) {
          sx = sx + taps[tid * KK + t];
          sy = sy + taps[nwin * KK + tid * KK + t];
        }
      }
      float gx = 0.f, gy = 0.f;
#pragma unroll
      for (int l = 0; l < GROUP_LEVELS; ++l) {
        const float lx = __shfl_sync(0xffffffffu, sx, (l * G + tid) & 31);
        const float ly = __shfl_sync(0xffffffffu, sy, (l * G + tid) & 31);
        if (l < L) {
          gx = gx + lx * level_scale(l);
          gy = gy + ly * level_scale(l);
        }
      }
      if (tid < nrows) {
        const float cx = xy[2 * tid], cy = xy[2 * tid + 1];
        if (isnan(cx) || isnan(cy)) gx = gy = cx + cy;  // NaN, as the tent form gives
        grad_coords[2 * (b0 + tid)] = gx;
        grad_coords[2 * (b0 + tid) + 1] = gy;
      }
    }

    // the dense maps of the group, level by level
#pragma unroll
    for (int l = 0; l < GROUP_LEVELS; ++l) {
      if (l >= L) break;
      const int s = lv.size[l];
      const long long s2 = (long long)s * s;
      C* dst = gl.map[l] + b0 * s2;
      const float* wl = win + l * G * KP2;
      const int4* ol = org + l * G;
      const bool vec = (vec_out >> l) & 1;
      const int step = vec ? VW * T : T;  // cells between this thread's chunks
      int row = r0[l], h = h0[l], w = w0[l];
      for (long long off = vec ? VW * tid : tid; row < nrows; off += step) {
        const int4 o = ol[row];
        const float fill = __int_as_float(o.z);
        const float* wr = wl + row * KP2;
        float v[VW];
        int hh = h, ww = w;
#pragma unroll
        for (int u = 0; u < VW; ++u) {
          if (u > 0 && !vec) break;
          const int d = hh - o.y, e = ww - o.x;
          v[u] = ((unsigned)d <= (unsigned)K && (unsigned)e <= (unsigned)K) ? wr[d * KP + e]
                                                                           : fill;
          if (++ww == s) {
            ww = 0;
            ++hh;
          }
        }
        if constexpr (BF) {
          // each value rounded once, to nearest even, from its float sum
          if (vec) {
            uint32_t pk[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const __nv_bfloat162 two = __floats2bfloat162_rn(v[2 * u], v[2 * u + 1]);
              pk[u] = *reinterpret_cast<const uint32_t*>(&two);
            }
            __stcs(reinterpret_cast<uint4*>(dst + off), make_uint4(pk[0], pk[1], pk[2], pk[3]));
          } else {
            dst[off] = __float2bfloat16_rn(v[0]);
          }
        } else {
          if (vec)
            __stcs(reinterpret_cast<float4*>(dst + off), make_float4(v[0], v[1], v[2], v[3]));
          else
            dst[off] = v[0];
        }
        // the next chunk: T chunks on, carried through w, h and row
        w += dw[l];
        if (w >= s) {
          w -= s;
          ++h;
        }
        h += dh[l];
        if (h >= s) {
          h -= s;
          ++row;
        }
        row += dr[l];
      }
    }
  }
}

template <int R, bool COORDS, class C>
int launch_bwd(const float* coords, const float* grad_out, const LevelsT<C>& lv,
               const GradLevelsT<C>& gl, int L, long long rows, float* grad_coords,
               cudaStream_t stream) {
  using W = BwdWindow<R, C>;
  auto kernel = lookup_bwd_kernel<R, COORDS, C>;
  const size_t smem = W::smem(L, COORDS);
  int sms = 0, optin = 0;
  int err = device_limits(&sms, &optin);
  if (err != 0) return err;
  // two ring stages and the windows at this level count must fit a block
  if (smem > (size_t)optin) return (int)cudaErrorInvalidConfiguration;
  static int per_sm[GROUP_LEVELS + 1] = {};  // resident blocks per SM, by level count
  err = resident_blocks(kernel, per_sm, L, BWD_THREADS,
                        [](int l) { return W::smem(l, COORDS); }, optin);
  if (err != 0) return err;
  const long long groups = (rows + W::G - 1) / W::G;
  const long long resident = (long long)per_sm[L] * sms;
  const unsigned grid = (unsigned)(groups < resident ? groups : resident);
  const int vec_g = ((uintptr_t)grad_out & 15) == 0 && (W::G * L * W::KK) % 4 == 0;
  int vec_out = 0;
  for (int l = 0; l < L; ++l)
    if ((long long)lv.size[l] * lv.size[l] % W::VW == 0 && ((uintptr_t)gl.map[l] & 15) == 0)
      vec_out |= 1 << l;
  kernel<<<grid, BWD_THREADS, smem, stream>>>(coords, grad_out, lv, gl, L, rows, groups, vec_g,
                                              vec_out, grad_coords);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The generic route of K1b, for the windows the pipeline does not take: a
// run-time radius, no staging, one launch per group of GROUP_LEVELS levels.
// generic_bwd_dense_kernel: a thread per dense cell (h, w) of a level
// (blockIdx.z), walking the rows blockIdx.y, + gridDim.y, ..., gathers the
// taps that reach the cell as the pipeline forms a window cell (the sum over
// j, then over i, in the same order and arithmetic) and writes it once (0
// outside the window, NaN for a NaN centre): every cell written, no memset,
// no atomics, the same bits from two launches.
// generic_bwd_coords_kernel: a thread per (row, level) sums the level's tap
// terms in tap order; a thread per row then sums the levels in level order,
// going on from an earlier group's sum: the pipeline's order.

#define GENERIC_COORD_ROWS 32  // rows per block of the flow-gradient kernel

template <class C>
__global__ void __launch_bounds__(GENERIC_THREADS)
    generic_bwd_dense_kernel(const float* __restrict__ coords, const float* __restrict__ grad_out,
                             LevelsT<C> lv, GradLevelsT<C> gl, int level0, int radius,
                             long long rows, long long gstride) {
  const int l = blockIdx.z;
  const int s = lv.size[l];
  const int c = blockIdx.x * GENERIC_THREADS + threadIdx.x;
  if (c >= s * s) return;
  const int hi = c / s, wi = c - hi * s;
  const int k = 2 * radius + 1;
  const float sc = level_scale(level0 + l);
  const float w = (float)wi, h = (float)hi;
  for (long long b = blockIdx.y; b < rows; b += gridDim.y) {
    const float cx = coords[2 * b], cy = coords[2 * b + 1];
    const float px = cx * sc, py = cy * sc;
    // the cell's place (d, e) in the window, as floats (no int cast of a
    // far-away or NaN origin)
    const float e = w - (floorf(px) - (float)radius), d = h - (floorf(py) - (float)radius);
    float v = 0.f;
    if (isnan(cx) || isnan(cy)) {
      v = cx + cy;
    } else if (d >= 0.f && d <= (float)k && e >= 0.f && e <= (float)k) {
      const int di0 = (int)d, ej0 = (int)e;
      const float* gw = grad_out + b * gstride + (long long)l * k * k;  // g[j * k + i]
#pragma unroll
      for (int di = 1; di >= 0; --di) {
        const int i = di0 - di;
        if (i < 0 || i >= k) continue;
        float a = 0.f;
#pragma unroll
        for (int dj = 1; dj >= 0; --dj) {
          const int j = ej0 - dj;
          if (j < 0 || j >= k) continue;
          a = a + gw[j * k + i] * tent((px + (float)(j - radius)) - w);
        }
        v = v + tent((py + (float)(i - radius)) - h) * a;
      }
    }
    C* dst = gl.map[l] + b * (long long)s * s + c;
    if constexpr (is_bf16<C>())
      *dst = __float2bfloat16_rn(v);
    else
      *dst = v;
  }
}

// p[i][j] of the pipeline's window patch: map cell (floor(py) - r + i,
// floor(px) - r + j), 0 outside the map
template <class C>
__device__ __forceinline__ float patch_at(const C* map, int s, float x0f, float y0f, int radius,
                                          int i, int j) {
  return cell_at(map, s, y0f - (float)radius + (float)i, x0f - (float)radius + (float)j);
}

template <class C>
__global__ void __launch_bounds__(GENERIC_COORD_ROWS * GROUP_LEVELS)
    generic_bwd_coords_kernel(const float* __restrict__ coords,
                              const float* __restrict__ grad_out, LevelsT<C> lv, int L,
                              int level0, int radius, long long rows, long long gstride,
                              float* __restrict__ grad_coords) {
  __shared__ float part[GROUP_LEVELS][GENERIC_COORD_ROWS][2];
  const int l = threadIdx.x / GENERIC_COORD_ROWS, row = threadIdx.x - l * GENERIC_COORD_ROWS;
  const long long b = (long long)blockIdx.x * GENERIC_COORD_ROWS + row;
  const int k = 2 * radius + 1;
  if (b < rows && l < L) {
    const float cx = coords[2 * b], cy = coords[2 * b + 1];
    const int s = lv.size[l];
    const C* map = lv.map[l] + b * (long long)s * s;
    const float* gw = grad_out + b * gstride + (long long)l * k * k;
    const float px = cx * level_scale(level0 + l), py = cy * level_scale(level0 + l);
    const float x0f = floorf(px), y0f = floorf(py);
    float lx = 0.f, ly = 0.f;
    for (int j = 0; j < k; ++j) {
      for (int i = 0; i < k; ++i) {
        const float x = px + (float)(j - radius), y = py + (float)(i - radius);
        const float xw = x0f + (float)(j - radius), yh = y0f + (float)(i - radius);
        const float wy0 = tent(y - yh), wy1 = tent(y - (yh + 1.f));
        const float wx0 = tent(x - xw), wx1 = tent(x - (xw + 1.f));
        float sx = 0.f, sy = 0.f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // t2[i, xw + e]
          const float t2 = wy0 * patch_at(map, s, x0f, y0f, radius, i, j + e) +
                           wy1 * patch_at(map, s, x0f, y0f, radius, i + 1, j + e);
          sx = sx + dtent(x - (xw + (float)e)) * t2;
        }
#pragma unroll
        for (int d = 0; d < 2; ++d) {  // t3[j, yh + d]
          const float t3 = wx0 * patch_at(map, s, x0f, y0f, radius, i + d, j) +
                           wx1 * patch_at(map, s, x0f, y0f, radius, i + d, j + 1);
          sy = sy + dtent(y - (yh + (float)d)) * t3;
        }
        const float gv = gw[j * k + i];
        lx = lx + gv * sx;
        ly = ly + gv * sy;
      }
    }
    part[l][row][0] = lx;
    part[l][row][1] = ly;
  }
  __syncthreads();
  if (l == 0 && b < rows) {
    const float cx = coords[2 * b], cy = coords[2 * b + 1];
    float gx = 0.f, gy = 0.f;
    if (level0 > 0) {
      gx = grad_coords[2 * b];
      gy = grad_coords[2 * b + 1];
    }
    for (int m = 0; m < L; ++m) {
      gx = gx + part[m][row][0] * level_scale(level0 + m);
      gy = gy + part[m][row][1] * level_scale(level0 + m);
    }
    if (isnan(cx) || isnan(cy)) gx = gy = cx + cy;  // NaN, as the tent form gives
    grad_coords[2 * b] = gx;
    grad_coords[2 * b + 1] = gy;
  }
}

template <class C>
int launch_bwd_generic(const float* coords, const float* grad_out, const LevelsT<C>& lv,
                       const GradLevelsT<C>& gl, int L, int level0, int radius, long long rows,
                       long long gstride, float* grad_coords, cudaStream_t stream) {
  int most = 0;
  for (int l = 0; l < L; ++l) most = lv.size[l] * lv.size[l] > most ? lv.size[l] * lv.size[l] : most;
  const dim3 grid((most + GENERIC_THREADS - 1) / GENERIC_THREADS,
                  (unsigned)(rows < GENERIC_ROW_BLOCKS ? rows : GENERIC_ROW_BLOCKS), L);
  generic_bwd_dense_kernel<C><<<grid, GENERIC_THREADS, 0, stream>>>(coords, grad_out, lv, gl,
                                                                   level0, radius, rows, gstride);
  int err = (int)cudaGetLastError();
  if (err != 0 || grad_coords == nullptr) return err;
  const long long blocks = (rows + GENERIC_COORD_ROWS - 1) / GENERIC_COORD_ROWS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  generic_bwd_coords_kernel<C><<<(unsigned)blocks, GENERIC_COORD_ROWS * GROUP_LEVELS, 0, stream>>>(
      coords, grad_out, lv, L, level0, radius, rows, gstride, grad_coords);
  return (int)cudaGetLastError();
}

// The shared memory of one pipeline launch of n levels, 0 past the
// templated radii
template <class C>
size_t bwd_smem(int radius, int n, bool want_coords) {
  return with_radius_value<BWD_MAX_RADIUS>(radius, [&](auto r) {
    return BwdWindow<decltype(r)::value, C>::smem(n, want_coords);
  });
}

// K1b at any level count and radius >= 0: one pipeline launch where the
// window fits one (plan_route), else the generic kernels once per group of
// GROUP_LEVELS levels, each group writing its levels' gradients and adding
// its part of the flow gradient; the first CUDA error, or
// cudaErrorInvalidValue for no rows, no levels or a negative radius.
template <class C>
int launch_bwd_lookup(const float* coords, const float* grad_out, const C* const* maps,
                      const int* sizes, C* const* grads, int num_levels, int radius,
                      long long rows, float* grad_coords, cudaStream_t stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const bool want = grad_coords != nullptr;
  int route = 0;
  int err = plan_route(num_levels, radius, BWD_MAX_RADIUS,
                       [&](int n) { return bwd_smem<C>(radius, n, want); }, &route);
  if (err != 0) return err;
  GradLevelsT<C> gl = {};
  if (route == ROUTE_WINDOW) {
    const LevelsT<C> lv = level_group(maps, sizes, 0, num_levels);
    for (int i = 0; i < num_levels; ++i) gl.map[i] = grads[i];
    return with_radius<BWD_MAX_RADIUS>(radius, [&](auto r) {
      constexpr int R = decltype(r)::value;
      return want ? launch_bwd<R, true>(coords, grad_out, lv, gl, num_levels, rows, grad_coords,
                                        stream)
                  : launch_bwd<R, false>(coords, grad_out, lv, gl, num_levels, rows, nullptr,
                                         stream);
    });
  }
  const long long kk = (2LL * radius + 1) * (2LL * radius + 1);
  for (int l0 = 0; l0 < num_levels && err == 0; l0 += GROUP_LEVELS) {
    const int n = num_levels - l0 < GROUP_LEVELS ? num_levels - l0 : GROUP_LEVELS;
    for (int i = 0; i < n; ++i) gl.map[i] = grads[l0 + i];
    err = launch_bwd_generic(coords, grad_out + l0 * kk, level_group(maps, sizes, l0, n), gl, n,
                             l0, radius, rows, num_levels * kk, grad_coords, stream);
  }
  return err;
}

// float maps and level gradients
extern "C" int corr_lookup_bwd_launch(const float* coords, const float* grad_out,
                                      const float* const* maps, const int* sizes,
                                      float* const* grads, int num_levels, int radius,
                                      long long rows, float* grad_coords, cudaStream_t stream) {
  return launch_bwd_lookup(coords, grad_out, maps, sizes, grads, num_levels, radius, rows,
                           grad_coords, stream);
}

// bfloat16 maps and level gradients (4-byte aligned); grad_out, coords and
// the flow gradient stay float
extern "C" int corr_lookup_bwd_bf16_launch(const float* coords, const float* grad_out,
                                           const __nv_bfloat16* const* maps, const int* sizes,
                                           __nv_bfloat16* const* grads, int num_levels,
                                           int radius, long long rows, float* grad_coords,
                                           cudaStream_t stream) {
  return launch_bwd_lookup(coords, grad_out, maps, sizes, grads, num_levels, radius, rows,
                           grad_coords, stream);
}

// What a launch at (num_levels, radius, want_coords) on float (bf16 = 0) or
// bfloat16 maps takes: the route (0 pipeline, 1 generic), the kernel
// launches a call makes (the generic route's flow-gradient kernel not
// counted), rows per group (the pipeline's; 1 for the generic kernels), the
// largest templated radius, threads per block and dynamic shared memory per
// block; the same error as the launch for what it refuses.
extern "C" int corr_lookup_bwd_layout(int num_levels, int radius, int want_coords, int bf16,
                                      int* route, int* launches, int* rows_per_group,
                                      int* max_radius, int* threads, long long* smem_bytes) {
  *max_radius = BWD_MAX_RADIUS;
  auto smem_of = [&](int n) {
    return bf16 ? bwd_smem<__nv_bfloat16>(radius, n, want_coords != 0)
                : bwd_smem<float>(radius, n, want_coords != 0);
  };
  const int err = plan_route(num_levels, radius, BWD_MAX_RADIUS, smem_of, route);
  if (err != 0) return err;
  if (*route == ROUTE_GENERIC) {
    *launches = (num_levels + GROUP_LEVELS - 1) / GROUP_LEVELS;
    *rows_per_group = 1;
    *threads = GENERIC_THREADS;
    *smem_bytes = 0;
    return 0;
  }
  *launches = 1;
  *threads = BWD_THREADS;
  *smem_bytes = (long long)smem_of(num_levels);
  return with_radius<BWD_MAX_RADIUS>(radius, [&](auto r) {
    *rows_per_group = BwdWindow<decltype(r)::value>::G;
    return 0;
  });
}
