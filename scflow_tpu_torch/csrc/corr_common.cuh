// Shared pieces of the corr-lookup kernels: K1 (corr_lookup.cu), K7
// (corr_lookup_shift.cu), K8 (corr_lookup_bdiag.cu) and K1's backward
// (corr_lookup_bwd.cu).
//
// Contract of every lookup kernel: row b has a window centre (cx_b, cy_b)
// at level 0; level l is a flat S_l x S_l map per row; tap (j, i) of the
// k x k window (k = 2r + 1) samples level l at
//   x = cx_b / 2^l + (j - r),  y = cy_b / 2^l + (i - r),
// bilinearly with zeros outside, into column l*k*k + j*k + i.
//
// Any level count and any radius r >= 0 (the Pallas kernels take any).  A
// launch function takes the levels as host arrays of map pointers and sizes.
// Two routes: the window pipeline below, a templated instance per radius up
// to the source's MaxR, for a window whose levels (at most GROUP_LEVELS) fit
// one launch's two ring stages in a block's opt-in shared memory; and the
// generic kernel at the end of this file (a run-time radius, no staging) for
// every other window, launched once per group of GROUP_LEVELS levels, each
// writing its taps at its column offset of the output rows with its levels'
// scales 2^-(level0 + l).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define GROUP_LEVELS 4  // levels of one launch (the pipeline's limit)

// the maps of one launch, of one cell type: float or __nv_bfloat16
template <class T>
struct LevelsT {
  const T* map[GROUP_LEVELS];
  int size[GROUP_LEVELS];
};
using Levels = LevelsT<float>;

template <class T>
__host__ __device__ constexpr bool is_bf16() {
  return sizeof(T) == 2;
}

// a bfloat16 is the top half of a float: both halves of a 4-byte word of
// two cells, exactly (the low half is the cell at the lower address)
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// ---------------------------------------------------------------------------
// The window pipeline of K1, K7 and K8.
//
// The three kernels read, for each row and level, the (k+1) x (k+1) integer cells
// a window can touch,
//   P[e][d] = map[floor(py) - r + d][floor(px) - r + e],  0 outside,
// and blend output (j, i) from P[j..j+1][i..i+1] with two weights per axis:
//   t0 = wy0 P[j][i] + wy1 P[j][i+1],  t1 = the same on column j+1,
//   out = wx0 t0 + wx1 t1.
// The kernels differ only in the weights (the Blend class of each source:
// TentBlend, ShiftBlend, BdiagBlend).
// The radius is a template argument, so k, every loop bound and every
// offset inside the per-element loops are compile-time (a constant divisor
// compiles to a multiply and a shift).  The level count is a run-time
// argument: it divides only in each thread's (row, level, column) split,
// once, before the loops.
//
// A block is persistent: it walks groups of WINDOW_ROWS rows (blockIdx.x,
// + gridDim.x, ...) over a two-stage ring in shared memory.  While it blends
// group n from one stage, the cells of group n+1 arrive in the other with
// 4-byte cp.async (the src-size-0 form for a cell outside the map, which
// lands as 0, grid_sample's zeros padding, without a branch or a register
// round trip, and reads nothing); the window centres of group n+2 are
// already in registers.  TMA cannot stage the windows: a tensor map needs
// the level's row stride, S*4 bytes, to be a multiple of 16, which S = 2, 3,
// 5 or 10 are not.
//
// What the card rewards here is few shared-memory and L1 wavefronts, not
// few instructions.  So one thread per (row, level, window column e) stages
// the k+1 cells of that column, d = 0..k: a warp's cp.async then reads
// consecutive addresses of each window row.  (One thread per window row,
// looping over e, issued one line per lane, and ran slower.)  And one thread
// per (row, level, output column j) keeps the two window columns j and j+1 in
// registers and writes the k outputs (j, 0..k-1), so each staged cell is
// read from shared memory about twice, not four times.  The (row, level)
// centre or weights come from one float4 broadcast per thread.
//
// The blended group lands in shared memory and leaves as one contiguous
// range (rows b0 .. b0+3 of the output) by a Hopper bulk copy
// (cp.async.bulk.global.shared::cta); a short last group, or an output that
// is not 16-byte aligned, is stored by consecutive threads.
//
// Shared layout of one stage at L levels (win = row * L + level; the
// patch's column stride k+2 is odd, so consecutive columns fall in
// different banks):
//   cen[win] = Blend::centre(px, py, floor(px), floor(py))   G*L float4
//   patch[(win * (k+1) + e) * (k+2) + d]                     G*L*(k+1)*(k+2)
//   outbuf[row * L*k*k + column]                             G*L*k*k
//
// bfloat16 maps (the bf16 instances of K1, K7 and K8).  cp.async moves 4,
// 8 or 16 bytes, never 2, so a cell arrives as half of an aligned 4-byte
// word, beside its x-neighbour.  A window row of k+1 cells then starts on
// the word's low or high half: at the parity of its first cell's element
// index (b*S*S + y*S + x0 - r, with the level 4-byte aligned), which for an
// odd S changes from row to row.  So the row is staged as r+2 words, the
// k+3 cells from the even index at or before the first cell, one thread per
// (row, level, word column w) and one 4-byte cp.async per window row d;
// the stage holds, in place of the float patch,
//   org[win] = (x0 - r, y0 - r, parity of row 0, row exists)   G*L int4
//   raw[(win * (k+1) + d) * (r+2) + w]                       G*L*(k+1)*(r+2) words
// A word with a cell inside the map comes whole (its other half may lie in
// the next map row or the previous one: still inside the level), except
// that a word holding the level's last element at its low half, with the
// high half past the end, comes as 2 bytes (src-size 2, the rest
// zero-filled); a word with no cell inside the map is not read (src-size
// 0).  The blend reads its two window columns straight from the words: for
// row d, column j is half (j + parity_d) & 1 of word (j + parity_d) / 2, a
// bf16 is the top half of a float (exact, a shift), and a cell outside the
// map (the other half of a word read for its neighbour) is selected to 0;
// from there the blend is the float one, on exact fp32 cells.  (A first
// version upcast the words into a float patch in a pass of its own, one
// thread per word column, then blended from it: 0.078 ms of device time
// for K1 at 65,536 rows, against the float32 instance's 0.067; PERF.md.)

#include <type_traits>

#define WINDOW_ROWS 4  // rows per group

template <int R, class T = float>
struct Window {
  static constexpr int G = WINDOW_ROWS, K = 2 * R + 1, KP = K + 1, KS = K + 2;
  // staging slots per window: window columns (float) or 4-byte word columns
  static constexpr int NW = R + 2;
  static constexpr int SC = is_bf16<T>() ? NW : KP;
  // 4-byte units per window of the origins (bf16) and of the staged cells
  static constexpr int ORG = is_bf16<T>() ? 4 : 0;
  static constexpr int RAW = is_bf16<T>() ? KP * NW : KP * KS;
  // 4-byte units of one ring stage at L levels
  static constexpr int stage(int L) { return G * L * (4 + ORG + RAW + K * K); }
  static constexpr size_t smem(int L) { return 2 * sizeof(float) * stage(L); }
  // one thread per float staging slot (row, level, e), in whole warps: as
  // many as the blend's (row, level, j), and more than the bf16 slots
  static constexpr int threads(int L) { return (G * L * KP + 31) / 32 * 32; }
  static constexpr int MAX_THREADS = (G * GROUP_LEVELS * KP + 31) / 32 * 32;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

// 4 bytes to shared memory, of which the first `bytes` (0, 2 or 4) are read
// from src and the rest are zero; src 4-byte aligned
__device__ __forceinline__ void cp_async_word(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

// Stage the r+2 words of window column w for rows d = 0..k of one window
// (bf16 maps; see the layout note above), and with w = 0 its origin.
// b: the row (on: b < rows), s: the level's size.
template <int R>
__device__ __forceinline__ void stage_words(int4* org, uint32_t* raw, const __nv_bfloat16* map,
                                            long long b, bool on, long long rows, int s,
                                            float x0f, float y0f, int w) {
  constexpr int KP = 2 * R + 2, NW = R + 2;
  // tested as floats, so a NaN or far-away centre never reaches an int cast
  const int xs = (x0f >= -(float)(R + 2) && x0f <= (float)(s + R)) ? (int)x0f - R : -(4 * R + 8);
  const int yb = ((y0f >= -(float)(R + 1) && y0f <= (float)(s + R)) ? (int)y0f : -(2 * R + 4)) - R;
  const long long total = rows * (long long)s * s;  // elements of the level
  long long first = b * (long long)s * s + (long long)yb * s + xs;  // cell (yb + d, xs)
  if (w == 0) *org = make_int4(xs, yb, (int)(first & 1), on);
#pragma unroll
  for (int d = 0; d < KP; ++d) {
    const int par = (int)(first & 1);
    const long long lo = first - par + 2 * w;  // element index of the word's low half
    const int e = 2 * w - par;                  // its window column
    const bool row_in = on && (unsigned)(yb + d) < (unsigned)s;
    const bool any = row_in && ((unsigned)(xs + e) < (unsigned)s ||
                                (unsigned)(xs + e + 1) < (unsigned)s);
    const int bytes = any ? (lo + 2 <= total ? 4 : 2) : 0;
    cp_async_word(raw + d * NW + w, map + (any ? lo : 0), bytes);
    first += s;
  }
}

// Window columns j and j + 1 of one bf16 window, rows d = 0..k, as fp32
// cells (0 outside the map) into a[] and c[]: from the words staged by
// stage_words and the window's origin o.
template <int R>
__device__ __forceinline__ void columns_from_words(float* a, float* c, const uint32_t* raw,
                                                   int4 o, int s, int j) {
  constexpr int KP = 2 * R + 2, NW = R + 2;
  const bool ja = (unsigned)(o.x + j) < (unsigned)s, jc = (unsigned)(o.x + j + 1) < (unsigned)s;
#pragma unroll
  for (int d = 0; d < KP; ++d) {
    const int q = j + (o.z ^ (d * s & 1));  // j's place in the staged row
    const uint32_t w0 = raw[d * NW + (q >> 1)], w1 = raw[d * NW + (q >> 1) + 1];
    const bool row_in = o.w && (unsigned)(o.y + d) < (unsigned)s;
    const float va = (q & 1) ? bf16_hi(w0) : bf16_lo(w0);
    const float vc = (q & 1) ? bf16_lo(w1) : bf16_hi(w0);
    a[d] = row_in && ja ? va : 0.f;
    c[d] = row_in && jc ? vc : 0.f;
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_store(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(src);
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(s), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// at most N bulk stores still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <int R, class Blend, class T>
__global__ void __launch_bounds__(Window<R>::MAX_THREADS)
    windowed_lookup_kernel(const float* __restrict__ coords, LevelsT<T> lv, int L,
                           long long rows, long long groups, int bulk_ok,
                           float* __restrict__ out) {
  using W = Window<R, T>;
  constexpr int G = W::G, K = W::K, KP = W::KP, KS = W::KS, SC = W::SC;
  constexpr bool BF = is_bf16<T>();
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int cols = L * K * K;  // outputs of a row
  // offsets in a stage: centres, (bf16) origins, cells, outputs
  const int cen_f = G * L * 4, raw_f = cen_f + G * L * W::ORG;
  const int patch_f = raw_f + G * L * W::RAW, stage_f = patch_f + G * cols;

  // staging slot (row, level, window column e, or word column w for bf16
  // maps), the same in every group
  const int srow = tid / (L * SC);
  const int srem = tid - srow * (L * SC);
  const int slev = srem / SC;
  const int se = srem - slev * SC;
  const bool son = srow < G;
  const int swin = srow * L + slev;
  const int lc = son ? slev : 0;
  const int s = lv.size[lc];
  const T* const map = lv.map[lc];
  const float inv = ldexpf(1.f, -lc);  // exact power of two
  float2 cv;  // the centre of the next group to stage
  auto load_centre = [&](long long g) {
    const long long b = g * G + srow;
    const long long bc = b < rows ? b : rows - 1;
    cv = son ? make_float2(coords[2 * bc], coords[2 * bc + 1]) : make_float2(0.f, 0.f);
  };
  auto stage_group = [&](long long g, int buf) {
    if (!son) return;
    float* base = smem + buf * stage_f;
    const long long b = g * G + srow;
    const float px = cv.x * inv, py = cv.y * inv;
    const float x0f = floorf(px), y0f = floorf(py);
    if (se == 0) reinterpret_cast<float4*>(base)[swin] = Blend::centre(px, py, x0f, y0f);
    if constexpr (BF) {
      stage_words<R>(reinterpret_cast<int4*>(base + cen_f) + swin,
                     reinterpret_cast<uint32_t*>(base + raw_f) + swin * W::RAW, map, b, b < rows,
                     rows, s, x0f, y0f, se);
    } else {
      // tested as floats, so a NaN or far-away centre never reaches an int
      // cast: such a window gets an origin that leaves all its cells outside
      const float xx = x0f - (float)R + (float)se;
      const bool xin = b < rows && xx >= 0.f && xx <= (float)(s - 1);
      const int yb =
          ((y0f >= -(float)(R + 1) && y0f <= (float)(s + R)) ? (int)y0f : -(2 * R + 4)) - R;
      // cell d of this column: map[yb + d][xx]
      const float* cp = map + (xin ? b * (long long)s * s + (int)xx : 0LL) + (long long)yb * s;
      float* dst = base + raw_f + (swin * KP + se) * KS;
#pragma unroll
      for (int d = 0; d < KP; ++d)
        cp_async4(dst + d, cp + d * s, xin && (unsigned)(yb + d) < (unsigned)s);
    }
  };

  // blending item (row, level, output column j), the same in every row
  const int crow = tid / (L * K);
  const int crem = tid - crow * (L * K);
  const int clev = crem / K;
  const int cj = crem - clev * K;
  const bool con = crow < G;
  const int cwin = crow * L + clev;
  const float fj = (float)(cj - R);

  long long g = blockIdx.x;
  load_centre(g);
  stage_group(g, 0);
  cp_async_commit();
  long long gn = g + gridDim.x;
  if (gn < groups) load_centre(gn);
  for (int n = 0; g < groups; ++n, g = gn, gn += gridDim.x) {
    const int buf = n & 1;
    if (gn < groups) {
      stage_group(gn, buf ^ 1);
      if (gn + gridDim.x < groups) load_centre(gn + gridDim.x);
    }
    cp_async_commit();
    cp_async_wait<1>();                // this thread's cells of group g are in
    if (tid == 0) bulk_wait_read<1>();  // outbuf[buf] is no longer being read
    __syncthreads();

    float* base = smem + buf * stage_f;
    float* ob = base + patch_f;
    if (con) {
      const float4 ce = reinterpret_cast<const float4*>(base)[cwin];
      float a[KP], c[KP];  // window columns j and j + 1
      if constexpr (BF) {
        columns_from_words<R>(a, c, reinterpret_cast<const uint32_t*>(base + raw_f) + cwin * W::RAW,
                              reinterpret_cast<const int4*>(base + cen_f)[cwin],
                              lv.size[clev], cj);
      } else {
        const float* p = base + raw_f + (cwin * KP + cj) * KS;
#pragma unroll
        for (int d = 0; d < KP; ++d) {
          a[d] = p[d];
          c[d] = p[KS + d];
        }
      }
      const float2 wx = Blend::xweights(ce, fj);
      float* o = ob + crow * cols + (clev * K + cj) * K;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float2 wy = Blend::yweights(ce, (float)(i - R));
        const float t0 = wy.x * a[i] + wy.y * a[i + 1];
        const float t1 = wy.x * c[i] + wy.y * c[i + 1];
        o[i] = wx.x * t0 + wx.y * t1;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const long long b0 = g * G;
    const int nrows = rows - b0 < G ? (int)(rows - b0) : G;
    float* dst = out + b0 * cols;
    if (nrows == G && bulk_ok) {
      if (tid == 0) bulk_store(dst, ob, G * cols * (int)sizeof(float));
    } else {
      for (int q = tid; q < nrows * cols; q += blockDim.x) dst[q] = ob[q];
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// f(std::integral_constant<int, radius>()) for radius R..MaxR, the
// instances a source builds; cudaErrorInvalidValue for any other radius.
template <int MaxR, int R = 0, class F>
int with_radius(int radius, F&& f) {
  if (radius == R) return f(std::integral_constant<int, R>());
  if constexpr (R < MaxR)
    return with_radius<MaxR, R + 1>(radius, f);
  else
    return (int)cudaErrorInvalidValue;
}

// f(std::integral_constant<int, radius>()) for radius 0..MaxR (a size);
// 0 for any other radius
template <int MaxR, int R = 0, class F>
size_t with_radius_value(int radius, F&& f) {
  if (radius == R) return f(std::integral_constant<int, R>());
  if constexpr (R < MaxR)
    return with_radius_value<MaxR, R + 1>(radius, f);
  else
    return 0;
}

// The device's SM count and the shared memory a block may opt in to.
inline int device_limits(int* sms, int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// Resident blocks per SM of `kernel` at `threads` and `smem` bytes, the
// first time a level count asks (cached in per_sm[L]).  The kernel's
// dynamic shared memory limit is set once, to what the largest level count
// that fits the device asks (smem_of(L) grows with L), so that every level
// count that fits launches.
template <class Kernel, class SmemOf>
int resident_blocks(Kernel kernel, int* per_sm, int L, int threads, SmemOf smem_of, int optin) {
  if (per_sm[L] != 0) return 0;
  size_t most = 0;
  for (int l = 1; l <= GROUP_LEVELS; ++l)
    if (smem_of(l) <= (size_t)optin) most = smem_of(l);
  if (most > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[L], kernel, threads, smem_of(L));
  if (err != cudaSuccess) return (int)err;
  return per_sm[L] < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

template <int R, class Blend, class T>
int launch_window(const float* coords, const LevelsT<T>& lv, int L, long long rows, float* out,
                  cudaStream_t stream) {
  using W = Window<R, T>;
  auto kernel = windowed_lookup_kernel<R, Blend, T>;
  const size_t smem = W::smem(L);
  int sms = 0, optin = 0;
  int err = device_limits(&sms, &optin);
  if (err != 0) return err;
  // two ring stages at this level count must fit a block's shared memory
  if (smem > (size_t)optin) return (int)cudaErrorInvalidConfiguration;
  static int per_sm[GROUP_LEVELS + 1] = {};  // resident blocks per SM, by level count
  err = resident_blocks(kernel, per_sm, L, W::threads(L), [](int l) { return W::smem(l); },
                        optin);
  if (err != 0) return err;
  const long long groups = (rows + W::G - 1) / W::G;
  const long long resident = (long long)per_sm[L] * sms;
  const unsigned grid = (unsigned)(groups < resident ? groups : resident);
  const int bulk_ok = ((uintptr_t)out & 15) == 0;
  kernel<<<grid, W::threads(L), smem, stream>>>(coords, lv, L, rows, groups, bulk_ok, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The generic route: any radius and any level count, for the windows the
// pipeline does not take.  A thread per output column (level, tap j, tap i)
// of the group's rows, i fastest, so a warp stores consecutive addresses of
// a row; it splits its column once (the only divisions) and walks the rows
// blockIdx.y, + gridDim.y, ..., reading its four cells straight from the map
// through the read-only cache (no staging: the window's cells stay in L1)
// and blending them with the pipeline's arithmetic and the source's Blend,
// so both routes of a source compute the same function (K7's: bit for bit
// with its plain version, as its pipeline).

#define GENERIC_THREADS 256
#define GENERIC_ROW_BLOCKS 4096  // gridDim.y: each block walks rows / 4096 rows

// cell (y, x) of a level's row map as a float (a bfloat16 cell exactly), 0
// where (y, x) lies outside the map; tested as floats, so a NaN or far-away
// window never reaches an int cast
template <class T>
__device__ __forceinline__ float cell_at(const T* map, int s, float y, float x) {
  if (!(y >= 0.f && y <= (float)(s - 1) && x >= 0.f && x <= (float)(s - 1))) return 0.f;
  const T* p = map + (long long)(int)y * s + (int)x;
  if constexpr (is_bf16<T>())
    return __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  else
    return __ldg(p);
}

template <class Blend, class T>
__global__ void __launch_bounds__(GENERIC_THREADS)
    generic_lookup_kernel(const float* __restrict__ coords, LevelsT<T> lv, int L, int level0,
                          int radius, long long rows, long long ostride,
                          float* __restrict__ out) {
  const int k = 2 * radius + 1, kk = k * k;
  const int col = blockIdx.x * GENERIC_THREADS + threadIdx.x;
  if (col >= L * kk) return;
  const int lev = col / kk, t = col - lev * kk;
  const int j = t / k, i = t - j * k;
  const int s = lv.size[lev];
  const T* const map0 = lv.map[lev];
  const float inv = ldexpf(1.f, -(level0 + lev));
  const float oj = (float)(j - radius), oi = (float)(i - radius);
  for (long long b = blockIdx.y; b < rows; b += gridDim.y) {
    const float px = coords[2 * b] * inv, py = coords[2 * b + 1] * inv;
    const float x0f = floorf(px), y0f = floorf(py);
    const float4 ce = Blend::centre(px, py, x0f, y0f);
    const float2 wx = Blend::xweights(ce, oj), wy = Blend::yweights(ce, oi);
    const T* map = map0 + b * (long long)s * s;
    const float xa = x0f + oj, ya = y0f + oi;  // window cell (i, j)
    const float t0 = wy.x * cell_at(map, s, ya, xa) + wy.y * cell_at(map, s, ya + 1.f, xa);
    const float t1 =
        wy.x * cell_at(map, s, ya, xa + 1.f) + wy.y * cell_at(map, s, ya + 1.f, xa + 1.f);
    out[b * ostride + col] = wx.x * t0 + wx.y * t1;
  }
}

template <class Blend, class T>
int launch_generic(const float* coords, const LevelsT<T>& lv, int L, int level0, int radius,
                   long long rows, float* out, long long ostride, cudaStream_t stream) {
  const long long cols = (long long)L * (2 * radius + 1) * (2 * radius + 1);
  const long long blocks = (cols + GENERIC_THREADS - 1) / GENERIC_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)(rows < GENERIC_ROW_BLOCKS ? rows
                                                                         : GENERIC_ROW_BLOCKS));
  generic_lookup_kernel<Blend, T><<<grid, GENERIC_THREADS, 0, stream>>>(
      coords, lv, L, level0, radius, rows, ostride, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The route of a lookup at (num_levels, radius): the pipeline (ROUTE_WINDOW)
// where the radius has a templated instance (<= max_radius), the levels fit
// one launch (<= GROUP_LEVELS) and its two ring stages fit the device's
// opt-in shared memory (smem_of(num_levels)); else the generic kernel.
enum { ROUTE_WINDOW = 0, ROUTE_GENERIC = 1 };

template <class SmemOf>
int plan_route(int num_levels, int radius, int max_radius, SmemOf smem_of, int* route) {
  if (num_levels < 1 || radius < 0) return (int)cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  const int err = device_limits(&sms, &optin);
  if (err != 0) return err;
  *route = radius <= max_radius && num_levels <= GROUP_LEVELS &&
                   smem_of(num_levels) <= (size_t)optin
               ? ROUTE_WINDOW
               : ROUTE_GENERIC;
  return 0;
}

// The levels l0 .. l0+n-1 of host arrays as one launch's group.
template <class T>
LevelsT<T> level_group(const T* const* maps, const int* sizes, int l0, int n) {
  LevelsT<T> lv = {};
  for (int i = 0; i < n; ++i) {
    lv.map[i] = maps[l0 + i];
    lv.size[i] = sizes[l0 + i];
  }
  return lv;
}

// The launch of K1, K7 or K8 on maps of cell type T: any level count, any
// radius >= 0 (plan_route: one pipeline launch, or one generic launch per
// group of GROUP_LEVELS levels); returns the first CUDA error, or
// cudaErrorInvalidValue for no rows, no levels or a negative radius.  bf16
// maps must start on 4-byte boundaries (the wrapper checks it).
template <int MaxR, class Blend, class T>
int launch_lookup(const float* coords, const T* const* maps, const int* sizes, int num_levels,
                  int radius, long long rows, float* out, cudaStream_t stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  int route = 0;
  int err = plan_route(
      num_levels, radius, MaxR,
      [&](int n) {
        return with_radius_value<MaxR>(radius, [&](auto r) {
          return Window<decltype(r)::value, T>::smem(n);
        });
      },
      &route);
  if (err != 0) return err;
  if (route == ROUTE_WINDOW)
    return with_radius<MaxR>(radius, [&](auto r) {
      return launch_window<decltype(r)::value, Blend, T>(
          coords, level_group(maps, sizes, 0, num_levels), num_levels, rows, out, stream);
    });
  const long long kk = (2LL * radius + 1) * (2LL * radius + 1);
  for (int l0 = 0; l0 < num_levels && err == 0; l0 += GROUP_LEVELS) {
    const int n = num_levels - l0 < GROUP_LEVELS ? num_levels - l0 : GROUP_LEVELS;
    err = launch_generic<Blend, T>(coords, level_group(maps, sizes, l0, n), n, l0, radius, rows,
                                   out + l0 * kk, num_levels * kk, stream);
  }
  return err;
}

// What a launch at (num_levels, radius) on float (bf16 = 0) or bfloat16
// maps takes: the route (0 window pipeline, 1 generic), the kernel launches
// a call makes, rows per group (the pipeline's; 1 for the generic kernel),
// the largest templated radius, threads per block and dynamic shared memory
// per block; the same error as the launch for what it refuses.
template <int MaxR>
int window_layout(int num_levels, int radius, int bf16, int* route, int* launches,
                  int* rows_per_group, int* max_radius, int* threads, long long* smem_bytes) {
  *max_radius = MaxR;
  auto smem_of = [&](int n) {
    return with_radius_value<MaxR>(radius, [&](auto r) {
      constexpr int R = decltype(r)::value;
      return bf16 ? Window<R, __nv_bfloat16>::smem(n) : Window<R>::smem(n);
    });
  };
  const int err = plan_route(num_levels, radius, MaxR, smem_of, route);
  if (err != 0) return err;
  if (*route == ROUTE_GENERIC) {
    *launches = (num_levels + GROUP_LEVELS - 1) / GROUP_LEVELS;
    *rows_per_group = 1;
    *threads = GENERIC_THREADS;
    *smem_bytes = 0;
    return 0;
  }
  *launches = 1;
  *rows_per_group = WINDOW_ROWS;
  *smem_bytes = (long long)smem_of(num_levels);
  return with_radius<MaxR>(radius, [&](auto r) {
    *threads = Window<decltype(r)::value>::threads(num_levels);
    return 0;
  });
}

// The extern "C" launch and layout functions of one source: `name`_launch
// (float maps), `name`_bf16_launch (bfloat16 maps) and `name`_layout.
#define WINDOW_ENTRY_POINTS(launch, launch_bf16, layout, MaxR, Blend)                          \
  extern "C" int launch(const float* coords, const float* const* maps, const int* sizes,       \
                        int num_levels, int radius, long long rows, float* out,                \
                        cudaStream_t stream) {                                                  \
    return launch_lookup<MaxR, Blend>(coords, maps, sizes, num_levels, radius, rows, out,      \
                                      stream);                                                  \
  }                                                                                             \
  extern "C" int launch_bf16(const float* coords, const __nv_bfloat16* const* maps,            \
                             const int* sizes, int num_levels, int radius, long long rows,     \
                             float* out, cudaStream_t stream) {                                 \
    return launch_lookup<MaxR, Blend>(coords, maps, sizes, num_levels, radius, rows, out,      \
                                      stream);                                                  \
  }                                                                                             \
  extern "C" int layout(int num_levels, int radius, int bf16, int* route, int* launches,       \
                        int* rows_per_group, int* max_radius, int* threads,                    \
                        long long* smem_bytes) {                                                \
    return window_layout<MaxR>(num_levels, radius, bf16, route, launches, rows_per_group,      \
                               max_radius, threads, smem_bytes);                                \
  }
