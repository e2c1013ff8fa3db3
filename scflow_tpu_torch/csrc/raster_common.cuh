// Device code shared by the raster kernels K2 (rasterize_v3.cu), K3
// (rasterize_v4.cu), K4 (rasterize_packed.cu) and K5/K6 (rasterize_v12.cu):
// the pixel layout of a block, the face test of a staged piece of faces,
// and the 16 output maps of a thread's pixels from their winners' records.
// The counterpart of the JAX module's shared _eval_chunk_value_carry and
// _emit_maps (scflow_tpu/ops/pallas/rasterize.py:388-460).
//
// Keys: per pixel, the winner is the covering face with the least int32 key
//   (bits(max(z, 1e-6)) & ~id_mask) | sorted_id,
// so keys are unique and the order in which faces are visited, or whether
// a face that covers none of the pixels is visited at all, does not change
// the result.  Invalid or culled faces carry w0 == -1 and never cover; the
// kernels that AND the explicit valid row (K4, K5/K6) also skip a face
// whose row 10 is not > 0.5.
//
// Layout: a block of 256 threads covers an 8 x 128 piece of its tile; warp
// w its columns 16w..16w+15, all 8 rows; lane l row l/4 and the 4
// neighbouring columns 16w + 4(l%4) .. +3, so a thread stores 16 bytes per
// channel and a warp's pixels form one 8 x 16 rectangle.
//
// Face test, per staged piece: each lane first tests one face in 32 against
// its warp's pixel rectangle (rc_rect_keeps, conservative: it never drops a
// face that the per-pixel test lets cover one of the warp's pixels); the
// warp ballots the survivors and walks them, the same for every lane,
// through the per-pixel test.  The rectangle is the bounding box of the
// warp's pixels inside the tile (padding pixels are left out), so any tile
// shape works.  scflow_tpu_torch/ops/cuda/rasterize.py::rect_keeps is the
// plain mirror of the rejection, with the same formula and constants.
//
// Rounding: every a*b + c is written as __fmul_rn/__fadd_rn (and the
// rejection's doubles as separate operations) and the files build with
// -fmad=false, so nothing is contracted into an FMA, and keys and maps
// equal the plain PyTorch versions' (one rounding per operation) bit for
// bit.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>

#define RC_THREADS 256
#define RC_PPT 4                            // pixels per thread, neighbours in x
#define RC_BLOCK_H 8                        // a block covers 8 rows x 128 columns
#define RC_BLOCK_W 128
#define RC_WARP_W 16                        // a warp covers 8 rows x 16 columns
#define RC_PIECE 128                        // faces per chunk: fc is a multiple of it
#define RC_STAGE 512                        // faces the tile-generic kernels stage at once

static_assert(RC_BLOCK_H * RC_BLOCK_W == RC_THREADS * RC_PPT, "one pixel per thread slot");
static_assert(RC_BLOCK_W == (RC_THREADS / 32) * RC_WARP_W && RC_WARP_W == 4 * RC_PPT,
              "8 warps side by side, 4 lanes of 4 pixels per warp row");

// The rejection's constants (ops/cuda/rasterize.py: REJECT_REL, _ABS, _CAP).
// An affine w = a px + b py + c evaluated in float32 as the per-pixel test
// does is within 3 ulps (2^-22) of the exact value, relative to
// S = |a| |px| + |b| |py| + |c|, and w2 = 1 - w0 - w1 within 2^-21 of
// S0 + S1 + 1; the margin is 2^-18 of that, plus 2^-100 for underflow.  No
// face is rejected on a function whose S reaches 2^100, where float32
// products could overflow.
#define RC_REJECT_REL 0x1p-18
#define RC_REJECT_ABS 0x1p-100
#define RC_REJECT_CAP 0x1p100

__device__ __forceinline__ float rc_affine(float a, float b, float c, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

__device__ __forceinline__ float rc_blend3(float w0, float w1, float w2, float a0, float a1,
                                           float a2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(w0, a0), __fmul_rn(w1, a1)), __fmul_rn(w2, a2));
}

// One thread's pixels: row y, columns x .. x + RC_PPT - 1 (px[k] = x + k,
// py = y as floats); in[k] is false for a column or row past the tile's
// piece (nx columns, ny rows from the block's origin gx0, gy0).  Such a
// pixel is tested but never written.
struct RcPixels {
  int x, y;
  float px[RC_PPT], py;
  bool in[RC_PPT];
};

__device__ __forceinline__ RcPixels rc_block_pixels(int gx0, int gy0, int nx, int ny) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = lane >> 2, col = warp * RC_WARP_W + (lane & 3) * RC_PPT;
  RcPixels p;
  p.x = gx0 + col;
  p.y = gy0 + row;
  p.py = (float)p.y;
#pragma unroll
  for (int k = 0; k < RC_PPT; ++k) {
    p.px[k] = (float)(p.x + k);
    p.in[k] = row < ny && col + k < nx;
  }
  return p;
}

// The pixels of block blockIdx.x of tile `tile` (row-major over TX tiles
// across) of a crop tiled th x tw: the tile's ceil(th/8) x ceil(tw/128)
// pieces, row-major.
__device__ __forceinline__ RcPixels rc_tile_pixels(int tile, int TX, int th, int tw) {
  const int ty = tile / TX, tx = tile - ty * TX;
  const int bx_count = (tw + RC_BLOCK_W - 1) / RC_BLOCK_W;
  const int by = blockIdx.x / bx_count, bx = blockIdx.x - by * bx_count;
  return rc_block_pixels(tx * tw + bx * RC_BLOCK_W, ty * th + by * RC_BLOCK_H,
                         tw - bx * RC_BLOCK_W, th - by * RC_BLOCK_H);
}

// The bounding rectangle of the warp's pixels that lie inside the tile, as
// doubles, with the largest |x| and |y|; `any` is false (for the whole
// warp) where it has none.  Every lane of the warp must call it.
struct RcRect {
  double x0, x1, y0, y1, ax, ay;
  bool any;
};

__device__ __forceinline__ RcRect rc_warp_rect(const RcPixels& p) {
  int xmin = INT_MAX, xmax = INT_MIN;
#pragma unroll
  for (int k = 0; k < RC_PPT; ++k)
    if (p.in[k]) {
      xmin = min(xmin, p.x + k);
      xmax = max(xmax, p.x + k);
    }
  const bool mine = xmin <= xmax;
  const int ymin = __reduce_min_sync(0xffffffffu, mine ? p.y : INT_MAX);
  const int ymax = __reduce_max_sync(0xffffffffu, mine ? p.y : INT_MIN);
  xmin = __reduce_min_sync(0xffffffffu, xmin);
  xmax = __reduce_max_sync(0xffffffffu, xmax);
  RcRect r;
  r.any = xmin <= xmax;
  r.x0 = xmin;
  r.x1 = xmax;
  r.y0 = ymin;
  r.y1 = ymax;
  r.ax = fmax(fabs(r.x0), fabs(r.x1));
  r.ay = fmax(fabs(r.y0), fabs(r.y1));
  return r;
}

// The largest value over the rectangle of a px + b py + c: at the corner
// the coefficients' signs pick (a NaN coefficient gives NaN).
__device__ __forceinline__ double rc_rect_max(double a, double b, double c, const RcRect& r) {
  return a * (a > 0.0 ? r.x1 : r.x0) + b * (b > 0.0 ? r.y1 : r.y0) + c;
}

// False when the face (w0 = a0 px + b0 py + c0, w1 likewise) covers no
// pixel of the rectangle for certain: the largest value of w0, w1 or
// w2 = 1 - w0 - w1 over it is below minus its margin.  A NaN anywhere in a
// function keeps the face on that function; w0 == -1 (invalid or culled)
// is always rejected.
__device__ __forceinline__ bool rc_rect_keeps(float fa0, float fb0, float fc0, float fa1,
                                              float fb1, float fc1, const RcRect& r) {
  const double a0 = fa0, b0 = fb0, c0 = fc0, a1 = fa1, b1 = fb1, c1 = fc1;
  const double s0 = fabs(a0) * r.ax + fabs(b0) * r.ay + fabs(c0);
  const double s1 = fabs(a1) * r.ax + fabs(b1) * r.ay + fabs(c1);
  const double s2 = (s0 + s1) + 1.0;
  const double m0 = rc_rect_max(a0, b0, c0, r);
  const double m1 = rc_rect_max(a1, b1, c1, r);
  const double m2 = rc_rect_max(-(a0 + a1), -(b0 + b1), (1.0 - c0) - c1, r);
  const bool out0 = s0 < RC_REJECT_CAP && m0 < -(RC_REJECT_REL * s0 + RC_REJECT_ABS);
  const bool out1 = s1 < RC_REJECT_CAP && m1 < -(RC_REJECT_REL * s1 + RC_REJECT_ABS);
  const bool out2 = s2 < RC_REJECT_CAP && m2 < -(RC_REJECT_REL * s2 + RC_REJECT_ABS);
  return !(out0 || out1 || out2);
}

// The per-pixel test of staged face f against a thread's pixels, min-merged
// into best.  b*py is shared by the 4 pixels of a row: the same products,
// formed once.
template <int CAP>
__device__ __forceinline__ void rc_test_face(float (*coef)[CAP], int f, const RcPixels& p,
                                             int* best, int id_mask) {
  const int id = (int)coef[9][f];
  const float b0y = __fmul_rn(coef[1][f], p.py), b1y = __fmul_rn(coef[4][f], p.py),
              bzy = __fmul_rn(coef[7][f], p.py);
  const float a0 = coef[0][f], c0 = coef[2][f], a1 = coef[3][f], c1 = coef[5][f],
              az = coef[6][f], cz = coef[8][f];
#pragma unroll
  for (int k = 0; k < RC_PPT; ++k) {
    const float w0 = __fadd_rn(__fadd_rn(__fmul_rn(a0, p.px[k]), b0y), c0);
    const float w1 = __fadd_rn(__fadd_rn(__fmul_rn(a1, p.px[k]), b1y), c1);
    const float z = __fadd_rn(__fadd_rn(__fmul_rn(az, p.px[k]), bzy), cz);
    const float w2 = __fsub_rn(__fsub_rn(1.f, w0), w1);
    // min(min(w0, w1), w2) >= 0, false for NaN as in the reference
    const bool cover = (w0 >= 0.f) && (w1 >= 0.f) && (w2 >= 0.f);
    const float zc = isnan(z) ? z : fmaxf(z, 1e-6f);
    const int key = (__float_as_int(zc) & ~id_mask) | id;
    if (cover && key < best[k]) best[k] = key;
  }
}

// Stage rows 0..ROWS-1 of faces [f0, f0 + n) of one image's rows (row
// stride F; n a multiple of 32, at most CAP, f0 and F multiples of 4) in
// shared memory, 16 bytes per load where rn is 16-byte aligned, else 4,
// then min-merge the keys of the faces that survive each warp's rectangle
// into each thread's pixels.  ROWS == 10 reads the plane coefficients and
// the id; ROWS == 11 adds the valid row and skips invalid faces.  Returns
// the warp's surviving (face, warp) count, the same in every lane.  Every
// thread of the block must call it (it synchronises).
template <int ROWS, int CAP>
__device__ __forceinline__ unsigned rc_test_faces(float (*coef)[CAP],
                                                  const float* __restrict__ rn, int F, int f0,
                                                  int n, const RcRect& rect, const RcPixels& p,
                                                  int* best, int id_mask) {
  __syncthreads();  // the previous piece is no longer read
  if ((reinterpret_cast<size_t>(rn) & 15) == 0) {  // the same for every thread
    const int q = n >> 2;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      for (int i = threadIdx.x; i < q; i += RC_THREADS)
        reinterpret_cast<float4*>(coef[r])[i] =
            __ldg(reinterpret_cast<const float4*>(rn + (size_t)r * F + f0) + i);
  } else {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      for (int i = threadIdx.x; i < n; i += RC_THREADS)
        coef[r][i] = __ldg(rn + (size_t)r * F + f0 + i);
  }
  __syncthreads();
  unsigned kept = 0;
  if (!rect.any) return kept;  // the same for every lane of the warp
  const int lane = threadIdx.x & 31;
  for (int g = 0; g < n; g += 32) {
    const int f = g + lane;
    bool keep = true;
    if constexpr (ROWS > 10) keep = coef[10][f] > 0.5f;
    if (keep)
      keep = rc_rect_keeps(coef[0][f], coef[1][f], coef[2][f], coef[3][f], coef[4][f],
                           coef[5][f], rect);
    unsigned mask = __ballot_sync(0xffffffffu, keep);
    kept += __popc(mask);
    while (mask) {  // warp-uniform
      const int fi = g + __ffs(mask) - 1;
      mask &= mask - 1;
      rc_test_face<CAP>(coef, fi, p, best, id_mask);
    }
  }
  return kept;
}

// Store a thread's 4 values at o (pixel x of row y), 16 bytes at once where
// vec (rc_vec_ok) allows, else each pixel that is in alone.  Streaming stores: the maps are not read again
// by the kernel.
template <typename T, typename T4>
__device__ __forceinline__ void rc_store4(T* o, const T (&v)[RC_PPT], bool vec, const bool* in) {
  if (vec) {
    T4 w;
    w.x = v[0];
    w.y = v[1];
    w.z = v[2];
    w.w = v[3];
    __stcs(reinterpret_cast<T4*>(o), w);
  } else {
#pragma unroll
    for (int k = 0; k < RC_PPT; ++k)
      if (in[k]) o[k] = v[k];
  }
}

// Whether rc_store4 may store 16 bytes at o, o + plane, o + 2 plane, ...
// for these pixels: all 4 in, o 16-byte aligned, and the channel stride
// `plane` (in elements; 0 for one channel) a multiple of 4.
template <typename T>
__device__ __forceinline__ bool rc_vec_ok(const T* o, size_t plane, const RcPixels& p) {
  static_assert(sizeof(T) == 4, "4-byte elements");
  bool all = true;
#pragma unroll
  for (int k = 0; k < RC_PPT; ++k) all = all && p.in[k];
  return all && (reinterpret_cast<size_t>(o) & 15) == 0 && (plane & 3) == 0;
}

// Write the 16 maps (z*fg, fg, sorted id, normal (3), colour (3),
// barycentrics*fg (3), zeros) of a thread's pixels at o (channel 0 of
// pixel (x, y)), channel stride `plane`, from their least keys; vec as
// rc_vec_ok(o, plane, p) gives it.  Each
// winner's record is read from global memory, an exact copy, one row at a
// time as the channels need it; a background pixel keeps zeros, like the
// reference's zero-initialised carry.
__device__ __forceinline__ void rc_emit_maps(const float* __restrict__ rn, int F,
                                             const int* best, int id_mask, const RcPixels& p,
                                             float* o, size_t plane, bool vec) {
  bool fg[RC_PPT];
  int id[RC_PPT];
  float fgf[RC_PPT], w0[RC_PPT], w1[RC_PPT], w2[RC_PPT], v[RC_PPT];
#pragma unroll
  for (int k = 0; k < RC_PPT; ++k) {
    fg[k] = best[k] != INT_MAX;
    id[k] = best[k] & id_mask;
    fgf[k] = fg[k] ? 1.f : 0.f;
  }
  // a winner's row r, or 0 for a background pixel
  auto rec = [&](int r, int k) { return fg[k] ? __ldg(rn + (size_t)r * F + id[k]) : 0.f; };
#pragma unroll
  for (int k = 0; k < RC_PPT; ++k) {
    w0[k] = rc_affine(rec(0, k), rec(1, k), rec(2, k), p.px[k], p.py);
    w1[k] = rc_affine(rec(3, k), rec(4, k), rec(5, k), p.px[k], p.py);
    w2[k] = __fsub_rn(__fsub_rn(1.f, w0[k]), w1[k]);
    v[k] = __fmul_rn(rc_affine(rec(6, k), rec(7, k), rec(8, k), p.px[k], p.py), fgf[k]);
  }
  rc_store4<float, float4>(o, v, vec, p.in);
  rc_store4<float, float4>(o + plane, fgf, vec, p.in);
#pragma unroll
  for (int k = 0; k < RC_PPT; ++k) v[k] = rec(9, k);
  rc_store4<float, float4>(o + 2 * plane, v, vec, p.in);
#pragma unroll
  for (int ch = 0; ch < 6; ++ch) {  // normals (rows 11-19), then colours (20-28)
    const int r = ch < 3 ? 11 + ch : 17 + ch;
#pragma unroll
    for (int k = 0; k < RC_PPT; ++k)
      v[k] = rc_blend3(w0[k], w1[k], w2[k], rec(r, k), rec(r + 3, k), rec(r + 6, k));
    rc_store4<float, float4>(o + (3 + ch) * plane, v, vec, p.in);
  }
#pragma unroll
  for (int k = 0; k < RC_PPT; ++k) v[k] = __fmul_rn(w0[k], fgf[k]);
  rc_store4<float, float4>(o + 9 * plane, v, vec, p.in);
#pragma unroll
  for (int k = 0; k < RC_PPT; ++k) v[k] = __fmul_rn(w1[k], fgf[k]);
  rc_store4<float, float4>(o + 10 * plane, v, vec, p.in);
#pragma unroll
  for (int k = 0; k < RC_PPT; ++k) v[k] = __fmul_rn(w2[k], fgf[k]);
  rc_store4<float, float4>(o + 11 * plane, v, vec, p.in);
#pragma unroll
  for (int k = 0; k < RC_PPT; ++k) v[k] = 0.f;
#pragma unroll
  for (int ch = 12; ch < 16; ++ch) rc_store4<float, float4>(o + ch * plane, v, vec, p.in);
}

// Checks shared by the launch functions of the tile-generic kernels.
static inline bool rc_shape_ok(int N, int F, int H, int W, int th, int tw, int fc) {
  if (N <= 0 || N > 65535 || th <= 0 || tw <= 0 || fc <= 0 || F <= 0) return false;
  if (H % th != 0 || W % tw != 0 || fc % RC_PIECE != 0 || F % fc != 0) return false;
  const long long tiles = (long long)(H / th) * (W / tw);
  return tiles > 0 && tiles <= 65535 && (long long)th * tw <= INT_MAX / 2;
}

static inline dim3 rc_grid(int N, int H, int W, int th, int tw) {
  return dim3((unsigned)(((th + RC_BLOCK_H - 1) / RC_BLOCK_H) *
                         ((tw + RC_BLOCK_W - 1) / RC_BLOCK_W)),
              (unsigned)((H / th) * (W / tw)), (unsigned)N);
}
