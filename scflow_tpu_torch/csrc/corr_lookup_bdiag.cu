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
// cells of every level of its rows together ((k+1)^2 cells per row and
// level, zeros outside) and evaluates the two nonzero tent weights per axis
// on them, tent(y - h0) and tent(y - (h0 + 1)) with h0 = floor(py) - r + i.
// The other cells' weights are exactly 0 (the centre plus an integer offset
// rounds into [floor + offset, floor + offset + 1]), so the sums are the
// tent sums.  Held to the plain tent version at K1's atol 1e-4 (the plain
// version's matrix products may sum with FMAs; this file builds with
// -fmad=false).
//
// Bound on an H100 SXM (3.35 TB/s): memory, as K1 and K7 (about 37 us at
// the flagship shape).
//
// Design: the window pipeline of corr_common.cuh, as K7.  The first version
// (0.29 ms on an H100, 12% of the bound) was issue-bound on run-time index
// divisions in its three per-element loops and serialised each block's
// load, blend and store; the radius is now a template argument and the
// level count divides once per thread, cells arrive by cp.async while the
// previous group blends, and a group leaves by one bulk copy (times on an
// H100 in PERF.md).

// bfloat16 maps: corr_lookup_bdiag_bf16_launch runs the same pipeline on cells upcast
// exactly to fp32 (corr_common.cuh's 2-byte staging), as the TPU kernel
// reads its bf16 levels.

#include "corr_common.cuh"

#define MAX_RADIUS 12  // the pipeline instances this source builds: radius 0-12;
                       // a larger radius takes the generic kernel with these weights

__device__ __forceinline__ float tent(float u) { return fmaxf(0.f, 1.f - fabsf(u)); }

struct BdiagBlend {
  // the centre as it is: (px, py, floor(px), floor(py))
  __device__ __forceinline__ static float4 centre(float px, float py, float x0f, float y0f) {
    return make_float4(px, py, x0f, y0f);
  }
  // the two nonzero tent weights of window row i (off = i - r):
  // tent(y - h0), tent(y - (h0 + 1)) with y = py + off, h0 = floor(py) + off
  __device__ __forceinline__ static float2 yweights(float4 c, float off) {
    const float y = c.y + off, h0 = c.w + off;
    return make_float2(tent(y - h0), tent(y - (h0 + 1.f)));
  }
  // likewise for window column j; NaN where the centre is NaN, as the tent
  // form gives (fmaxf would turn a NaN weight into 0), so the output is NaN
  __device__ __forceinline__ static float2 xweights(float4 c, float off) {
    const float x = c.x + off, w0 = c.z + off;
    float2 w = make_float2(tent(x - w0), tent(x - (w0 + 1.f)));
    if (isnan(c.x) || isnan(c.y)) w.x = w.y = c.x + c.y;
    return w;
  }
};

// corr_lookup_bdiag_launch (float maps), corr_lookup_bdiag_bf16_launch (bfloat16 maps)
// and corr_lookup_bdiag_layout
WINDOW_ENTRY_POINTS(corr_lookup_bdiag_launch, corr_lookup_bdiag_bf16_launch,
                    corr_lookup_bdiag_layout, MAX_RADIUS, BdiagBlend)
