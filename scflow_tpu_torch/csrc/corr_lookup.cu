// K1: windowed bilinear lookup in a multi-level correlation pyramid.
//
// Replaces: scflow_tpu/ops/pallas/corr_lookup.py::_kernel (`:230`, the TPU
// "tent" kernel).  That kernel builds each 9x9 window as two matmuls against
// 0/1 selection matrices, because a gather is slow on a TPU.  On Hopper a
// gather is cheap, so this kernel blends the four corners of every tap.
//
// Contract (same as the TPU kernel): for row b, level l and tap (j, i) of
// the k x k window (k = 2r + 1),
//   x = cx_b / 2^l + (j - r),  y = cy_b / 2^l + (i - r),
//   out[b, l*k*k + j*k + i] = bilinear(level_l[b], x, y), zeros outside.
// j offsets x: this tap order is what the motion encoder's weights expect.
// K1's arithmetic per tap: fx = x - floor(x) (likewise fy), rows first
//   r0 = (1 - fy) m[y0][x0] + fy m[y0+1][x0],  r1 the same on column x0+1,
// then out = (1 - fx) r0 + fx r1; NaN where the centre is NaN.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  At the flagship shape
// (B = 65,536 rows, levels 32^2/16^2/8^2/4^2, r = 4) one launch writes
// 85 MB and reads at most 10x10 cells per row and level: about 37 us
// (chip_smoke.py computes it from each run's coordinates); the arithmetic
// (3 lerps per tap) is far below the fp32 rate.
//
// Design: the window pipeline of corr_common.cuh, as K7 and K8, with K1's
// weights (TentBlend).  The first K1 (one thread per output column, 8 rows
// per block, 35% of the bound) divided by the run-time tap count and k in
// every thread, read each cell from L1 up to four times, and overlapped
// nothing beyond what occupancy gave.  Here the radius is a template
// argument (radius 0-15), each window's cells are staged once by cp.async
// while the previous group blends, each thread keeps two window columns in
// registers, and a group leaves by one bulk copy.  A window the pipeline
// does not take (more than four levels, a radius past 15, or two ring
// stages past a block's shared memory: radius 15 at four levels, about
// 258 KB) takes the generic kernel of corr_common.cuh with these weights.
//
// The pipeline's cells for tap j are columns x0 = floor(px) + (j - r) and
// x0 + 1.  x = px + (j - r) rounds into [x0, x0 + 1], so fx = x - x0 is K1's
// x - floor(x) except where x rounds up onto x0 + 1: there fx = 1 puts the
// whole weight on column x0 + 1, the cell K1's floor(x) picks with fx = 0,
// and the value is the same.  Built without -fmad=false, as the first K1:
// the plain version sums tent weights over whole rows, and the two are held
// within atol 1e-4.
//
// bfloat16 maps (the JAX package's dtype=bf16 pyramid): corr_lookup_bf16_launch
// runs the same pipeline on 2-byte cells, staged as aligned 4-byte words
// and upcast exactly to fp32 in shared memory (corr_common.cuh), so the
// blends and the fp32 output are the fp32 kernel's on the upcast cells, as
// the TPU kernel's `m_ref[...].astype(jnp.float32)`.

#include "corr_common.cuh"

#define MAX_RADIUS 15  // the pipeline instances this source builds: radius 0-15

struct TentBlend {
  // the centre as it is: (px, py, floor(px), floor(py))
  __device__ __forceinline__ static float4 centre(float px, float py, float x0f, float y0f) {
    return make_float4(px, py, x0f, y0f);
  }
  // K1's pair for window row i (off = i - r): y = py + off, fy = y - y0
  // with y0 = floor(py) + off, weights (1 - fy, fy) on rows y0 and y0 + 1
  __device__ __forceinline__ static float2 yweights(float4 c, float off) {
    const float fy = (c.y + off) - (c.w + off);
    return make_float2(1.f - fy, fy);
  }
  // likewise for window column j; NaN where the centre is NaN (K1's rule)
  __device__ __forceinline__ static float2 xweights(float4 c, float off) {
    const float fx = (c.x + off) - (c.z + off);
    float2 w = make_float2(1.f - fx, fx);
    if (isnan(c.x) || isnan(c.y)) w.x = w.y = c.x + c.y;
    return w;
  }
};

// corr_lookup_launch (float maps), corr_lookup_bf16_launch (bfloat16 maps)
// and corr_lookup_tent_layout
WINDOW_ENTRY_POINTS(corr_lookup_launch, corr_lookup_bf16_launch,
                    corr_lookup_tent_layout, MAX_RADIUS, TentBlend)
