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
// the plain PyTorch version rounds them, so the two agree bit for bit.  The
// two T values an output needs are recomputed in registers from the staged
// cells; the bits are those of a shared T.
//
// Bound on an H100 SXM (3.35 TB/s): memory, as K1.  At the flagship shape
// (65,536 rows, levels 32^2..4^2, r = 4) it writes 85 MB and reads at most
// (k+1)^2 cells per row and level: about 37 us (chip_smoke.py computes it).
//
// Design: the window pipeline of corr_common.cuh.  What limited the first
// version (0.25 ms on an H100, 15% of the bound) was issue slots, not
// bytes: the radius and level count were run-time values, so each staged
// cell, row blend and output paid several run-time integer divisions and
// modulos (a sequence of about 20 instructions each), and each block ran a
// serial load -> barrier -> blend -> barrier -> store chain.  Here the radius
// is a template argument (the launch switches over it) and the level count
// divides once per thread, so no per-element loop divides at run time;
// cells arrive by cp.async while the previous group blends, and a group
// leaves by one bulk copy (times on an H100 in PERF.md).

// bfloat16 maps: corr_lookup_shift_bf16_launch runs the same pipeline on cells upcast
// exactly to fp32 (corr_common.cuh's 2-byte staging), as the TPU kernel
// reads its bf16 levels.

#include "corr_common.cuh"

#define MAX_RADIUS 12  // the pipeline instances this source builds: radius 0-12;
                       // a larger radius takes the generic kernel with these weights

struct ShiftBlend {
  // one pair per axis for the whole window: (1 - fy, fy) and (1 - fx, fx),
  // computed once per row and level as the plain version broadcasts them
  __device__ __forceinline__ static float4 centre(float px, float py, float x0f, float y0f) {
    const float fx = px - x0f, fy = py - y0f;
    return make_float4(1.f - fy, fy, 1.f - fx, fx);
  }
  __device__ __forceinline__ static float2 yweights(float4 c, float) {
    return make_float2(c.x, c.y);
  }
  __device__ __forceinline__ static float2 xweights(float4 c, float) {
    return make_float2(c.z, c.w);
  }
};

// corr_lookup_shift_launch (float maps), corr_lookup_shift_bf16_launch (bfloat16 maps)
// and corr_lookup_shift_layout
WINDOW_ENTRY_POINTS(corr_lookup_shift_launch, corr_lookup_shift_bf16_launch,
                    corr_lookup_shift_layout, MAX_RADIUS, ShiftBlend)
