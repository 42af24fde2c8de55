// What the point-search kernels K3 (ball_query.cu) and K4 (three_nn.cu)
// share: the squared distance as the plain PyTorch versions round it, and
// the exact lower bound on it between two axis-aligned boxes, by which both
// skip 32-point tiles unseen.
//
// The bound.  For boxes [lo_a, hi_a] and [lo_b, hi_b] (a point is a box
// with lo = hi), per axis
//     g = max(lo_a - hi_b, lo_b - hi_a, 0)
// with the subtractions rounded to nearest (__fsub_rn), and
//     bound = ((g_x*g_x + g_y*g_y) + g_z*g_z)
// with __fmul_rn/__fadd_rn in d2's order.  For p in box a and q in box b,
// p - q >= lo_a - hi_b and q - p >= lo_b - hi_a; rounding to nearest is
// monotone and odd (fl(-v) = -fl(v)), so |fl(p - q)| = |fl(q - p)| >= g on
// every axis.  Products and sums of non-negative numbers rounded to nearest
// are monotone too, so bound <= the rounded d2 of every pair (p, q).  A gap
// that is NaN drops out of fmaxf and can only lower the bound, so the bound
// is never NaN.

#pragma once

#include <cuda_runtime.h>

namespace hcmoco {

constexpr unsigned kFullMask = 0xffffffffu;

// ((dx*dx + dy*dy) + dz*dz), each op rounded, never contracted into an FMA
__device__ __forceinline__ float sq3(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The gap between [lo, hi] and [blo, bhi] on one axis, rounded as the
// points' deltas
__device__ __forceinline__ float gap(float lo, float hi, float blo,
                                     float bhi) {
  return fmaxf(fmaxf(__fsub_rn(lo, bhi), __fsub_rn(blo, hi)), 0.0f);
}

// The box of one point a lane over the warp, in every lane:
// v = {min x, max x, min y, max y, min z, max z}
__device__ __forceinline__ void warp_box(float x, float y, float z,
                                         float v[6]) {
  v[0] = v[1] = x;
  v[2] = v[3] = y;
  v[4] = v[5] = z;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 6; a += 2) {
      v[a] = fminf(v[a], __shfl_xor_sync(kFullMask, v[a], off));
      v[a + 1] = fmaxf(v[a + 1], __shfl_xor_sync(kFullMask, v[a + 1], off));
    }
  }
}

}  // namespace hcmoco
