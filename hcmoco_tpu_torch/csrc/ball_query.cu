// Ball query with first-hit fill for Hopper (sm_90a): kernel K3.
//
// Replaces the Pallas TPU kernels hcmoco_tpu/ops/pallas/ball_query.py::
// _bq_kernel and the windowed pair _bqw_kernel + _bqw_viol_kernel (which
// return the same output; the window is a TPU speed device and is not
// ported).  For xyz (B, N, 3), centers (B, M, 3) f32 and r2 = radius^2:
//
//     hits of center m: the k in 0..N-1 with
//         ((cx - x_k)^2 + (cy - y_k)^2) + (cz - z_k)^2 < r2, in index order
//     idx[b, m, s] = the s-th hit for s < #hits (scan stops at S hits),
//                    the first hit for s >= #hits, 0 if there is no hit
//
// What bounds it: the scan.  A center stops after S hits, so the work is
// data-dependent: about (index of the S-th hit) distance tests of ~8
// flops each, plus 12 bytes read per tested point (from L2/L1: a sample's
// points are shared by all its centers); the output is 4*S bytes a center.
// At the path's radii the scan usually ends early; a center near the
// cloud's edge or in a sparse region scans all N.
//
// Design: one warp per center.  The warp tests 32 consecutive points at
// once; __ballot_sync gives the hit mask, __popc of the lower lanes each
// hit's rank, so the hits are written to their slots in index order with
// no serial loop, and the warp leaves the scan as soon as S hits are in.
// The slots after the last hit are filled with the first hit afterwards.
// The distance is written with __fsub_rn/__fmul_rn/__fadd_rn so nvcc
// cannot contract it into FMAs: d2 matches the plain PyTorch version bit
// for bit and a point on the sphere is in or out on both.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ centers, int* __restrict__ idx,
                  int B, int N, int M, int S, float r2) {
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * kWarpsPerBlock
                      + (threadIdx.x >> 5);
  if (c >= (long long)B * M) return;  // whole warp leaves together
  const int b = (int)(c / M);
  const float* p = xyz + (size_t)b * N * 3;
  const float cx = centers[3 * c + 0];
  const float cy = centers[3 * c + 1];
  const float cz = centers[3 * c + 2];
  int* out = idx + (size_t)c * S;
  const unsigned lower = (1u << lane) - 1u;

  int cnt = 0;
  int first = 0;
  for (int base = 0; base < N && cnt < S; base += 32) {
    const int k = base + lane;
    bool hit = false;
    if (k < N) {
      const float dx = __fsub_rn(cx, p[3 * k + 0]);
      const float dy = __fsub_rn(cy, p[3 * k + 1]);
      const float dz = __fsub_rn(cz, p[3 * k + 2]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      hit = d2 < r2;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (mask == 0u) continue;
    if (cnt == 0) first = base + __ffs(mask) - 1;
    const int rank = cnt + __popc(mask & lower);
    if (hit && rank < S) out[rank] = k;
    cnt += __popc(mask);
  }
  for (int s = (cnt < S ? cnt : S) + lane; s < S; s += 32) out[s] = first;
}

}  // namespace

extern "C" {

// xyz (B, N, 3), centers (B, M, 3) f32 contiguous -> idx (B, M, S) i32,
// on `stream`.  Returns cudaGetLastError() after the launch.
int hcmoco_ball_query(const void* xyz, const void* centers, void* idx, int B,
                      int N, int M, int S, float r2, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)B * M;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ball_query_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(centers),
      static_cast<int*>(idx), B, N, M, S, r2);
  return (int)cudaGetLastError();
}

}  // extern "C"
