// Ball query with first-hit fill for Hopper (sm_90a): kernel K3.
//
// Replaces the Pallas TPU kernels hcmoco_tpu/ops/pallas/ball_query.py::
// _bq_kernel and the windowed pair _bqw_kernel + _bqw_viol_kernel (which
// return the same output).  For xyz (B, N, 3), centers (B, M, 3) f32 and
// r2 = radius^2:
//
//     hits of center m: the k in 0..N-1 with
//         ((cx - x_k)^2 + (cy - y_k)^2) + (cz - z_k)^2 < r2, in index order
//     idx[b, m, s] = the s-th hit for s < #hits (scan stops at S hits),
//                    the first hit for s >= #hits, 0 if there is no hit
//
// What bounds it: the scan.  A blind first-hit scan tests every point up
// to a center's S-th hit, and a center near the cloud's edge or in a
// sparse region tests all N: at the HRNetPN path's sa0 that is over half
// of all center-point pairs.  The bytes are small (points and centers read
// once, 4*S bytes written a center).  The clouds arrive in raster order
// (depth2pts samples pixels in order, each SA level sorts its centers), so
// 32 consecutive points lie in a narrow band of the image, and most of
// them are far from any one center.
//
// Design:
//   * one block of 8 warps per (sample, chunk of up to 256 centers).  The
//     block stages the sample's points into shared memory once, as
//     structure of arrays (12 bytes a point, 48 KB at N = 4096), and one
//     box per 32-point tile (min and max of x, y, z; 3 KB at N = 4096).
//     Where N exceeds 8192 points the block streams them through shared
//     memory in chunks of 8192, and keeps each center's hit count and
//     first hit in shared memory between chunks.  Warps take centers from
//     a shared counter, so a warp on a long scan does not hold up the
//     others.
//   * A warp skips whole tiles by an exact bound (point_bounds.cuh, with
//     the center as a box of one point): per axis g = max(lo - c, c - hi,
//     0), bound = ((g_x*g_x + g_y*g_y) + g_z*g_z), every op rounded in
//     d2's order, is never above the rounded d2 of a point in the tile's
//     box.  A tile with bound >= r2 therefore holds no hit and is skipped.
//     The tiles that remain are still visited in index order, so the hits,
//     their order and the first hit are those of the blind scan: the
//     output is bit-identical with no violation check or exact re-run,
//     which the TPU's index windows needed.
//   * Many boxes at once: lane t tests the box of tile g0 + t, so one
//     ballot covers 32 tiles (1024 points); the warp then walks the
//     candidate tiles of that mask in order, two tiles at a time, so that
//     both tiles' shared loads and tests are in flight together.
//   * A tile's test: each lane one point, __ballot_sync the hit mask,
//     __popc of the lower lanes each hit's rank, so hits land in their
//     slots in index order; the scan stops once S hits are in, and the
//     slots after the last hit are filled with the first hit.
//   * The distance is written with __fsub_rn/__fmul_rn/__fadd_rn so nvcc
//     cannot contract it into FMAs: d2 matches the plain PyTorch version
//     bit for bit and a point on the sphere is in or out on both.

#include <cuda_runtime.h>

#include <cstddef>

#include "point_bounds.cuh"

namespace {

using hcmoco::gap;
using hcmoco::sq3;
constexpr unsigned kFull = hcmoco::kFullMask;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 8192;       // points staged at once
constexpr int kMaxCenters = 256;   // centers a block
constexpr int kTargetBlocks = 528;  // 4 an SM on 132 SMs

// 4 blocks an SM: 52 KB of shared memory each at N = 4096
__global__ void __launch_bounds__(kThreads, 4)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ centers, int* __restrict__ idx,
                  int N, int M, int S, float r2, int cap, int per_block,
                  int blocks_per_sample) {
  extern __shared__ float smem[];
  float* sx = smem;              // cap points, structure of arrays
  float* sy = sx + cap;
  float* sz = sy + cap;
  float* box = sz + cap;         // lox, hix, loy, hiy, loz, hiz: cap/32 each
  const int tiles_cap = cap / 32;
  __shared__ int s_cnt[kMaxCenters];
  __shared__ int s_first[kMaxCenters];
  __shared__ int s_next;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / blocks_per_sample;
  const int c0 = (blockIdx.x % blocks_per_sample) * per_block;
  const int nc = min(per_block, M - c0);
  const float* p = xyz + (size_t)b * N * 3;
  const float* cen = centers + ((size_t)b * M + c0) * 3;
  int* out0 = idx + ((size_t)b * M + c0) * S;
  const unsigned lower = (1u << lane) - 1u;

  for (int i = tid; i < nc; i += kThreads) {
    s_cnt[i] = 0;
    s_first[i] = 0;
  }
  for (int base = 0; base < N; base += cap) {
    const int n = min(cap, N - base);
    const int tiles = (n + 31) / 32;
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < 3 * n; i += kThreads)
      smem[(i % 3) * cap + i / 3] = p[(size_t)3 * base + i];
    // the ragged tile's missing points at +inf: their d2 is inf or NaN,
    // never < r2, so the tests need no bounds check
    for (int k = n + tid; k < tiles * 32; k += kThreads)
      sx[k] = sy[k] = sz[k] = __int_as_float(0x7f800000);
    if (tid == 0) s_next = 0;
    __syncthreads();
    for (int t = warp; t < tiles; t += kWarps) {
      // a lane past the ragged end takes the tile's first point
      const int k = t * 32 + (t * 32 + lane < n ? lane : 0);
      float v[6];
      hcmoco::warp_box(sx[k], sy[k], sz[k], v);
      if (lane == 0) {
#pragma unroll
        for (int a = 0; a < 6; ++a) box[a * tiles_cap + t] = v[a];
      }
    }
    __syncthreads();

    // centers from a shared counter; the next one's coordinates are
    // loaded while this one is scanned
    int ci = 0;
    if (lane == 0) ci = atomicAdd(&s_next, 1);
    ci = __shfl_sync(kFull, ci, 0);
    float cx = 0.0f, cy = 0.0f, cz = 0.0f;
    if (ci < nc) {
      cx = cen[3 * ci + 0];
      cy = cen[3 * ci + 1];
      cz = cen[3 * ci + 2];
    }
    while (ci < nc) {
      int cn = 0;
      if (lane == 0) cn = atomicAdd(&s_next, 1);
      cn = __shfl_sync(kFull, cn, 0);
      float nx = 0.0f, ny = 0.0f, nz = 0.0f;
      if (cn < nc) {
        nx = cen[3 * cn + 0];
        ny = cen[3 * cn + 1];
        nz = cen[3 * cn + 2];
      }
      int cnt = s_cnt[ci];
      int first = s_first[ci];
      int* out = out0 + (size_t)ci * S;
      for (int g0 = 0; g0 < tiles && cnt < S; g0 += 32) {
        const int t = g0 + lane;
        bool reach = false;
        if (t < tiles) {
          const float gx = gap(box[t], box[tiles_cap + t], cx, cx);
          const float gy = gap(box[2 * tiles_cap + t], box[3 * tiles_cap + t],
                               cy, cy);
          const float gz = gap(box[4 * tiles_cap + t], box[5 * tiles_cap + t],
                               cz, cz);
          reach = sq3(gx, gy, gz) < r2;
        }
        // the candidate tiles of this group, two at a time
        for (unsigned cand = __ballot_sync(kFull, reach);
             cand != 0u && cnt < S;) {
          const int k0 = (g0 + __ffs(cand) - 1) * 32 + lane;
          cand &= cand - 1u;
          const bool two = cand != 0u;
          const int k1 = two ? (g0 + __ffs(cand) - 1) * 32 + lane : k0;
          if (two) cand &= cand - 1u;
          const bool h0 = sq3(__fsub_rn(cx, sx[k0]), __fsub_rn(cy, sy[k0]),
                              __fsub_rn(cz, sz[k0])) < r2;
          const bool h1 = two && sq3(__fsub_rn(cx, sx[k1]),
                                     __fsub_rn(cy, sy[k1]),
                                     __fsub_rn(cz, sz[k1])) < r2;
          const unsigned m0 = __ballot_sync(kFull, h0);
          const unsigned m1 = __ballot_sync(kFull, h1);
          if ((m0 | m1) == 0u) continue;
          if (cnt == 0)
            first = base + (m0 != 0u ? k0 - lane + __ffs(m0) - 1
                                     : k1 - lane + __ffs(m1) - 1);
          int rank = cnt + __popc(m0 & lower);
          if (h0 && rank < S) out[rank] = base + k0;
          cnt += __popc(m0);
          rank = cnt + __popc(m1 & lower);
          if (h1 && rank < S) out[rank] = base + k1;
          cnt += __popc(m1);
        }
      }
      if (lane == 0) {
        s_cnt[ci] = cnt;
        s_first[ci] = first;
      }
      ci = cn;
      cx = nx;
      cy = ny;
      cz = nz;
    }
  }
  __syncthreads();
  for (int ci = warp; ci < nc; ci += kWarps) {
    const int cnt = s_cnt[ci];
    const int first = s_first[ci];
    int* out = out0 + (size_t)ci * S;
    for (int s = (cnt < S ? cnt : S) + lane; s < S; s += 32) out[s] = first;
  }
}

}  // namespace

extern "C" {

// xyz (B, N, 3), centers (B, M, 3) f32 contiguous -> idx (B, M, S) i32,
// on `stream`.  Returns cudaGetLastError() after the launch.
int hcmoco_ball_query(const void* xyz, const void* centers, void* idx, int B,
                      int N, int M, int S, float r2, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const int cap = (int)(((long long)N + 31) / 32 * 32 < kChunk
                            ? ((long long)N + 31) / 32 * 32
                            : kChunk);
  const size_t smem = (size_t)cap * 3 * sizeof(float)
                      + (size_t)(cap / 32) * 6 * sizeof(float);
  // fewer centers a block where the call has few centers, down to one a
  // warp, so that the card has blocks to spread
  int per_block = kMaxCenters;
  while (per_block > kWarps
         && (long long)B * ((M + per_block - 1) / per_block) < kTargetBlocks)
    per_block /= 2;
  const int bps = (M + per_block - 1) / per_block;
  const long long blocks = (long long)B * bps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // once: room for the largest chunk, and as much of the SM's L1 as
  // shared memory, so that 4 blocks fit an SM
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        ball_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kChunk * 3 * (int)sizeof(float)
            + kChunk / 32 * 6 * (int)sizeof(float));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(ball_query_kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return (int)attr;
  ball_query_kernel<<<(unsigned)blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(centers),
      static_cast<int*>(idx), N, M, S, r2, cap, per_block, bps);
  return (int)cudaGetLastError();
}

}  // extern "C"
