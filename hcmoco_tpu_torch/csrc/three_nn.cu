// Three nearest neighbours for Hopper (sm_90a): kernel K4.
//
// Replaces the Pallas TPU kernel hcmoco_tpu/ops/pallas/three_nn.py::
// _three_nn_kernel.  For unknown (B, N, 3) and known (B, M, 3) f32:
//
//     d2(n, m) = ((ux - kx)^2 + (uy - ky)^2) + (uz - kz)^2
//     dist[b, n, :], idx[b, n, :] = the 3 smallest d2 over m, ascending,
//                                   the earlier m first among equal d2
//
// With M < 3 the missing neighbours keep dist = FLT_MAX and index 0, the
// values hcmoco_tpu.ops.point_ops.three_nn pads with.
//
// What bounds it: a blind scan tests all N*M pairs, 9 f32 ops each that
// may not be contracted into FMAs (the indices must be the plain
// version's), so it is bound by operations: at B = 64, N = M = 4096 that is
// 1.07e9 pairs, 0.289 ms at the card's 33.5e12 non-FMA f32 ops/s.  The
// bytes are few: 12 a point in, 24 an unknown point out.  So the design
// cuts the pairs.  The clouds arrive in raster order (depth2pts sorts its
// uniforms, each SA level sorts its FPS centers), so 32 consecutive points
// lie in a band of the image, and most known tiles are provably farther
// from a band of unknowns than the unknowns' third neighbours.
//
// Design:
//   * one block of 8 warps per (sample, chunk of 256 to 2048 unknowns).  The
//     block stages the sample's known points in shared memory as float4 (a
//     point is one 16-byte broadcast load; 64 KB at M = 4096) and one box
//     per 32-point tile.  Past 4096 points it streams them in chunks of
//     4096 and keeps each unknown's best three in dist/idx between chunks.
//     The ragged tile is padded with +inf points, whose d2 (inf or NaN)
//     never enters.
//   * A warp takes 32 consecutive unknowns, one a lane, from a shared
//     counter, and their box.  Lane t holds the bounds of tiles t, t + 32,
//     ... against that box (point_bounds.cuh: never above the rounded d2 of
//     any pair of the two boxes).
//   * The warp walks the tiles best first: it takes the unvisited tile of
//     least (bound, tile index), two __reduce_min_sync, and visits it
//     unless it provably holds no new neighbour of any lane.  With B3 the
//     lanes' largest third distance and I3 the largest third index among
//     the lanes at B3, a tile whose first index is f holds none when
//     bound > B3, or bound == B3 and f > I3: each of its points has
//     d2 >= bound and an index >= f, so it sorts after every lane's third
//     neighbour.  Tiles come in increasing (bound, f), so the first tile
//     skipped ends the walk.  A zero cloud (every d2 0) stops after tile 0:
//     B3 = 0 and I3 = 2 < 32.
//   * The walk visits exactly the tiles whose (bound, f) is at most the
//     final (B3, I3).  A tile holding a lane's final neighbour (d, k) has
//     (bound, f) <= (d, k) <= the final (B3, I3), so it comes before any
//     tile above the final (B3, I3); by then the lanes hold their answers
//     and (B3, I3) is final.
//   * Tiles come out of index order, so a lane inserts a point by (d2,
//     index) in lexicographic order: d < b3, or d == b3 and k < i3.  That
//     keeps the earliest index among equal distances, as the plain
//     version's first-minimum argmin does.  No tile is visited twice.
//   * The distance is written with __fsub_rn/__fmul_rn/__fadd_rn (sq3) so
//     nvcc cannot contract it into FMAs: the distances match the plain
//     PyTorch version bit for bit and so do the indices.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

#include "point_bounds.cuh"

namespace {

using hcmoco::gap;
using hcmoco::kFullMask;
using hcmoco::sq3;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 4096;              // known points staged at once
constexpr int kSlots = kChunk / 32 / 32;  // tile bounds a lane holds
constexpr int kMaxUnknowns = 2048;        // unknowns a block
constexpr int kTargetBlocks = 1056;       // 8 an SM on 132 SMs
constexpr unsigned kDone = 0xffffffffu;   // key of a visited or absent tile

// (d, k) sorts before (b, i): by distance, then by index
__device__ __forceinline__ bool before(float d, int k, float b, int i) {
  return d < b || (d == b && k < i);
}

__device__ __forceinline__ void insert(float d, int k, float& b1, int& i1,
                                       float& b2, int& i2, float& b3,
                                       int& i3) {
  if (!before(d, k, b3, i3)) return;
  if (before(d, k, b2, i2)) {
    b3 = b2;
    i3 = i2;
    if (before(d, k, b1, i1)) {
      b2 = b1;
      i2 = i1;
      b1 = d;
      i1 = k;
    } else {
      b2 = d;
      i2 = k;
    }
  } else {
    b3 = d;
    i3 = k;
  }
}

// 3 blocks an SM: 67 KB of shared memory each at M >= 4096
__global__ void __launch_bounds__(kThreads, 3)
three_nn_kernel(const float* __restrict__ unknown,
                const float* __restrict__ known, float* __restrict__ dist,
                int* __restrict__ idx, int N, int M, int cap, int per_block,
                int blocks_per_sample) {
  extern __shared__ float4 pts[];  // cap points, then the boxes
  float* box = reinterpret_cast<float*>(pts + cap);  // lox, hix, loy, hiy,
  const int tiles_cap = cap / 32;                    // loz, hiz: cap/32 each
  __shared__ int s_next;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / blocks_per_sample;
  const int n0 = (blockIdx.x % blocks_per_sample) * per_block;
  const int n_end = min(n0 + per_block, N);
  const int items = (n_end - n0 + 31) / 32;
  const float* kp = known + (size_t)b * M * 3;
  const float inf = __int_as_float(0x7f800000);

  for (int base = 0; base < M; base += cap) {
    const int m = min(cap, M - base);
    const int tiles = (m + 31) / 32;
    __syncthreads();  // the previous chunk's readers are done
    for (int k = tid; k < tiles * 32; k += kThreads) {
      const float* p = kp + (size_t)3 * (base + k);
      pts[k] = k < m ? make_float4(p[0], p[1], p[2], 0.0f)
                     : make_float4(inf, inf, inf, 0.0f);
    }
    if (tid == 0) s_next = 0;
    __syncthreads();
    for (int t = warp; t < tiles; t += kWarps) {
      // a lane past the ragged end takes the tile's first point
      const float4 p = pts[t * 32 + (t * 32 + lane < m ? lane : 0)];
      float v[6];
      hcmoco::warp_box(p.x, p.y, p.z, v);
      if (lane == 0) {
#pragma unroll
        for (int a = 0; a < 6; ++a) box[a * tiles_cap + t] = v[a];
      }
    }
    __syncthreads();

    for (;;) {
      int it = 0;
      if (lane == 0) it = atomicAdd(&s_next, 1);
      it = __shfl_sync(kFullMask, it, 0);
      if (it >= items) break;
      // a lane past the end repeats lane 0's unknown, so it leaves the
      // warp's box and third distances as they are, and writes nothing
      const int first = n0 + 32 * it;
      const bool live = first + lane < n_end;
      const size_t o = ((size_t)b * N + (live ? first + lane : first)) * 3;
      const float ux = unknown[o + 0];
      const float uy = unknown[o + 1];
      const float uz = unknown[o + 2];
      float b1 = FLT_MAX, b2 = FLT_MAX, b3 = FLT_MAX;
      int i1 = 0, i2 = 0, i3 = 0;
      if (base > 0) {  // the best three of the earlier chunks
        b1 = dist[o + 0];
        b2 = dist[o + 1];
        b3 = dist[o + 2];
        i1 = idx[o + 0];
        i2 = idx[o + 1];
        i3 = idx[o + 2];
      }
      float v[6];
      hcmoco::warp_box(ux, uy, uz, v);
      // bound bits, non-negative floats: their order is the floats'
      unsigned key[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int t = lane + 32 * j;
        key[j] = kDone;
        if (t < tiles)
          key[j] = __float_as_uint(sq3(
              gap(box[t], box[tiles_cap + t], v[0], v[1]),
              gap(box[2 * tiles_cap + t], box[3 * tiles_cap + t], v[2], v[3]),
              gap(box[4 * tiles_cap + t], box[5 * tiles_cap + t], v[4],
                  v[5])));
      }
      for (;;) {
        unsigned kmin = kDone, tmin = kDone;
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          if (key[j] < kmin) {
            kmin = key[j];
            tmin = lane + 32 * j;
          }
        }
        const unsigned bound = __reduce_min_sync(kFullMask, kmin);
        if (bound == kDone) break;  // every tile visited
        const unsigned t =
            __reduce_min_sync(kFullMask, kmin == bound ? tmin : kDone);
        const unsigned w3 = __reduce_max_sync(kFullMask, __float_as_uint(b3));
        const unsigned wi3 = __reduce_max_sync(
            kFullMask, __float_as_uint(b3) == w3 ? (unsigned)i3 : 0u);
        const unsigned f = (unsigned)base + 32u * t;
        if (bound > w3 || (bound == w3 && f > wi3)) break;
#pragma unroll
        for (int j = 0; j < kSlots; ++j)
          if (t == (unsigned)(lane + 32 * j)) key[j] = kDone;
        const float4* tp = pts + 32 * t;
#pragma unroll 8
        for (int e = 0; e < 32; ++e) {
          const float4 p = tp[e];
          const float d = sq3(__fsub_rn(ux, p.x), __fsub_rn(uy, p.y),
                              __fsub_rn(uz, p.z));
          if (d <= b3) insert(d, (int)f + e, b1, i1, b2, i2, b3, i3);
        }
      }
      if (live) {
        dist[o + 0] = b1;
        dist[o + 1] = b2;
        dist[o + 2] = b3;
        idx[o + 0] = i1;
        idx[o + 1] = i2;
        idx[o + 2] = i3;
      }
    }
  }
}

}  // namespace

extern "C" {

// unknown (B, N, 3), known (B, M, 3) f32 contiguous -> dist (B, N, 3) f32,
// idx (B, N, 3) i32, on `stream`.  Returns cudaGetLastError().
int hcmoco_three_nn(const void* unknown, const void* known, void* dist,
                    void* idx, int B, int N, int M, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long padded = ((long long)M + 31) / 32 * 32;
  const int cap = (int)(padded < kChunk ? padded : kChunk);
  const size_t smem = (size_t)cap * sizeof(float4)
                      + (size_t)(cap / 32) * 6 * sizeof(float);
  // fewer unknowns a block where the call has few, down to one warp's 32
  // for each warp: a block holds its slot until its slowest warp is done,
  // and where the card holds only a few warp items for each warp slot,
  // small blocks spread the uneven walks more evenly
  int per_block = kMaxUnknowns;
  while (per_block > kThreads
         && (long long)B * (((long long)N + per_block - 1) / per_block)
                < kTargetBlocks)
    per_block /= 2;
  const long long bps = ((long long)N + per_block - 1) / per_block;
  const long long blocks = (long long)B * bps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // once: room for the largest chunk, and as much of the SM's L1 as
  // shared memory, so that 3 blocks fit an SM
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        three_nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kChunk * (int)sizeof(float4) + kChunk / 32 * 6 * (int)sizeof(float));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(three_nn_kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return (int)attr;
  three_nn_kernel<<<(unsigned)blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(unknown), static_cast<const float*>(known),
      static_cast<float*>(dist), static_cast<int*>(idx), N, M, cap,
      per_block, (int)bps);
  return (int)cudaGetLastError();
}

}  // extern "C"
