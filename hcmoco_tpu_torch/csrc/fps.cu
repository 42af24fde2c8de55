// Furthest point sampling for Hopper (sm_90a): kernel K2.
//
// Replaces the Pallas TPU kernel hcmoco_tpu/ops/pallas/fps.py::_fps_kernel_m.
// For each sample b of xyz (B, N, 3) f32, idx (B, npoint) i32:
//
//     idx[0] = 0;  mind[k] = 1e10
//     round j = 1 .. npoint-1:
//         d[k]    = ((x_k - x_l)^2 + (y_k - y_l)^2) + (z_k - z_l)^2,  l = idx[j-1]
//         mind[k] = min(mind[k], d[k])
//         idx[j]  = argmax_k mind[k], the lowest k among equal maxima
//
// What bounds it: the rounds are sequential and each ends in a reduction
// over all N points, so one sample is one chain of npoint-1 block-wide
// argmaxes.  The bytes are tiny (xyz read once, idx written once) and the
// operations few (about 10 per point per round: 0.4 GFLOP at B=64,
// N=4096, npoint=1024); what the card cannot hide is the latency of the
// npoint-1 dependent reductions, and one SM's issue rate for the N
// distance updates of a round.
//
// Design, one block of T threads per sample:
//   * each thread keeps PPT consecutive points (k = tid*PPT + q) in
//     registers: x, y, z and the running min-distance; nothing of the
//     sample is in shared memory, so shared memory does not cap N;
//   * mind >= 0, so its float bits order as integers, and a lower lane (or
//     warp) owns only lower indices: a warp's argmax is __reduce_max_sync
//     of the bits and the lowest lane of __ballot_sync(bits == max), whose
//     own first maximum is the warp's.  Ties so go to the lowest index, as
//     the JAX and CUDA references take the first maximum;
//   * each warp's winning lane writes (bits, index, x, y, z) into a slot
//     array double-buffered by the round's parity, then ONE __syncthreads;
//     every warp then reduces all the slots itself (the same redux and
//     ballot over the warps' slots), so every thread has the
//     winner and its coordinates without a second barrier or a dependent
//     load.  Two buffers make one barrier enough: a warp that runs ahead
//     writes round j+1's buffer while others still read round j's, and it
//     cannot reach round j+2 before all of them pass round j+1's barrier;
//   * where N outgrows the registers (more than 16 points a thread at 512
//     threads: N > 8192) the same kernel streams the coordinates from
//     global memory each round and keeps mind in a global scratch (PPT ==
//     0).  Its thread takes every T-th point, so a warp's loads are
//     coalesced, and the argmax takes the lowest index among equal bits
//     with one more redux.  HRNetPN reaches it at SA1 (SA0 keeps every
//     point) with pn_num_points above 8192;
//   * the distance is written with __fsub_rn/__fmul_rn/__fadd_rn so nvcc
//     cannot contract it into FMAs: d then matches the plain PyTorch
//     version bit for bit and near-tie picks do not flip.
//
// T is the smallest power of two from 32 to 256 that is at least N (256
// beat 512 and 1024 at every call of the HRNetPN step), and 512 past 4096
// points, so that up to 8192 points stay in registers.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPPT = 16;          // points a thread in registers

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// One point's update: mind = min(mind, d), and (best, besti, b*) takes it
// if its bits are larger.  k rises with each call of a thread, so strict
// > keeps the thread's lowest index among equal maxima.  A padding point
// has mind = -1, whose bits are negative: it never wins.
__device__ __forceinline__ void update(float x, float y, float z, float& m,
                                       int k, float lx, float ly, float lz,
                                       int& best, int& besti, float& bx,
                                       float& by, float& bz) {
  m = fminf(m, sq_dist(x, y, z, lx, ly, lz));
  const int bits = __float_as_int(m);
  if (bits > best) {
    best = bits;
    besti = k;
    bx = x;
    by = y;
    bz = z;
  }
}

// The lane holding the largest bits and, among equal bits, the lowest
// index.  Where lower lanes own lower indices (Ordered) that is the
// lowest lane at the max; else one more redux takes the lowest index.
template <bool Ordered>
__device__ __forceinline__ int argmax_lane(int bits, int index) {
  const int top = __reduce_max_sync(kFull, bits);
  if constexpr (Ordered) return __ffs(__ballot_sync(kFull, bits == top)) - 1;
  const unsigned lo =
      __reduce_min_sync(kFull, bits == top ? (unsigned)index : UINT_MAX);
  return __ffs(__ballot_sync(kFull, bits == top && (unsigned)index == lo)) -
         1;
}

template <int T, int PPT>
__global__ void __launch_bounds__(T)
fps_kernel(const float* __restrict__ xyz, int* __restrict__ idx,
           float* __restrict__ scratch, int N, int npoint) {
  constexpr int W = T / 32;
  __shared__ int2 s_key[2][W];     // (bits, index) of each warp's winner
  __shared__ float4 s_xyz[2][W];   // and its coordinates

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* p = xyz + (size_t)b * N * 3;
  int* out = idx + (size_t)b * npoint;
  // the streaming variant's points are k = tid + i*T, so a warp's loads
  // are coalesced; lanes and warps then no longer own ordered indices
  float* smind = PPT == 0 ? scratch + (size_t)b * N : nullptr;

  float px[PPT > 0 ? PPT : 1], py[PPT > 0 ? PPT : 1], pz[PPT > 0 ? PPT : 1];
  float mind[PPT > 0 ? PPT : 1];
  if constexpr (PPT > 0) {
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int k = tid * PPT + q;
      const bool in = k < N;
      px[q] = in ? p[3 * k + 0] : 0.0f;
      py[q] = in ? p[3 * k + 1] : 0.0f;
      pz[q] = in ? p[3 * k + 2] : 0.0f;
      mind[q] = in ? 1e10f : -1.0f;
    }
  } else {
    for (int k = tid; k < N; k += T) smind[k] = 1e10f;
  }
  float lx = p[0], ly = p[1], lz = p[2];
  if (tid == 0) out[0] = 0;

  for (int j = 1; j < npoint; ++j) {
    int best = -1;
    int besti = INT_MAX;
    float bx = 0.0f, by = 0.0f, bz = 0.0f;
    if constexpr (PPT > 0) {
#pragma unroll
      for (int q = 0; q < PPT; ++q)
        update(px[q], py[q], pz[q], mind[q], tid * PPT + q, lx, ly, lz, best,
               besti, bx, by, bz);
    } else {
      // each thread reads and writes only its own smind entries
      for (int k = tid; k < N; k += T) {
        float m = smind[k];
        update(__ldg(p + 3 * k), __ldg(p + 3 * k + 1), __ldg(p + 3 * k + 2),
               m, k, lx, ly, lz, best, besti, bx, by, bz);
        smind[k] = m;
      }
    }
    const int par = j & 1;
    if (lane == argmax_lane<(PPT > 0)>(best, besti)) {
      s_key[par][warp] = make_int2(best, besti);
      s_xyz[par][warp] = make_float4(bx, by, bz, 0.0f);
    }
    __syncthreads();
    // every warp reduces the W slots itself; with PPT > 0 warp w owns
    // lower indices than warp w+1
    const int2 key = lane < W ? s_key[par][lane] : make_int2(-1, INT_MAX);
    const float4 c = lane < W ? s_xyz[par][lane] : make_float4(0, 0, 0, 0);
    const int src = argmax_lane<(PPT > 0)>(key.x, key.y);
    lx = __shfl_sync(kFull, c.x, src);
    ly = __shfl_sync(kFull, c.y, src);
    lz = __shfl_sync(kFull, c.z, src);
    if (warp == 0 && lane == src) out[j] = key.y;
  }
}

using Kernel = void (*)(const float*, int*, float*, int, int);

// The block size and points a thread for N points; ppt 0 for the
// streaming variant.
void plan(int N, int& t, int& ppt) {
  t = 32;
  while (t < 256 && t < N) t *= 2;
  if ((long long)N > (long long)t * kMaxPPT) t = 512;
  const int need = (int)(((long long)N + t - 1) / t);
  ppt = 1;
  while (ppt < need && ppt <= kMaxPPT) ppt *= 2;
  if (ppt > kMaxPPT) ppt = 0;
}

// Below 256 threads N <= T, so one point a thread; 512 threads hold 16
// points a thread or stream.
Kernel pick(int t, int ppt) {
  switch (t) {
    case 32: return fps_kernel<32, 1>;
    case 64: return fps_kernel<64, 1>;
    case 128: return fps_kernel<128, 1>;
    case 512: return ppt == 16 ? fps_kernel<512, 16> : fps_kernel<512, 0>;
    default: break;
  }
  switch (ppt) {
    case 1: return fps_kernel<256, 1>;
    case 2: return fps_kernel<256, 2>;
    case 4: return fps_kernel<256, 4>;
    case 8: return fps_kernel<256, 8>;
    default: return fps_kernel<256, 16>;
  }
}

}  // namespace

extern "C" {

// Floats of scratch a sample needs for N points: N where the kernel
// streams, else 0; -1 for N <= 0.
long long hcmoco_fps_scratch(int N) {
  if (N <= 0) return -1;
  int t, ppt;
  plan(N, t, ppt);
  return ppt == 0 ? (long long)N : 0;
}

// xyz (B, N, 3) f32 contiguous -> idx (B, npoint) i32, on `stream`.
// `scratch` holds B * hcmoco_fps_scratch(N) floats (may be null when that
// is 0).  Returns cudaGetLastError() after the launch (0 on success).
int hcmoco_fps(const void* xyz, void* idx, void* scratch, int B, int N,
               int npoint, void* stream) {
  if (B <= 0 || N <= 0 || npoint <= 0) return (int)cudaErrorInvalidValue;
  int t, ppt;
  plan(N, t, ppt);
  if (ppt == 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const Kernel k = pick(t, ppt);
  k<<<B, t, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<int*>(idx),
      static_cast<float*>(scratch), N, npoint);
  return (int)cudaGetLastError();
}

}  // extern "C"
