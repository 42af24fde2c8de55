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
// npoint-1 dependent reductions.
//
// Design:
//   * one block of 512 threads per sample; the sample's xyz sits in shared
//     memory (structure of arrays, 12 bytes a point: 48 KB at N=4096) so
//     the picked point's coordinates are one shared load away, and each
//     thread keeps the running min-distance of its PPT points (k = tid +
//     p*512) in registers;
//   * a round is a warp-shuffle argmax, one shared slot per warp, and a
//     final argmax by warp 0: two __syncthreads per round;
//   * ties go to the lower index at every level, as the JAX and CUDA
//     references take the first maximum;
//   * the distance is written with __fsub_rn/__fmul_rn/__fadd_rn so nvcc
//     cannot contract it into FMAs: d then matches the plain PyTorch
//     version bit for bit and near-tie picks do not flip.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (v, i) beats (w, j) if v > w, or v == w and i < j
__device__ __forceinline__ void argmax_combine(float& v, int& i, float w,
                                               int j) {
  if (w > v || (w == v && j < i)) {
    v = w;
    i = j;
  }
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int* __restrict__ idx, int N,
           int npoint) {
  extern __shared__ float smem[];  // x[N], y[N], z[N]
  float* sx = smem;
  float* sy = smem + N;
  float* sz = smem + 2 * N;
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_last;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* p = xyz + (size_t)b * N * 3;
  int* out = idx + (size_t)b * npoint;

  for (int k = tid; k < N; k += kThreads) {
    sx[k] = p[3 * k + 0];
    sy[k] = p[3 * k + 1];
    sz[k] = p[3 * k + 2];
  }
  float mind[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) mind[q] = 1e10f;
  if (tid == 0) out[0] = 0;
  __syncthreads();

  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    const float px = sx[last];
    const float py = sy[last];
    const float pz = sz[last];
    float best = -1.0f;
    int besti = N;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int k = tid + q * kThreads;
      if (k < N) {
        const float d = sq_dist(sx[k], sy[k], sz[k], px, py, pz);
        mind[q] = fminf(mind[q], d);
        // k rises with q: strict > keeps this thread's lowest index
        if (mind[q] > best) {
          best = mind[q];
          besti = k;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float w = __shfl_down_sync(0xffffffffu, best, off);
      const int wi = __shfl_down_sync(0xffffffffu, besti, off);
      argmax_combine(best, besti, w, wi);
    }
    if (lane == 0) {
      red_v[warp] = best;
      red_i[warp] = besti;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < kWarps ? red_v[lane] : -1.0f;
      besti = lane < kWarps ? red_i[lane] : N;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float w = __shfl_down_sync(0xffffffffu, best, off);
        const int wi = __shfl_down_sync(0xffffffffu, besti, off);
        argmax_combine(best, besti, w, wi);
      }
      if (lane == 0) {
        s_last = besti;
        out[j] = besti;
      }
    }
    __syncthreads();
    last = s_last;
  }
}

template <int PPT>
cudaError_t launch(const float* xyz, int* idx, int B, int N, int npoint,
                   cudaStream_t st) {
  const size_t smem = (size_t)3 * N * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fps_kernel<PPT><<<B, kThreads, smem, st>>>(xyz, idx, N, npoint);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xyz (B, N, 3) f32 contiguous -> idx (B, npoint) i32, on `stream`; N at
// most 32 points a thread (16384: 192 KB of shared memory).
// Returns cudaGetLastError() after the launch (0 on success).
int hcmoco_fps(const void* xyz, void* idx, int B, int N, int npoint,
               void* stream) {
  if (B <= 0 || N <= 0 || npoint <= 0 || N > 32 * kThreads)
    return (int)cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(xyz);
  int* o = static_cast<int*>(idx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ppt = (N + kThreads - 1) / kThreads;
  if (ppt <= 1) return (int)launch<1>(x, o, B, N, npoint, st);
  if (ppt <= 2) return (int)launch<2>(x, o, B, N, npoint, st);
  if (ppt <= 4) return (int)launch<4>(x, o, B, N, npoint, st);
  if (ppt <= 8) return (int)launch<8>(x, o, B, N, npoint, st);
  if (ppt <= 16) return (int)launch<16>(x, o, B, N, npoint, st);
  return (int)launch<32>(x, o, B, N, npoint, st);
}

}  // extern "C"
