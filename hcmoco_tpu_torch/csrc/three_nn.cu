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
// What bounds it: operations.  N*M distance tests of 8 flops and a few
// compares each (1.1e9 tests at B=64, N=M=4096: ~9 GFLOP of f32 off the
// tensor cores), against 24 bytes in and 24 bytes out per unknown point.
//
// Design: one thread per unknown point, its best three in registers,
// updated with strict < in index order (the CUDA reference's
// interpolate_gpu.cu three_nn, which keeps the earliest index on ties).
// A block of 256 unknown points of one sample walks the known set in tiles
// of 1024 points staged through shared memory (12 KB), so each known point
// is read from device memory once per block.  The distance is written with
// __fsub_rn/__fmul_rn/__fadd_rn so nvcc cannot contract it into FMAs: the
// distances match the plain PyTorch version bit for bit and so do the
// indices.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
three_nn_kernel(const float* __restrict__ unknown,
                const float* __restrict__ known, float* __restrict__ dist,
                int* __restrict__ idx, int N, int M) {
  __shared__ float kx[kTile];
  __shared__ float ky[kTile];
  __shared__ float kz[kTile];
  const int b = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool live = n < N;
  const float* u = unknown + ((size_t)b * N + (live ? n : 0)) * 3;
  const float ux = u[0];
  const float uy = u[1];
  const float uz = u[2];
  const float* kp = known + (size_t)b * M * 3;

  float b1 = FLT_MAX, b2 = FLT_MAX, b3 = FLT_MAX;
  int i1 = 0, i2 = 0, i3 = 0;
  for (int t0 = 0; t0 < M; t0 += kTile) {
    const int tn = min(kTile, M - t0);
    __syncthreads();
    for (int e = threadIdx.x; e < tn; e += kThreads) {
      kx[e] = kp[3 * (t0 + e) + 0];
      ky[e] = kp[3 * (t0 + e) + 1];
      kz[e] = kp[3 * (t0 + e) + 2];
    }
    __syncthreads();
    for (int e = 0; e < tn; ++e) {
      const float dx = __fsub_rn(ux, kx[e]);
      const float dy = __fsub_rn(uy, ky[e]);
      const float dz = __fsub_rn(uz, kz[e]);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                          __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d < b3) {
        const int k = t0 + e;
        if (d < b2) {
          b3 = b2;
          i3 = i2;
          if (d < b1) {
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
    }
  }
  if (live) {
    const size_t o = ((size_t)b * N + n) * 3;
    dist[o + 0] = b1;
    dist[o + 1] = b2;
    dist[o + 2] = b3;
    idx[o + 0] = i1;
    idx[o + 1] = i2;
    idx[o + 2] = i3;
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
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  three_nn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(unknown), static_cast<const float*>(known),
      static_cast<float*>(dist), static_cast<int*>(idx), N, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
