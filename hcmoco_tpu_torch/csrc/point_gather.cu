// Point-feature row gathers and their scatter-add backwards for Hopper
// (sm_90a): kernels K5 (grouping) and K6 (three-point interpolation).
//
// K5 replaces the Pallas TPU kernels hcmoco_tpu/ops/pallas/window_group.py::
// _fwd_kernel and _bwd_kernel; for table (B, N, C), gidx (B, R) i32:
//
//     fwd   out[b, r, :]          = table[b, gidx[b, r], :]
//     bwd   grad[b, gidx[b,r], :] += gout[b, r, :]      (f32 sum, then cast)
//
// K6 replaces hcmoco_tpu/ops/pallas/window_interp.py::_fwd_kernel and
// _bwd_kernel; for feat (B, M, C), idx and w (B, N, 3):
//
//     fwd   out[b, n, :] = (w0*f[i0] + w1*f[i1]) + w2*f[i2]   in f32, with each
//                          w_k first rounded to the feature dtype
//     bwd   grad[b, i_k, :] += w_k * gout[b, n, :]          (f32 sum, then cast)
//
// On the TPU both were one-hot matmuls over a window of table rows, because
// Mosaic cannot gather rows; the window, its exactness fallback and the
// sample_ok exemption are TPU devices and are not ported.  Here the gather
// is a gather.
//
// What bounds them: bytes.  The forwards read each index once and write
// each output row once; the rows they read come mostly from L2, since
// neighbouring outputs share table rows (at the largest call, sa0 scale 1
// at B=64, the output is 512 MiB of bf16 from a 16 MiB table).  The
// backwards read gout once and add each element into a zeroed f32 buffer
// with atomics (the TPU kernels also sum in f32), then cast it to the table
// dtype.  Atomics add in a different order on every run, so the
// gradients agree with the plain version to f32 rounding, not bit for bit.
// A sample whose cloud is all zeros sends every row of its gradient to the
// first few table rows; that contention is left to the hardware.
//
// Design: one thread per (row, vector of V elements), V = 16 bytes of the
// dtype when C and the rows' alignment allow it (8 bf16 or 4 f32; 1 element
// otherwise), with a grid-stride loop.  K6's forward is written with
// __fmul_rn/__fadd_rn in a fixed order, so it matches the plain PyTorch
// version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// dst[0..V) += v, as 16-byte vector atomics (Hopper's float4 atomicAdd on
// global memory) when V allows: a warp's adds then cover whole sectors, as
// a scalar add per element of neighbouring threads would, in a quarter of
// the instructions.  dst is 16-byte aligned whenever V is a multiple of 4.
template <int V>
__device__ __forceinline__ void atomic_add_vec(float* dst, const float* v) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      atomicAdd(reinterpret_cast<float4*>(dst + i),
                make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) atomicAdd(dst + i, v[i]);
  }
}

inline unsigned grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

// ---- K5 --------------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
group_fwd_kernel(const Vec<T, V>* __restrict__ table,
                 const int* __restrict__ gidx, Vec<T, V>* __restrict__ out,
                 long long rows, int R, int N, int units) {
  const long long total = rows * units;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kThreads) {
    const long long r = e / units;
    const int u = (int)(e - r * units);
    const long long b = r / R;
    out[e] = table[(b * N + gidx[r]) * units + u];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
group_bwd_kernel(const Vec<T, V>* __restrict__ gout,
                 const int* __restrict__ gidx, float* __restrict__ acc,
                 long long rows, int R, int N, int units) {
  const long long total = rows * units;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kThreads) {
    const long long r = e / units;
    const int u = (int)(e - r * units);
    const long long b = r / R;
    const Vec<T, V> g = gout[e];
    float v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f<T>(g.v[i]);
    atomic_add_vec<V>(acc + ((b * N + gidx[r]) * units + u) * V, v);
  }
}

// ---- K6 --------------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
interp_fwd_kernel(const Vec<T, V>* __restrict__ feat,
                  const int* __restrict__ idx, const float* __restrict__ w,
                  Vec<T, V>* __restrict__ out, long long rows, int N, int M,
                  int units) {
  const long long total = rows * units;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kThreads) {
    const long long r = e / units;  // r = b * N + n
    const int u = (int)(e - r * units);
    const long long fb = (r / N) * M;
    float acc[V];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float wk = to_f<T>(from_f<T>(w[3 * r + k]));
      const Vec<T, V> f = feat[(fb + idx[3 * r + k]) * units + u];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float p = __fmul_rn(wk, to_f<T>(f.v[i]));
        acc[i] = k == 0 ? p : __fadd_rn(acc[i], p);
      }
    }
    Vec<T, V> o;
#pragma unroll
    for (int i = 0; i < V; ++i) o.v[i] = from_f<T>(acc[i]);
    out[e] = o;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
interp_bwd_kernel(const Vec<T, V>* __restrict__ gout,
                  const int* __restrict__ idx, const float* __restrict__ w,
                  float* __restrict__ acc, long long rows, int N, int M,
                  int units) {
  const long long total = rows * units;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kThreads) {
    const long long r = e / units;
    const int u = (int)(e - r * units);
    const long long fb = (r / N) * M;
    const Vec<T, V> g = gout[e];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float wk = to_f<T>(from_f<T>(w[3 * r + k]));
      float v[V];
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = __fmul_rn(wk, to_f<T>(g.v[i]));
      atomic_add_vec<V>(acc + ((fb + idx[3 * r + k]) * units + u) * V, v);
    }
  }
}

// ---- the f32 accumulator to the table dtype ---------------------------------

__global__ void __launch_bounds__(kThreads)
cast_bf16_kernel(const float* __restrict__ src,
                 __nv_bfloat16* __restrict__ dst, long long n) {
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads)
    dst[e] = __float2bfloat16_rn(src[e]);
}

// Zero acc, run `scatter` into it, and cast it into grad (bf16) or leave it
// as the result (f32: the wrapper passes grad == acc).
template <typename Scatter>
cudaError_t scatter_then_cast(float* acc, void* grad, long long n,
                              int is_bf16, cudaStream_t st,
                              Scatter scatter) {
  cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)n * sizeof(float), st);
  if (err != cudaSuccess) return err;
  scatter();
  err = cudaGetLastError();
  if (err != cudaSuccess || !is_bf16) return err;
  cast_bf16_kernel<<<grid_for(n), kThreads, 0, st>>>(
      acc, static_cast<__nv_bfloat16*>(grad), n);
  return cudaGetLastError();
}

template <typename T>
constexpr int vec_width() {
  return 16 / (int)sizeof(T);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// V = 16 bytes of T when C divides and the row tensors are 16-byte
// aligned, else 1 element.
template <typename T, template <typename, int> class Launch, typename... A>
cudaError_t dispatch_v(int C, bool aligned, A... args) {
  constexpr int V = vec_width<T>();
  if (aligned && C % V == 0) return Launch<T, V>::run(C / V, args...);
  return Launch<T, 1>::run(C, args...);
}

template <typename T, int V>
struct GroupFwd {
  static cudaError_t run(int units, const void* table, const int* gidx,
                         void* out, long long rows, int R, int N,
                         cudaStream_t st) {
    group_fwd_kernel<T, V><<<grid_for(rows * units), kThreads, 0, st>>>(
        static_cast<const Vec<T, V>*>(table), gidx,
        static_cast<Vec<T, V>*>(out), rows, R, N, units);
    return cudaGetLastError();
  }
};

template <typename T, int V>
struct GroupBwd {
  static cudaError_t run(int units, const void* gout, const int* gidx,
                         float* acc, void* grad, long long rows, int R, int N,
                         long long n_acc, int is_bf16, cudaStream_t st) {
    return scatter_then_cast(acc, grad, n_acc, is_bf16, st, [&] {
      group_bwd_kernel<T, V><<<grid_for(rows * units), kThreads, 0, st>>>(
          static_cast<const Vec<T, V>*>(gout), gidx, acc, rows, R, N, units);
    });
  }
};

template <typename T, int V>
struct InterpFwd {
  static cudaError_t run(int units, const void* feat, const int* idx,
                         const float* w, void* out, long long rows, int N,
                         int M, cudaStream_t st) {
    interp_fwd_kernel<T, V><<<grid_for(rows * units), kThreads, 0, st>>>(
        static_cast<const Vec<T, V>*>(feat), idx, w,
        static_cast<Vec<T, V>*>(out), rows, N, M, units);
    return cudaGetLastError();
  }
};

template <typename T, int V>
struct InterpBwd {
  static cudaError_t run(int units, const void* gout, const int* idx,
                         const float* w, float* acc, void* grad,
                         long long rows, int N, int M, long long n_acc,
                         int is_bf16, cudaStream_t st) {
    return scatter_then_cast(acc, grad, n_acc, is_bf16, st, [&] {
      interp_bwd_kernel<T, V><<<grid_for(rows * units), kThreads, 0, st>>>(
          static_cast<const Vec<T, V>*>(gout), idx, w, acc, rows, N, M,
          units);
    });
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  All tensors contiguous; indices i32
// and in range (the wrapper's callers produce them: ball query, three-NN).
// Each returns cudaGetLastError() after its launches (0 on success).

// table (B, N, C), gidx (B, R) -> out (B, R, C)
int hcmoco_group_fwd(const void* table, const void* gidx, void* out, int B,
                     int N, int R, int C, int dtype, void* stream) {
  if (B <= 0 || N <= 0 || R <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gi = static_cast<const int*>(gidx);
  const long long rows = (long long)B * R;
  const bool al = aligned16(table) && aligned16(out);
  if (dtype == 1)
    return (int)dispatch_v<__nv_bfloat16, GroupFwd>(C, al, table, gi, out,
                                                    rows, R, N, st);
  return (int)dispatch_v<float, GroupFwd>(C, al, table, gi, out, rows, R, N,
                                          st);
}

// gout (B, R, C), gidx (B, R) -> grad (B, N, C), through the f32 acc
// (B, N, C); for f32 pass grad == acc.
int hcmoco_group_bwd(const void* gout, const void* gidx, void* acc,
                     void* grad, int B, int N, int R, int C, int dtype,
                     void* stream) {
  if (B <= 0 || N <= 0 || R <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gi = static_cast<const int*>(gidx);
  float* a = static_cast<float*>(acc);
  const long long rows = (long long)B * R;
  const long long n_acc = (long long)B * N * C;
  const bool al = aligned16(gout) && aligned16(acc);
  if (dtype == 1)
    return (int)dispatch_v<__nv_bfloat16, GroupBwd>(C, al, gout, gi, a, grad,
                                                    rows, R, N, n_acc, 1, st);
  return (int)dispatch_v<float, GroupBwd>(C, al, gout, gi, a, grad, rows, R,
                                          N, n_acc, 0, st);
}

// feat (B, M, C), idx (B, N, 3) i32, w (B, N, 3) f32 -> out (B, N, C)
int hcmoco_interp_fwd(const void* feat, const void* idx, const void* w,
                      void* out, int B, int M, int N, int C, int dtype,
                      void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ii = static_cast<const int*>(idx);
  const float* ww = static_cast<const float*>(w);
  const long long rows = (long long)B * N;
  const bool al = aligned16(feat) && aligned16(out);
  if (dtype == 1)
    return (int)dispatch_v<__nv_bfloat16, InterpFwd>(C, al, feat, ii, ww, out,
                                                     rows, N, M, st);
  return (int)dispatch_v<float, InterpFwd>(C, al, feat, ii, ww, out, rows, N,
                                           M, st);
}

// gout (B, N, C), idx, w (B, N, 3) -> grad (B, M, C) through the f32 acc
// (B, M, C); for f32 pass grad == acc.
int hcmoco_interp_bwd(const void* gout, const void* idx, const void* w,
                      void* acc, void* grad, int B, int M, int N, int C,
                      int dtype, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ii = static_cast<const int*>(idx);
  const float* ww = static_cast<const float*>(w);
  float* a = static_cast<float*>(acc);
  const long long rows = (long long)B * N;
  const long long n_acc = (long long)B * M * C;
  const bool al = aligned16(gout) && aligned16(acc);
  if (dtype == 1)
    return (int)dispatch_v<__nv_bfloat16, InterpBwd>(
        C, al, gout, ii, ww, a, grad, rows, N, M, n_acc, 1, st);
  return (int)dispatch_v<float, InterpBwd>(C, al, gout, ii, ww, a, grad, rows,
                                           N, M, n_acc, 0, st);
}

}  // extern "C"
