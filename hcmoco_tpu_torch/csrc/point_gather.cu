// Point-feature row gathers and their backwards for Hopper (sm_90a):
// kernels K5 (grouping), K6 (three-point interpolation), and the two
// kernels both backwards share, K56a (destination index) and K56b
// (segmented row sum).
//
// K5 replaces the Pallas TPU kernels hcmoco_tpu/ops/pallas/window_group.py::
// _fwd_kernel and _bwd_kernel; for table (B, N, C), gidx (B, R) i32:
//
//     fwd   out[b, r, :]          = table[b, gidx[b, r], :]
//     bwd   grad[b, gidx[b,r], :] += gout[b, r, :]   (f32 sum, one rounding)
//
// K6 replaces hcmoco_tpu/ops/pallas/window_interp.py::_fwd_kernel and
// _bwd_kernel; for feat (B, M, C), idx and w (B, N, 3):
//
//     fwd   out[b, n, :] = (w0*f[i0] + w1*f[i1]) + w2*f[i2]  in f32, with each
//                          w_k first rounded to the feature dtype
//     bwd   grad[b, i_k, :] += w_k * gout[b, n, :]    (f32 sum, one rounding)
//
// On the TPU both were one-hot matmuls over a window of table rows, because
// Mosaic cannot gather rows; the window, its exactness fallback and the
// sample_ok exemption are TPU devices and are not ported.  Here the gather
// is a gather.
//
// Both backwards are one function: source position r sends one gout row,
// times a weight, to destination row idx[b, r] (K5: r = m*S + s, row r,
// weight 1; K6: r = 3n + k, row n, weight w[b, n, k]).  They run as two
// kernels, without atomics on floats:
//
//   K56a  dest_csr: a stable counting sort of idx (B, R) into start
//         (B, n_dest + 1) and src (B, R), each destination's source
//         positions in ascending order.  Per tile of 8192 sources, eight
//         warps rank their sources in order against 16-bit histograms in
//         shared memory (__match_any_sync ranks equal destinations within
//         32); prefixes over warps, tiles and destinations then place every
//         source at once.
//   K56b  segment_sum: each destination row's sources are added in src
//         order, in f32 with __fadd_rn (K6: __fmul_rn by the weight
//         first), and the row is written once in the table dtype.  Parallel
//         work comes from destinations x channels, never from splitting a
//         bucket, so the order of the adds is fixed.
//
// Each destination's sum is taken in ascending source order, as PyTorch's
// CPU scatter_add_ does, so the gradients equal the plain versions on the
// CPU bit for bit and do not change from run to run.
//
// What bounds them: bytes.  The forwards read each index once and write
// each output row once; the rows they read come mostly from L2, since
// neighbouring outputs share table rows (at the largest call, sa0 scale 1
// at B=64, the output is 512 MiB of bf16 from a 16 MiB table).  K56b reads
// every gout row once and writes the gradient once; K56a reads the index
// twice and writes src once.  What is hard is that one sum is a chain of
// dependent adds: a sample whose cloud is all zeros sends all its sources
// to its first few table rows (K5: 4096 sources to each of rows 0..S-1,
// against 32 on average), and 42% of the sources of the bs64 step sit in
// such buckets.  A thread that walks a bucket by itself waits on memory
// once for every few rows.  So K56b has two paths: buckets of up to 192
// sources go to a group of C/V threads a row, each adding V channels with
// 2 or 4 rows in flight; longer ones to one warp a 32-channel slice, a lane
// a channel, which streams the bucket's rows through a ring of shared
// memory with cp.async, 224 rows in flight, while it adds them in order.
// Both gather 64-byte rows at K5's widths, which DRAM serves at about half
// its peak rate.
//
// Design of the gathers: one thread per (row, vector of V elements), V = 16
// bytes of the dtype when C and the rows' alignment allow it (8 bf16 or 4
// f32; 1 element otherwise), with a grid-stride loop.  K6's forward is
// written with __fmul_rn/__fadd_rn in a fixed order, so it matches the
// plain PyTorch version bit for bit.

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

// ---- K56a: destination index ---------------------------------------------

constexpr int kTile = 8192;       // sources a count block ranks
constexpr int kCountWarps = 8;    // each ranks kTile / kCountWarps of them
constexpr int kSub = kTile / kCountWarps;
constexpr int kScanThreads = 1024;
constexpr int kMaxDest = 8192;    // the count block's 16-bit histograms

// Block (t, b) ranks the sources of tile t of sample b.  The tile's
// indices are copied to shared memory; warp w then walks its kSub sources
// 32 at a time, in order, and ranks equal destinations with
// __match_any_sync against its own 16-bit histogram; a prefix over the
// warps gives rel[r], the rank of source r among the tile's sources with the
// same destination, and tiles[b, t, d], the tile's count for d.
__global__ void __launch_bounds__(kCountWarps * 32)
csr_count_kernel(const int* __restrict__ idx, int* __restrict__ tiles,
                 unsigned short* __restrict__ rel, int R, int n_dest) {
  extern __shared__ unsigned short sm16[];
  unsigned short* hist = sm16;                            // [warps][n_dest]
  unsigned short* dst = hist + kCountWarps * n_dest;      // [kTile]
  unsigned short* rank = dst + kTile;                     // [kTile]
  const int t = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int n = min(kTile, R - t * kTile);
  const int* ib = idx + (long long)b * R + t * kTile;
  uint32_t* h32 = reinterpret_cast<uint32_t*>(hist);
  for (int i = threadIdx.x; i < (kCountWarps * n_dest + 1) / 2;
       i += blockDim.x)
    h32[i] = 0;  // one u16 past the histograms is dst[0], written below
  __syncthreads();
#pragma unroll 8
  for (int k = 0; k < kTile / (kCountWarps * 32); ++k) {
    const int i = k * kCountWarps * 32 + threadIdx.x;
    if (i < n) dst[i] = (unsigned short)ib[i];
  }
  __syncthreads();
  unsigned short* h = hist + w * n_dest;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll 4
  for (int i = w * kSub + lane; i < (w + 1) * kSub; i += 32) {
    const int d = i < n ? dst[i] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int r = __popc(peers & below);
    const int base = d >= 0 ? h[d] : 0;
    __syncwarp();
    if (d >= 0 && r == 0) h[d] = (unsigned short)(base + __popc(peers));
    __syncwarp();
    if (d >= 0) rank[i] = (unsigned short)(base + r);
  }
  __syncthreads();
  int* tb = tiles + ((long long)b * gridDim.x + t) * n_dest;
  for (int d = threadIdx.x; d < n_dest; d += blockDim.x) {
    int run = 0;
#pragma unroll
    for (int k = 0; k < kCountWarps; ++k) {
      const int c = hist[k * n_dest + d];
      hist[k * n_dest + d] = (unsigned short)run;
      run += c;
    }
    tb[d] = run;
  }
  __syncthreads();
  unsigned short* rb = rel + (long long)b * R + t * kTile;
#pragma unroll 4
  for (int k = 0; k < kTile / (kCountWarps * 32); ++k) {
    const int i = k * kCountWarps * 32 + threadIdx.x;
    if (i < n)
      rb[i] = (unsigned short)(hist[(i / kSub) * n_dest + dst[i]] + rank[i]);
  }
}

// Thread d of sample b: tiles[b, t, d] becomes the sources for d in tiles
// before t, and start[b, d] the total for d (scanned by csr_start_kernel).
__global__ void __launch_bounds__(256)
csr_tiles_kernel(int* __restrict__ tiles, int* __restrict__ start,
                 int n_dest, int n_tiles) {
  const int d = blockIdx.x * 256 + threadIdx.x, b = blockIdx.y;
  if (d >= n_dest) return;
  int* tb = tiles + (long long)b * n_tiles * n_dest + d;
  int run = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += 8) {  // 8 loads in flight
    int c[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      c[k] = t0 + k < n_tiles ? tb[(long long)(t0 + k) * n_dest] : 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (t0 + k < n_tiles) tb[(long long)(t0 + k) * n_dest] = run;
      run += c[k];
    }
  }
  start[(long long)b * (n_dest + 1) + d] = run;
}

// The exclusive prefix of a block's `n` values v (one a thread, blockDim
// kScanThreads), plus the running `carry`, which it advances by their sum.
__device__ __forceinline__ int block_exclusive(int v, int& carry,
                                               int* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sum[lane] = s;
  }
  __syncthreads();
  const int out = carry + (warp ? warp_sum[warp - 1] : 0) + x - v;
  carry += warp_sum[31];
  __syncthreads();  // warp_sum is rewritten by the next call
  return out;
}

// One block a sample: start[b, :n_dest] (the totals) becomes their
// exclusive prefix, and start[b, n_dest] their sum.
__global__ void __launch_bounds__(kScanThreads)
csr_start_kernel(int* __restrict__ start, int n_dest) {
  __shared__ int warp_sum[kScanThreads / 32];
  int* sb = start + (long long)blockIdx.x * (n_dest + 1);
  int carry = 0;
  for (int d0 = 0; d0 < n_dest; d0 += kScanThreads) {
    const int d = d0 + threadIdx.x;
    const int v = d < n_dest ? sb[d] : 0;
    const int first = block_exclusive(v, carry, warp_sum);
    if (d < n_dest) sb[d] = first;
  }
  if (threadIdx.x == 0) sb[n_dest] = carry;
}

// Source r goes to start[d] + (sources for d in earlier tiles) + rel[r];
// a thread places kFillPer consecutive sources, its loads all in flight.
constexpr int kFillPer = 4;

__global__ void __launch_bounds__(256)
csr_fill_kernel(const int* __restrict__ idx, const int* __restrict__ tiles,
                const unsigned short* __restrict__ rel,
                const int* __restrict__ start, int* __restrict__ src, int R,
                int n_dest, int n_tiles) {
  const int r0 = (blockIdx.x * 256 + threadIdx.x) * kFillPer;
  const int b = blockIdx.y;
  const long long at = (long long)b * R + r0;
  const int* sb = start + (long long)b * (n_dest + 1);
  const int* tb = tiles + (long long)b * n_tiles * n_dest;
  int d[kFillPer], pos[kFillPer];
#pragma unroll
  for (int k = 0; k < kFillPer; ++k) d[k] = r0 + k < R ? idx[at + k] : 0;
#pragma unroll
  for (int k = 0; k < kFillPer; ++k) {
    const long long t = (r0 + k) / kTile;
    pos[k] = r0 + k < R ? sb[d[k]] + tb[t * n_dest + d[k]] + rel[at + k] : 0;
  }
#pragma unroll
  for (int k = 0; k < kFillPer; ++k)
    if (r0 + k < R) src[(long long)b * R + pos[k]] = r0 + k;
}

// ---- K56b: segmented row sum -----------------------------------------------

// A bucket of more sources than kLongMin takes the long path, when the rows
// allow 16-byte copies; the others, the short path.
constexpr int kLongMin = 192;
constexpr int kShortThreads = 64;
constexpr int kChunk = 32;   // sources a stage of the long path
constexpr int kStages = 8;   // stages in flight

// Source r of sample b: row r (K5) or row r / 3 times T(w[b, r]) (K6).
template <bool kWeighted>
__device__ __forceinline__ long long source_row(int r) {
  return kWeighted ? r / 3 : r;
}

// Short path: a group of `units` threads a destination row, each adding its
// V channels over the bucket in src order, U rows in flight and the next
// indices loaded before the adds.  Skips buckets of more than long_min
// sources.
template <typename T, int V, int U, bool kWeighted>
__global__ void __launch_bounds__(kShortThreads)
segsum_short_kernel(const Vec<T, V>* __restrict__ rows,
                    const int* __restrict__ start,
                    const int* __restrict__ src,
                    const float* __restrict__ w, Vec<T, V>* __restrict__ out,
                    int B, int R, int n_dest, int units, int long_min) {
  const long long e = (long long)blockIdx.x * kShortThreads + threadIdx.x;
  if (e >= (long long)B * n_dest * units) return;
  const long long q = e / units;  // b * n_dest + d
  const int u = (int)(e - q * units);
  const int b = (int)(q / n_dest);
  const int d = (int)(q - (long long)b * n_dest);
  const int* st = start + (long long)b * (n_dest + 1);
  const int p0 = st[d], p1 = st[d + 1];
  if (p1 - p0 > long_min) return;
  const int* sb = src + (long long)b * R;
  const Vec<T, V>* rb =
      rows + (long long)b * (kWeighted ? R / 3 : R) * units + u;
  const float* wb = kWeighted ? w + (long long)b * R : nullptr;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
  int nxt[U];
#pragma unroll
  for (int j = 0; j < U; ++j) nxt[j] = p0 + j < p1 ? sb[p0 + j] : -1;
  for (int p = p0; p < p1; p += U) {
    int r[U];
    Vec<T, V> g[U];
    float wk[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      r[j] = nxt[j];
      if (r[j] >= 0) {
        g[j] = rb[source_row<kWeighted>(r[j]) * units];
        if constexpr (kWeighted) wk[j] = to_f<T>(from_f<T>(wb[r[j]]));
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int pn = p + U + j;
      nxt[j] = pn < p1 ? sb[pn] : -1;
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (r[j] < 0) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float c = to_f<T>(g[j].v[i]);
        if constexpr (kWeighted) c = __fmul_rn(c, wk[j]);
        acc[i] = __fadd_rn(acc[i], c);
      }
    }
  }
  Vec<T, V> o;
#pragma unroll
  for (int i = 0; i < V; ++i) o.v[i] = from_f<T>(acc[i]);
  out[q * units + u] = o;
}

// One block a sample: list[b, :n_long[b]] = the destinations whose bucket
// has more than long_min sources.
__global__ void __launch_bounds__(kScanThreads)
segsum_list_kernel(const int* __restrict__ start, int* __restrict__ list,
                   int* __restrict__ n_long, int n_dest, int long_min) {
  __shared__ int warp_sum[kScanThreads / 32];
  const int b = blockIdx.x;
  const int* st = start + (long long)b * (n_dest + 1);
  int* lb = list + (long long)b * n_dest;
  int carry = 0;
  for (int d0 = 0; d0 < n_dest; d0 += kScanThreads) {
    const int d = d0 + threadIdx.x;
    const int f = d < n_dest && st[d + 1] - st[d] > long_min;
    const int at = block_exclusive(f, carry, warp_sum);
    if (f) lb[at] = d;
  }
  if (threadIdx.x == 0) n_long[b] = carry;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Long path: one warp a task (b, d, slice of up to 32 channels), a lane a
// channel.  The warp streams the bucket's rows through a ring of kStages
// chunks in shared memory with cp.async (the chunk's source indices a
// further kStages chunks ahead, in their own ring), and adds each chunk's
// rows in src order.  Persistent: block i takes the tasks i, i + grid, ...
// of the list, sample after sample.
template <typename T, bool kWeighted>
__global__ void __launch_bounds__(32)
segsum_long_kernel(const T* __restrict__ rows, const int* __restrict__ start,
                   const int* __restrict__ src, const float* __restrict__ w,
                   const int* __restrict__ list,
                   const int* __restrict__ n_long, T* __restrict__ out,
                   int B, int R, int n_dest, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kSlice = 32 * (int)sizeof(T);  // bytes a source, at most
  constexpr int kPieces = kSlice / 16;         // 16-byte copies of a slice
  unsigned char* ring = smem;                  // [kStages][kChunk][slice]
  int* iring = reinterpret_cast<int*>(smem + kStages * kChunk * kSlice);
  float* wring = reinterpret_cast<float*>(iring + 2 * kStages * kChunk);
  int* counts = reinterpret_cast<int*>(wring + kStages * kChunk);  // [B]
  const int lane = threadIdx.x;
  for (int i = lane; i < B; i += 32) counts[i] = n_long[i];
  __syncwarp();
  const int n_sl = (C + 31) / 32;
  const int n_rows = kWeighted ? R / 3 : R;
  const long long G = gridDim.x;
  long long before = 0;  // tasks of earlier samples
  for (int b = 0; b < B; ++b) {
    const int tasks = counts[b] * n_sl;
    long long j = ((long long)blockIdx.x - before) % G;
    if (j < 0) j += G;
    before += tasks;
    for (; j < tasks; j += G) {
      const int d = list[(long long)b * n_dest + j / n_sl];
      const int ch0 = (int)(j % n_sl) * 32;
      const int nch = min(32, C - ch0);
      const int sbytes = nch * (int)sizeof(T);
      const int pieces = sbytes / 16;
      const int* st = start + (long long)b * (n_dest + 1);
      const int p0 = st[d], n = st[d + 1] - p0;
      const int chunks = (n + kChunk - 1) / kChunk;
      const int* sb = src + (long long)b * R + p0;
      const unsigned char* rb = reinterpret_cast<const unsigned char*>(
          rows + (long long)b * n_rows * C + ch0);
      const float* wb = kWeighted ? w + (long long)b * R : nullptr;
      auto issue_idx = [&](int c) {
        if (c >= chunks) return;
        int* dst = iring + (c % (2 * kStages)) * kChunk;
        for (int i = lane; i < kChunk && c * kChunk + i < n; i += 32)
          cp_async4(smem_u32(dst + i), sb + c * kChunk + i);
      };
      auto issue_rows = [&](int c) {
        if (c >= chunks) return;
        const int* ix = iring + (c % (2 * kStages)) * kChunk;
        unsigned char* dst = ring + (c % kStages) * kChunk * kSlice;
        const int cnt = min(kChunk, n - c * kChunk);
#pragma unroll
        for (int it = 0; it < kChunk * kPieces / 32; ++it) {
          const int q = it * 32 + lane;
          const int jj = q / kPieces, u = q % kPieces;
          if (jj < cnt && u < pieces)
            cp_async16(smem_u32(dst + jj * sbytes + u * 16),
                       rb + source_row<kWeighted>(ix[jj]) * C * sizeof(T) +
                           u * 16);
        }
        if constexpr (kWeighted) {
          float* wd = wring + (c % kStages) * kChunk;
#pragma unroll
          for (int i = lane; i < kChunk; i += 32)
            if (i < cnt) cp_async4(smem_u32(wd + i), wb + ix[i]);
        }
      };
      for (int c = 0; c < kStages; ++c) issue_idx(c);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      for (int c = 0; c < kStages - 1; ++c) {
        issue_rows(c);
        issue_idx(c + kStages);
        cp_async_commit();
      }
      float acc = 0.0f;
      for (int k = 0; k < chunks; ++k) {
        issue_rows(k + kStages - 1);
        issue_idx(k + 2 * kStages - 1);
        cp_async_commit();
        cp_async_wait<kStages - 1>();
        __syncwarp();
        const unsigned char* rs = ring + (k % kStages) * kChunk * kSlice;
        const float* ws = wring + (k % kStages) * kChunk;
        const int cnt = min(kChunk, n - k * kChunk);
        if (lane < nch) {
          // in groups of 16: the loads first, then the adds in order
          for (int j0 = 0; j0 < cnt; j0 += 16) {
            float x[16];
#pragma unroll
            for (int jj = 0; jj < 16; ++jj) {
              x[jj] = 0.0f;
              if (j0 + jj < cnt) {
                const T* row =
                    reinterpret_cast<const T*>(rs + (j0 + jj) * sbytes);
                x[jj] = to_f<T>(row[lane]);
                if constexpr (kWeighted)
                  x[jj] = __fmul_rn(x[jj], to_f<T>(from_f<T>(ws[j0 + jj])));
              }
            }
#pragma unroll
            for (int jj = 0; jj < 16; ++jj)
              if (j0 + jj < cnt) acc = __fadd_rn(acc, x[jj]);
          }
        }
        __syncwarp();
      }
      cp_async_wait<0>();
      __syncwarp();
      if (lane < nch)
        out[((long long)b * n_dest + d) * C + ch0 + lane] = from_f<T>(acc);
    }
  }
}

template <typename T>
size_t long_smem(int B) {
  return (size_t)kStages * kChunk * 32 * sizeof(T) +
         (size_t)2 * kStages * kChunk * sizeof(int) +
         (size_t)kStages * kChunk * sizeof(float) + (size_t)B * sizeof(int);
}

// The long path's persistent grid: as many one-warp blocks as fit at once.
template <typename T, bool kWeighted>
cudaError_t long_grid(size_t smem, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(segsum_long_kernel<T, kWeighted>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segsum_long_kernel<T, kWeighted>, 32, smem);
  *grid = sms * (per_sm < 1 ? 1 : per_sm);
  return err;
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

// K56b on one stream: with V > 1 (16-byte rows) the short path takes the
// buckets of up to kLongMin sources and the long path the rest; with V = 1,
// the short path takes all.
template <typename T, int V>
struct SegmentSum {
  template <bool kWeighted>
  static cudaError_t launch(int units, const void* rows, const int* start,
                            const int* src, const float* w, void* out,
                            int* work, int B, int R, int n_dest,
                            cudaStream_t st) {
    const int long_min = V > 1 ? kLongMin : R;
    const auto* in = static_cast<const Vec<T, V>*>(rows);
    auto* o = static_cast<Vec<T, V>*>(out);
    const long long threads = (long long)B * n_dest * units;
    const unsigned blocks =
        (unsigned)((threads + kShortThreads - 1) / kShortThreads);
    // rows in flight: 4 where buckets hold 16 sources or more on average
    if (R >= 16 * n_dest)
      segsum_short_kernel<T, V, 4, kWeighted>
          <<<blocks, kShortThreads, 0, st>>>(in, start, src, w, o, B, R,
                                             n_dest, units, long_min);
    else
      segsum_short_kernel<T, V, 2, kWeighted>
          <<<blocks, kShortThreads, 0, st>>>(in, start, src, w, o, B, R,
                                             n_dest, units, long_min);
    if (V == 1) return cudaGetLastError();
    int* list = work;
    int* n_long = work + (long long)B * n_dest;
    segsum_list_kernel<<<B, kScanThreads, 0, st>>>(start, list, n_long,
                                                   n_dest, long_min);
    const size_t smem = long_smem<T>(B);
    int grid = 0;
    cudaError_t err = long_grid<T, kWeighted>(smem, &grid);
    if (err != cudaSuccess) return err;
    segsum_long_kernel<T, kWeighted><<<grid, 32, smem, st>>>(
        static_cast<const T*>(rows), start, src, w, list, n_long,
        static_cast<T*>(out), B, R, n_dest, units * V);
    return cudaGetLastError();
  }
  static cudaError_t run(int units, const void* rows, const int* start,
                         const int* src, const float* w, void* out, int* work,
                         int B, int R, int n_dest, cudaStream_t st) {
    if (w != nullptr)
      return launch<true>(units, rows, start, src, w, out, work, B, R,
                          n_dest, st);
    return launch<false>(units, rows, start, src, w, out, work, B, R, n_dest,
                         st);
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

// idx (B, R) i32 in [0, n_dest) -> start (B, n_dest + 1) and src (B, R)
// i32, each destination's source positions ascending (K56a).  Scratch:
// tiles, B * n_tiles * n_dest i32 with n_tiles = ceil(R / 8192), and rel,
// B * R u16.
int hcmoco_dest_csr(const void* idx, void* start, void* src, void* tiles,
                    void* rel, int B, int R, int n_dest, int n_tiles,
                    void* stream) {
  if (B <= 0 || R <= 0 || n_dest <= 0 || n_dest > kMaxDest ||
      n_tiles != (R + kTile - 1) / kTile)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ii = static_cast<const int*>(idx);
  int* tl = static_cast<int*>(tiles);
  int* sp = static_cast<int*>(start);
  auto* rl = static_cast<unsigned short*>(rel);
  const size_t hist =
      ((size_t)kCountWarps * n_dest + 2 * kTile) * sizeof(unsigned short);
  if (hist > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        csr_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)hist);
    if (err != cudaSuccess) return (int)err;
  }
  csr_count_kernel<<<dim3(n_tiles, B), kCountWarps * 32, hist, st>>>(
      ii, tl, rl, R, n_dest);
  csr_tiles_kernel<<<dim3((n_dest + 255) / 256, B), 256, 0, st>>>(
      tl, sp, n_dest, n_tiles);
  csr_start_kernel<<<B, kScanThreads, 0, st>>>(sp, n_dest);
  csr_fill_kernel<<<dim3((R + 256 * kFillPer - 1) / (256 * kFillPer), B),
                    256, 0, st>>>(
      ii, tl, rl, sp, static_cast<int*>(src), R, n_dest, n_tiles);
  return (int)cudaGetLastError();
}

// rows (B, R / K, C), start (B, n_dest + 1), src (B, R) from
// hcmoco_dest_csr -> out (B, n_dest, C) (K56b).  w: null (K = 1, K5) or
// (B, R) f32, the weight of each source (K = 3, K6).  Scratch: work,
// B * (n_dest + 1) i32.
int hcmoco_segment_sum(const void* rows, const void* start, const void* src,
                       const void* w, void* out, void* work, int B, int R,
                       int n_dest, int C, int dtype, void* stream) {
  if (B <= 0 || R <= 0 || n_dest <= 0 || C <= 0 || (w && R % 3 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(start);
  const int* sr = static_cast<const int*>(src);
  const float* ww = static_cast<const float*>(w);
  int* wk = static_cast<int*>(work);
  const bool al = aligned16(rows) && aligned16(out);
  if (dtype == 1)
    return (int)dispatch_v<__nv_bfloat16, SegmentSum>(
        C, al, rows, sp, sr, ww, out, wk, B, R, n_dest, st);
  return (int)dispatch_v<float, SegmentSum>(C, al, rows, sp, sr, ww, out, wk,
                                            B, R, n_dest, st);
}

}  // extern "C"
