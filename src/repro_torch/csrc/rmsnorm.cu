// RMSNorm over the last dimension: out = x / sqrt(mean(x^2) + eps) * scale.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm/kernel.py::rmsnorm_2d
// (_rmsnorm_kernel). Statistics in float32, output in the input type, the
// same formula as repro/kernels/rmsnorm/ref.py (a division by sqrtf, not the
// Pallas body's rsqrt), so the kernel and the plain PyTorch version differ
// only in the order of the sum of squares.
//
// What bounds it on the H100: bytes. Each row is read once and written once
// (plus the scale vector), at about 0.1 flop per byte, so the floor is
// bytes / 3.35 TB/s. On the serving path the rows are few (4 decode slots or
// one 32-token prefill chunk at d = 3584), so one launch is a few hundred
// kilobytes at most and the time is launch latency.
//
// Design: the wrapper's planner (kernels/rmsnorm/ops.py::plan) lays a row
// over threads from d, and each thread holds its share of the row in
// registers as 16-byte vectors (8 bf16 or 4 f32), so the row is read once:
//   narrow rows (d <= 1024): a sub-warp of `lanes` (a power of two <= 32)
//     lanes a row, 256 / lanes rows a CTA, the sum of squares reduced by a
//     fixed butterfly of shuffles inside the sub-warp, no barrier (the rwkv6
//     group norm's d = 64: 8 lanes of one vector, 32 rows a CTA);
//   wide rows: one CTA of `lanes` threads a row, sized so that the row's
//     vectors divide evenly where they can (3584 bf16 = 448 vectors = 448
//     threads), warp sums added in warp order after one barrier;
//   otherwise (d not a multiple of the vector, a misaligned pointer, a row
//     over 8 vectors a thread): one block of 256 threads per row that reads
//     the row twice.
// Each thread sums its squares in float32 in a fixed order and every
// reduction has a fixed shape, so the result is the same from run to run.
//
// Backward (new for the port; the reference defines no VJP for its kernel,
// repro/kernels/rmsnorm/ops.py:11-21): with xh = x / rms and dyh = dy * scale,
//   dx     = (dyh - xh * mean(xh * dyh)) / rms, in f32, rounded once to x's type;
//   dscale = sum over rows of dy * xh, in two deterministic stages: each block
//            of rmsnorm_bwd_kernel owns a fixed range of rows and sums them in
//            row order into its own f32 partial row (a thread owns a fixed set
//            of columns, so no two threads touch one word); rmsnorm_dscale_kernel
//            then adds the partial rows in block order and rounds once to
//            scale's type. No atomics: every run gives the same bits.
// At narrow rows (at most 32 vectors, e.g. the group norm's d = 64)
// rmsnorm_bwd_rows_kernel runs a sub-warp a row instead: 1024 / lanes rows
// at a time over the block's range, the next row's loads issued before the
// current row's arithmetic, and each lane's dscale columns summed in
// registers; the block then adds its sub-warps' sums in a fixed order into
// its partial row, so there are about as many partial rows as SMs.
// Bytes bound it too: x, dy and dx once each, plus the partials (blocks x d f32).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16-byte vectors: kPer<T> elements of T in a uint4
template <typename T> constexpr int kPer = 16 / (int)sizeof(T);

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ out,
               int d, float eps, int vec) {
  const int row = blockIdx.x;
  const T* xr = x + (size_t)row * d;
  T* orow = out + (size_t)row * d;
  __shared__ float warp_sums[kWarps];
  __shared__ float rms;

  float acc = 0.f;
  if (vec) {
    const int nv = d / kPer<T>;
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kPer<T>; ++j) {
        float f = to_f(e[j]);
        acc += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      float f = to_f(xr[i]);
      acc += f * f;
    }
  }
  acc = warp_sum(acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kWarps ? warp_sums[lane] : 0.f;
    w = warp_sum(w);
    if (lane == 0) rms = sqrtf(w / (float)d + eps);
  }
  __syncthreads();
  // (x / rms) * scale in float32, as ref.py orders it, rounded once.
  const float r = rms;
  if (vec) {
    const int nv = d / kPer<T>;
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      uint4 sraw = reinterpret_cast<const uint4*>(scale)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      const T* s = reinterpret_cast<const T*>(&sraw);
      uint4 oraw;
      T* o = reinterpret_cast<T*>(&oraw);
#pragma unroll
      for (int j = 0; j < kPer<T>; ++j) o[j] = from_f<T>((to_f(e[j]) / r) * to_f(s[j]));
      reinterpret_cast<uint4*>(orow)[i] = oraw;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads)
      orow[i] = from_f<T>((to_f(xr[i]) / r) * to_f(scale[i]));
  }
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* f) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < kPer<T>; ++j) f[j] = to_f(e[j]);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < kPer<T>; ++j) e[j] = from_f<T>(f[j]);
  return raw;
}

// A sub-warp of `lanes` lanes (a power of two <= 32) a row, kThreads / lanes
// rows a CTA; lane i holds vectors i, i + lanes, ... (at most VECS).
template <typename T, int VECS>
__global__ void __launch_bounds__(kThreads)
rmsnorm_rows_kernel(const uint4* __restrict__ x, const uint4* __restrict__ scale, uint4* __restrict__ out, int rows,
                    int nv, float d, float eps, int lanes) {
  const int lane = threadIdx.x & (lanes - 1);
  const int row = blockIdx.x * (kThreads / lanes) + threadIdx.x / lanes;
  const bool live = row < rows;
  uint4 raw[VECS];
  float acc = 0.f;
#pragma unroll
  for (int v = 0; v < VECS; ++v) {
    const int i = lane + v * lanes;
    raw[v] = make_uint4(0, 0, 0, 0);
    if (live && i < nv) raw[v] = x[(size_t)row * nv + i];
    float f[kPer<T>];
    unpack<T>(raw[v], f);
#pragma unroll
    for (int j = 0; j < kPer<T>; ++j) acc += f[j] * f[j];
  }
  for (int o = lanes / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  const float r = sqrtf(acc / d + eps);
#pragma unroll
  for (int v = 0; v < VECS; ++v) {
    const int i = lane + v * lanes;
    if (!live || i >= nv) continue;
    float f[kPer<T>], g[kPer<T>];
    unpack<T>(raw[v], f);
    unpack<T>(scale[i], g);
#pragma unroll
    for (int j = 0; j < kPer<T>; ++j) f[j] = (f[j] / r) * g[j];  // (x / rms) * scale, as ref.py orders it
    out[(size_t)row * nv + i] = pack<T>(f);
  }
}

// One CTA of blockDim.x threads (a multiple of 32, at most 512) a row;
// thread t holds vectors t, t + blockDim.x, ... (at most VECS).
template <typename T, int VECS>
__global__ void __launch_bounds__(512)
rmsnorm_wide_kernel(const uint4* __restrict__ x, const uint4* __restrict__ scale, uint4* __restrict__ out, int nv,
                    float d, float eps) {
  __shared__ float warp_sums[16];
  const uint4* xr = x + (size_t)blockIdx.x * nv;
  uint4 raw[VECS];
  float acc = 0.f;
#pragma unroll
  for (int v = 0; v < VECS; ++v) {
    const int i = threadIdx.x + v * blockDim.x;
    raw[v] = make_uint4(0, 0, 0, 0);
    if (i < nv) raw[v] = xr[i];
    float f[kPer<T>];
    unpack<T>(raw[v], f);
#pragma unroll
    for (int j = 0; j < kPer<T>; ++j) acc += f[j] * f[j];
  }
  acc = warp_sum(acc);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = acc;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) total += warp_sums[w];
  const float r = sqrtf(total / d + eps);
#pragma unroll
  for (int v = 0; v < VECS; ++v) {
    const int i = threadIdx.x + v * blockDim.x;
    if (i >= nv) continue;
    float f[kPer<T>], g[kPer<T>];
    unpack<T>(raw[v], f);
    unpack<T>(scale[i], g);
#pragma unroll
    for (int j = 0; j < kPer<T>; ++j) f[j] = (f[j] / r) * g[j];
    out[(size_t)blockIdx.x * nv + i] = pack<T>(f);
  }
}

constexpr int kBwdThreads = 1024;

// Backward at narrow rows: a sub-warp of `lanes` lanes a row (one vector a
// lane, nv <= lanes <= 32), kBwdThreads / lanes sub-warps a CTA walking the
// CTA's rows [r0, r1) in a fixed order; the CTA's dscale partial row is its
// sub-warps' register sums added in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_rows_kernel(const uint4* __restrict__ x, const uint4* __restrict__ scale, const uint4* __restrict__ dy,
                        uint4* __restrict__ dx, float* __restrict__ partial, int rows, int nv, float eps, int lanes,
                        int rows_per_block) {
  constexpr int P = kPer<T>;
  __shared__ float sums[kBwdThreads * P];  // [sub-warp][column], Dp = lanes * P columns
  __shared__ float parts[kBwdThreads];
  const int lane = threadIdx.x & (lanes - 1);
  const int group = threadIdx.x / lanes, groups = kBwdThreads / lanes;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  const int iters = (rows_per_block + groups - 1) / groups;  // the same in every lane: shuffles need the whole warp
  const bool col = lane < nv;
  const float d = (float)(nv * P);
  float s[P], ds[P];
  {
    uint4 raw = col ? scale[lane] : make_uint4(0, 0, 0, 0);
    unpack<T>(raw, s);
  }
#pragma unroll
  for (int j = 0; j < P; ++j) ds[j] = 0.f;
  int row = r0 + group;
  uint4 xa = make_uint4(0, 0, 0, 0), ga = make_uint4(0, 0, 0, 0);
  if (col && row < r1) {
    xa = x[(size_t)row * nv + lane];
    ga = dy[(size_t)row * nv + lane];
  }
  for (int it = 0; it < iters; ++it, row += groups) {
    const bool live = row < r1;
    const int next = row + groups;
    uint4 xn = make_uint4(0, 0, 0, 0), gn = make_uint4(0, 0, 0, 0);
    if (col && next < r1) {
      xn = x[(size_t)next * nv + lane];
      gn = dy[(size_t)next * nv + lane];
    }
    float xf[P], gf[P];
    unpack<T>(xa, xf);
    unpack<T>(ga, gf);
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      ss += xf[j] * xf[j];
      dot += gf[j] * s[j] * xf[j];
    }
    for (int o = lanes / 2; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    const float rms = sqrtf(ss / d + eps);
    const float mdot = dot / rms / d;  // mean(xh * dyh)
    if (live && col) {
      float o[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float xh = xf[j] / rms;
        o[j] = (gf[j] * s[j] - xh * mdot) / rms;
        ds[j] += gf[j] * xh;
      }
      dx[(size_t)row * nv + lane] = pack<T>(o);
    }
    xa = xn;
    ga = gn;
  }
  // the CTA's partial row: each column's sub-warp sums, in sub-warp order,
  // first P at a time, then those P-sums in order
  const int dp = lanes * P;
#pragma unroll
  for (int j = 0; j < P; ++j) sums[group * dp + lane * P + j] = ds[j];
  __syncthreads();
  const int c = threadIdx.x % dp, part = threadIdx.x / dp;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) acc += sums[(part * P + i) * dp + c];
  parts[part * dp + c] = acc;
  __syncthreads();
  if (threadIdx.x < nv * P) {
    float tot = 0.f;
    for (int q = 0; q < kBwdThreads / dp; ++q) tot += parts[q * dp + threadIdx.x];
    partial[(size_t)blockIdx.x * nv * P + threadIdx.x] = tot;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ partial, int rows, int d, float eps, int rows_per_block) {
  extern __shared__ float ds_acc[];  // this block's dscale partial, d floats
  __shared__ float warp_sums[2][kWarps];
  __shared__ float stats[2];
  for (int c = threadIdx.x; c < d; c += kThreads) ds_acc[c] = 0.f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int row = r0; row < r1; ++row) {
    const T* xr = x + (size_t)row * d;
    const T* gr = dy + (size_t)row * d;
    float ss = 0.f, dot = 0.f;
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float xf = to_f(xr[c]);
      ss += xf * xf;
      dot += to_f(gr[c]) * to_f(scale[c]) * xf;
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    if (lane == 0) {
      warp_sums[0][warp] = ss;
      warp_sums[1][warp] = dot;
    }
    __syncthreads();
    if (warp == 0) {
      float a = lane < kWarps ? warp_sums[0][lane] : 0.f;
      float b = lane < kWarps ? warp_sums[1][lane] : 0.f;
      a = warp_sum(a);
      b = warp_sum(b);
      if (lane == 0) {
        const float rms = sqrtf(a / (float)d + eps);
        stats[0] = rms;
        stats[1] = b / rms / (float)d;  // mean(xh * dyh)
      }
    }
    __syncthreads();
    const float rms = stats[0], mdot = stats[1];
    T* dxr = dx + (size_t)row * d;
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float g = to_f(gr[c]);
      const float xh = to_f(xr[c]) / rms;
      dxr[c] = from_f<T>((g * to_f(scale[c]) - xh * mdot) / rms);
      ds_acc[c] += g * xh;
    }
    __syncthreads();  // stats and warp_sums are reused by the next row
  }
  for (int c = threadIdx.x; c < d; c += kThreads) partial[(size_t)blockIdx.x * d + c] = ds_acc[c];
}

template <typename T>
__global__ void rmsnorm_dscale_kernel(const float* __restrict__ partial, T* __restrict__ dscale, int blocks, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  int b = 0;
  for (; b + 8 <= blocks; b += 8) {  // eight loads in flight, added in block order
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = partial[(size_t)(b + i) * d + c];
#pragma unroll
    for (int i = 0; i < 8; ++i) s += v[i];
  }
  for (; b < blocks; ++b) s += partial[(size_t)b * d + c];
  dscale[c] = from_f<T>(s);
}

bool aligned(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if ((uintptr_t)p % 16) return false;
  return true;
}

template <typename T, int V>
void fwd_planned(const void* x, const void* scale, void* out, int rows, int nv, float d, float eps, int lanes,
                 cudaStream_t st) {
  const uint4* xv = static_cast<const uint4*>(x);
  const uint4* sv = static_cast<const uint4*>(scale);
  uint4* ov = static_cast<uint4*>(out);
  if (lanes <= 32) {
    const int per_cta = kThreads / lanes;
    rmsnorm_rows_kernel<T, V><<<(rows + per_cta - 1) / per_cta, kThreads, 0, st>>>(xv, sv, ov, rows, nv, d, eps, lanes);
  } else {
    rmsnorm_wide_kernel<T, V><<<rows, lanes, 0, st>>>(xv, sv, ov, nv, d, eps);
  }
}

template <typename T>
int fwd(const void* x, const void* scale, void* out, int rows, int d, float eps, int lanes, int vecs, cudaStream_t st) {
  const bool vec = d % kPer<T> == 0 && aligned({x, scale, out});
  if (lanes == 0 || !vec) {
    rmsnorm_kernel<T><<<rows, kThreads, 0, st>>>(static_cast<const T*>(x), static_cast<const T*>(scale),
                                                 static_cast<T*>(out), d, eps, vec ? 1 : 0);
    return (int)cudaGetLastError();
  }
  const int nv = d / kPer<T>;
  const bool narrow = lanes <= 32 && (lanes & (lanes - 1)) == 0;
  const bool wide = lanes > 32 && lanes <= 512 && lanes % 32 == 0;
  if (!(narrow || wide) || (long long)lanes * vecs < nv) return (int)cudaErrorInvalidValue;  // every vector covered
  switch (vecs) {
    case 1: fwd_planned<T, 1>(x, scale, out, rows, nv, (float)d, eps, lanes, st); break;
    case 2: fwd_planned<T, 2>(x, scale, out, rows, nv, (float)d, eps, lanes, st); break;
    case 4: fwd_planned<T, 4>(x, scale, out, rows, nv, (float)d, eps, lanes, st); break;
    case 8: fwd_planned<T, 8>(x, scale, out, rows, nv, (float)d, eps, lanes, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const void* scale, const void* dy, void* dx, void* dscale, void* partial, int rows, int d,
        float eps, int lanes, int rows_per_block, cudaStream_t st) {
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  const int nv = d / kPer<T>;
  if (lanes > 0 && lanes <= 32 && (lanes & (lanes - 1)) == 0 && d % kPer<T> == 0 && nv <= lanes &&
      aligned({x, scale, dy, dx})) {
    rmsnorm_bwd_rows_kernel<T><<<blocks, kBwdThreads, 0, st>>>(
        static_cast<const uint4*>(x), static_cast<const uint4*>(scale), static_cast<const uint4*>(dy),
        static_cast<uint4*>(dx), static_cast<float*>(partial), rows, nv, eps, lanes, rows_per_block);
  } else {
    const int smem = d * (int)sizeof(float);
    // the opt-in counts the static shared memory too (warp_sums and stats):
    // at d = 12288 the dynamic part alone is exactly the 48 KiB default
    constexpr int kStatic = (2 * kWarps + 2) * (int)sizeof(float);
    if (smem + kStatic > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(rmsnorm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    rmsnorm_bwd_kernel<T><<<blocks, kThreads, smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<const T*>(dy), static_cast<T*>(dx),
        static_cast<float*>(partial), rows, d, eps, rows_per_block);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rmsnorm_dscale_kernel<T><<<(d + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<T*>(dscale), blocks, d);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, out: (rows, d) contiguous; scale: (d,).
// (lanes, vecs) from the wrapper's planner: lanes <= 32 a sub-warp a row,
// lanes > 32 a CTA of that many threads a row, each thread holding up to vecs
// 16-byte vectors; lanes == 0 (or a row that is not in whole aligned
// vectors) the block-per-row kernel.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out, int rows, int d, float eps, int dtype,
                              int lanes, int vecs, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, scale, out, rows, d, eps, lanes, vecs, st);
  if (dtype == 1) return fwd<__nv_bfloat16>(x, scale, out, rows, d, eps, lanes, vecs, st);
  return (int)cudaErrorInvalidValue;
}

// x, dy, dx: (rows, d) contiguous; scale, dscale: (d,); partial: f32 scratch of
// ceil(rows / rows_per_block) x d. lanes > 0: the sub-warp-a-row kernel (rows
// of at most `lanes` aligned vectors); 0: the block kernel.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
                                  void* partial, int rows, int d, float eps, int lanes, int rows_per_block, int dtype,
                                  void* stream) {
  if (rows <= 0 || d <= 0 || rows_per_block <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd<float>(x, scale, dy, dx, dscale, partial, rows, d, eps, lanes, rows_per_block, st);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(x, scale, dy, dx, dscale, partial, rows, d, eps, lanes, rows_per_block, st);
  return (int)cudaErrorInvalidValue;
}
