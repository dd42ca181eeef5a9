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
// Design: one block of 256 threads per row. Threads read 16-byte vectors
// (8 bf16 or 4 f32) when the row allows it, else single elements. Each thread
// sums its squares in float32 in a fixed order, the warp reduces by a fixed
// butterfly of shuffles, and warp 0 reduces the eight warp sums the same way,
// so the result is deterministic from run to run. The second pass re-reads
// the row (from L2) and writes y * scale, rounded once to the output type.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ out,
               int d, float eps, int vec) {
  constexpr int kPer = 16 / sizeof(T);  // elements in one 16-byte vector
  const int row = blockIdx.x;
  const T* xr = x + (size_t)row * d;
  T* orow = out + (size_t)row * d;
  __shared__ float warp_sums[kWarps];
  __shared__ float rms;

  float acc = 0.f;
  if (vec) {
    const int nv = d / kPer;
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
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
    const int nv = d / kPer;
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      uint4 sraw = reinterpret_cast<const uint4*>(scale)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      const T* s = reinterpret_cast<const T*>(&sraw);
      uint4 oraw;
      T* o = reinterpret_cast<T*>(&oraw);
#pragma unroll
      for (int j = 0; j < kPer; ++j) o[j] = from_f<T>((to_f(e[j]) / r) * to_f(s[j]));
      reinterpret_cast<uint4*>(orow)[i] = oraw;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads)
      orow[i] = from_f<T>((to_f(xr[i]) / r) * to_f(scale[i]));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, out: (rows, d) contiguous; scale: (d,).
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out, int rows, int d,
                              float eps, int dtype, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int elem = dtype == 0 ? 4 : 2;
  const int per = 16 / elem;
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)scale % 16 == 0) &&
                       ((uintptr_t)out % 16 == 0);
  const int vec = (d % per == 0) && aligned ? 1 : 0;
  if (dtype == 0) {
    rmsnorm_kernel<float><<<rows, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale), static_cast<float*>(out),
        d, eps, vec);
  } else if (dtype == 1) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(scale),
        static_cast<__nv_bfloat16*>(out), d, eps, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
