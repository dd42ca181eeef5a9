// The round boundaries of Overlap Local-SGD over one dtype bucket of the
// packed plane: K4 pullback + worker mean, K3 pullback + worker mean +
// anchor momentum, each in one pass over x (m, n); and K5, the plain
// pullback x <- (1 - a) x + a z of two equal-size buffers (the gossip
// strategies' pull toward each worker's own debiased neighbour mix).
//
// K5 replaces repro/kernels/anchor_mix/kernel.py::anchor_mix_flat
// (_mix_kernel). Bound by bytes: it reads x and z and writes x once
// (3 P N bytes) at 3 operations an element. A grid-stride loop over 16-byte
// vectors with 64-bit indices (the full-width gossip plane has 6.2e9
// elements); x is updated in place, each element rounded as the plain
// version rounds it (__f*_rn: no contraction), so the two agree bit for bit.
//
// K3 and K4 replace the Pallas TPU kernels repro/kernels/anchor_mix/kernel.py::
// pullback_mean_flat (_pullback_mean_kernel) and pullback_momentum_flat
// (_pullback_momentum_kernel), without their probe output:
//   x'_i = (1 - a) x_i + a z                    (eq. 4; dead rows, w_i = 0, keep x_i)
//   mean = sum_i x'_i / m     or  sum_i w_i x'_i (masked)   (eq. 5; K4: of x_i if mean_pre)
//   K3:  v' = b v + (mean - z),  z' = z + v'    (eqs. 10-11)
// with repro/kernels/anchor_mix/ref.py's casts: x', the mean, v' and z' are
// rounded to the plane's dtype where the reference rounds them.
//
// What bounds it on the H100: bytes. x is read and written once (2 P m n
// bytes, P = 4 or 2) and z, v, z', v' once each (4 P n; K4 2 P n), at about
// 5 operations an element of x, far below the card's compute rate.
//
// Design: the TPU kernel holds all m rows of a column block in VMEM and
// reduces over the worker axis there. Here each thread owns one 16-byte
// vector of columns (4 float or 8 bf16) and walks the m rows itself, n
// elements apart, so neighbouring threads read neighbouring 16-byte chunks
// of every row and each load coalesces. The worker sum runs in float32 in
// the fixed order i = 0 .. m-1 and is divided by m (a true division), as
// the plain version (repro_torch/kernels/anchor_mix/ref.py) orders it. No
// atomics, no cross-block reduction: the result is deterministic from run
// to run and equals the plain version bit for bit. x is updated in place
// (each thread reads x_i before it writes x'_i); the anchor outputs go to
// their own buffers. Every op rounds on its own (__f*_rn intrinsics).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

struct MixArgs {
  float oma, alpha;  // float(1 - alpha), alpha
  float beta;        // K3 only
  int m;
  int mean_pre;      // K4: the mean of the pre-pullback rows
};

// V consecutive elements of T, moved as one 16-byte access when they fill
// it (V * sizeof(T) == 16) and element by element otherwise (V == 1).
template <typename T, int V>
struct alignas(16) Lanes {
  T e[V];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (V * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(p);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) e[k] = p[k];
    }
  }
  __device__ __forceinline__ void store(T* p) const {
    if constexpr (V * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(e);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) p[k] = e[k];
    }
  }
};

// Columns j0 .. j0+V-1: pull back their m rows in place, sum the worker axis
// in f32 in order, and write the new anchor (K4: the mean; K3, when
// v != nullptr: z + v' with v' updated in place). w == nullptr: unmasked.
template <typename T, int V>
__device__ __forceinline__ void boundary_columns(T* x, const T* z, T* v, T* z_out, const float* w, long long n,
                                                 long long j0, const MixArgs& a) {
  Lanes<T, V> zr;
  zr.load(z + j0);
  float acc[V];
  for (int i = 0; i < a.m; ++i) {
    T* row = x + (long long)i * n + j0;
    Lanes<T, V> xr, out;
    xr.load(row);
    const bool dead = w != nullptr && !(w[i] > 0.f);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const T xn = from_f<T>(__fadd_rn(__fmul_rn(a.oma, to_f(xr.e[k])), __fmul_rn(a.alpha, to_f(zr.e[k]))));
      out.e[k] = dead ? xr.e[k] : xn;
      const float src = to_f(a.mean_pre ? xr.e[k] : out.e[k]);
      const float term = w != nullptr ? __fmul_rn(src, w[i]) : src;
      acc[k] = i == 0 ? term : __fadd_rn(acc[k], term);
    }
    out.store(row);
  }
  Lanes<T, V> zo, vr{};
  if (v != nullptr) vr.load(v + j0);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const T mean = from_f<T>(w != nullptr ? acc[k] : __fdiv_rn(acc[k], (float)a.m));
    if (v == nullptr) {
      zo.e[k] = mean;
    } else {
      const float zf = to_f(zr.e[k]);
      vr.e[k] = from_f<T>(__fadd_rn(__fmul_rn(a.beta, to_f(vr.e[k])), __fsub_rn(to_f(mean), zf)));
      zo.e[k] = from_f<T>(__fadd_rn(zf, to_f(vr.e[k])));
    }
  }
  if (v != nullptr) vr.store(v + j0);
  zo.store(z_out + j0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
boundary_kernel(T* __restrict__ x, const T* __restrict__ z, T* __restrict__ v, T* __restrict__ z_out,
                const float* __restrict__ w, long long n, MixArgs a, int vec) {
  constexpr int V = 16 / sizeof(T);
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;
  long long done = 0;
  if (vec) {
    const long long nv = n / V;
    for (long long c = tid; c < nv; c += step) boundary_columns<T, V>(x, z, v, z_out, w, n, c * V, a);
    done = nv * V;
  }
  for (long long j = done + tid; j < n; j += step) boundary_columns<T, 1>(x, z, v, z_out, w, n, j, a);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch(void* x, const void* z, void* v, void* z_out, const float* w, long long n, const MixArgs& a,
           cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  // rows are n apart: the vector path needs n to keep every row 16-byte aligned
  const int vec = (n % V == 0) && aligned16(x) && aligned16(z) && aligned16(z_out) && (v == nullptr || aligned16(v));
  long long blocks = (n / V + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  boundary_kernel<T><<<(int)blocks, kThreads, 0, st>>>(
      static_cast<T*>(x), static_cast<const T*>(z), static_cast<T*>(v), static_cast<T*>(z_out), w, n, a, vec);
  return (int)cudaGetLastError();
}

int dispatch(void* x, const void* z, void* v, void* z_out, const void* w, int m, long long n, const MixArgs& a,
             int dtype, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0) return launch<float>(x, z, v, z_out, wf, n, a, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, z, v, z_out, wf, n, a, st);
  return (int)cudaErrorInvalidValue;
}

// K5: x[j] <- (1 - a) x[j] + a z[j] for j < n, V elements a vector.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mix_kernel(T* __restrict__ x, const T* __restrict__ z, long long n, float oma, float alpha, int vec) {
  constexpr int V = 16 / sizeof(T);
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;
  long long done = 0;
  if (vec) {
    const long long nv = n / V;
    for (long long c = tid; c < nv; c += step) {
      Lanes<T, V> xr, zr;
      xr.load(x + c * V);
      zr.load(z + c * V);
#pragma unroll
      for (int k = 0; k < V; ++k)
        xr.e[k] = from_f<T>(__fadd_rn(__fmul_rn(oma, to_f(xr.e[k])), __fmul_rn(alpha, to_f(zr.e[k]))));
      xr.store(x + c * V);
    }
    done = nv * V;
  }
  for (long long j = done + tid; j < n; j += step)
    x[j] = from_f<T>(__fadd_rn(__fmul_rn(oma, to_f(x[j])), __fmul_rn(alpha, to_f(z[j]))));
}

template <typename T>
int launch_mix(void* x, const void* z, long long n, float oma, float alpha, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int vec = aligned16(x) && aligned16(z);
  long long blocks = (n / V + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  mix_kernel<T><<<(int)blocks, kThreads, 0, st>>>(static_cast<T*>(x), static_cast<const T*>(z), n, oma, alpha, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// K5. x, z: n elements each, x updated in place. dtype: 0 = float32,
// 1 = bfloat16 (x and z).
extern "C" int anchor_mix_launch(void* x, const void* z, long long n, float oma, float alpha, int dtype,
                                 void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_mix<float>(x, z, n, oma, alpha, st);
  if (dtype == 1) return launch_mix<__nv_bfloat16>(x, z, n, oma, alpha, st);
  return (int)cudaErrorInvalidValue;
}

// K4. x: (m, n) updated in place; z, mean: (n,); w: (m,) float32 weights or
// null (unmasked). dtype: 0 = float32, 1 = bfloat16 (x, z, mean).
extern "C" int pullback_mean_launch(void* x, const void* z, const void* w, void* mean, int m, long long n,
                                    float oma, float alpha, int mean_pre, int dtype, void* stream) {
  const MixArgs a{oma, alpha, 0.f, m, mean_pre};
  return dispatch(x, z, nullptr, mean, w, m, n, a, dtype, stream);
}

// K3. x: (m, n) and v: (n,) updated in place; z: (n,) read; z_next: (n,)
// written; w as for K4. dtype: 0 = float32, 1 = bfloat16 (x, z, v, z_next).
extern "C" int pullback_momentum_launch(void* x, const void* z, void* v, const void* w, void* z_next, int m,
                                        long long n, float oma, float alpha, float beta, int dtype, void* stream) {
  const MixArgs a{oma, alpha, beta, m, 0};
  return dispatch(x, z, v, z_next, w, m, n, a, dtype, stream);
}
