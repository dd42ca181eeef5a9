// Fused local optimizer steps over one dtype bucket of the packed plane:
// K1 SGD (+Nesterov momentum) and K2 AdamW, each one pass over (w, n).
//
// Replaces the Pallas TPU kernels repro/kernels/opt_step/kernel.py::
// sgd_step_flat (_sgd_kernel) and adamw_step_flat (_adamw_kernel). The
// update chain is repro/kernels/opt_step/ref.py's, with its rounding points:
// every op rounds on its own (the __f*_rn intrinsics, which nvcc never
// contracts into a fused multiply-add), bf16 arithmetic with a weakly typed
// constant rounds to bf16 after each op, and x - lr*u runs in float32 before
// one cast back. So the kernel equals the plain PyTorch version
// (repro_torch/kernels/opt_step/ref.py) bit for bit. Division and sqrt are
// the IEEE ones (__fdiv_rn, __fsqrt_rn); no fast math.
//
// lr (and AdamW's c1 = 1 - b1^t, c2 = 1 - b2^t) are read from float32
// scalars in device memory, as the TPU kernel reads them from SMEM, so a step
// needs no host synchronisation and can be captured in a CUDA graph. AdamW
// takes the three as three pointers: the wrapper makes no array of them (a
// launch and an allocation each step, in a call whose device work at the
// classifier's plane is a few microseconds).
//
// What bounds it on the H100: bytes. SGD reads x, g, m and writes x, m
// (5 P bytes an element, P = 4 or 2); AdamW reads x, g, mu, nu and writes
// x, mu, nu (3 P + 16 bytes). At about ten operations an element that is
// ~2 operations a byte, far below the card's ~20 f32 operations a byte, so
// the floor is bytes / 3.35 TB/s.
//
// Design: a grid-stride loop in which each thread takes one 16-byte vector
// of the parameter dtype (4 float or 8 bf16 elements) and the matching
// vectors of every other buffer, so neighbouring threads read neighbouring
// 16-byte chunks and every load coalesces. A tail (a width not a multiple of
// the vector) or a misaligned buffer takes the element-wise loop.
//
// Both kernels take a window: `rows` rows of `width` elements, x and g with
// row stride `ldx`, the optimizer state with row stride `lds`. The streamed
// step of host offload (repro/parallel/offload.py:12-16, streamed_update)
// applies the update to one chunk at a time: the columns [c0, c0 + w) of an
// (m, n) bucket of x and g (row stride n) against a staged (m, c) state
// chunk (row stride c). The whole-plane call is the window of one row whose
// width is the plane's size, so one kernel body serves both. The grid's y
// dimension walks the rows; its x dimension the vectors of a row.
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
// Round to T and back: the per-op rounding of T arithmetic (identity for float).
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

struct SgdArgs {
  float mom, wd;  // weakly typed constants, already rounded to T by the caller
  int has_wd, nesterov;
};

template <typename T>
__device__ __forceinline__ void sgd_elem(T& x, T g, T& m, float lr, const SgdArgs& a) {
  const float xf = to_f(x);
  float gf = to_f(g);
  if (a.has_wd) gf = rnd<T>(__fadd_rn(gf, rnd<T>(__fmul_rn(a.wd, xf))));
  const float mn = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(a.mom, to_f(m))), gf));
  const float u = a.nesterov ? rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(a.mom, mn)), gf)) : mn;
  x = from_f<T>(__fsub_rn(xf, __fmul_rn(lr, u)));
  m = from_f<T>(mn);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sgd_kernel(T* __restrict__ x, const T* __restrict__ g, T* __restrict__ m, const float* __restrict__ scalars,
           long long rows, long long width, long long ldx, long long lds, SgdArgs a, int vec) {
  constexpr int V = 16 / sizeof(T);
  const float lr = scalars[0];
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;
  const long long nv = vec ? width / V : 0;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    T* xr = x + r * ldx;
    const T* gr = g + r * ldx;
    T* mr = m + r * lds;
    for (long long i = tid; i < nv; i += step) {
      uint4 xv = reinterpret_cast<const uint4*>(xr)[i];
      const uint4 gv = reinterpret_cast<const uint4*>(gr)[i];
      uint4 mv = reinterpret_cast<const uint4*>(mr)[i];
      T* xe = reinterpret_cast<T*>(&xv);
      const T* ge = reinterpret_cast<const T*>(&gv);
      T* me = reinterpret_cast<T*>(&mv);
#pragma unroll
      for (int j = 0; j < V; ++j) sgd_elem(xe[j], ge[j], me[j], lr, a);
      reinterpret_cast<uint4*>(xr)[i] = xv;
      reinterpret_cast<uint4*>(mr)[i] = mv;
    }
    for (long long i = nv * V + tid; i < width; i += step) sgd_elem(xr[i], gr[i], mr[i], lr, a);
  }
}

struct AdamArgs {
  float b1, omb1, b2, omb2, eps, wd;  // float32 constants; omb = float(1 - b)
  int has_wd;
};

template <typename T>
__device__ __forceinline__ void adamw_elem(T& x, T g, float& mu, float& nu, float lr, float c1, float c2,
                                           const AdamArgs& a) {
  const float gf = to_f(g);
  mu = __fadd_rn(__fmul_rn(a.b1, mu), __fmul_rn(a.omb1, gf));
  nu = __fadd_rn(__fmul_rn(a.b2, nu), __fmul_rn(a.omb2, __fmul_rn(gf, gf)));
  float u = __fdiv_rn(__fdiv_rn(mu, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, c2)), a.eps));
  const float xf = to_f(x);
  if (a.has_wd) u = __fadd_rn(u, __fmul_rn(a.wd, xf));
  x = from_f<T>(__fsub_rn(xf, __fmul_rn(lr, u)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(T* __restrict__ x, const T* __restrict__ g, float* __restrict__ mu, float* __restrict__ nu,
             const float* __restrict__ lr_p, const float* __restrict__ c1_p, const float* __restrict__ c2_p,
             long long rows, long long width, long long ldx, long long lds, AdamArgs a, int vec) {
  constexpr int V = 16 / sizeof(T);  // elements of T in 16 bytes; V / 4 float4s of moments
  const float lr = *lr_p, c1 = *c1_p, c2 = *c2_p;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;
  const long long nv = vec ? width / V : 0;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    T* xr = x + r * ldx;
    const T* gr = g + r * ldx;
    float* mur_ = mu + r * lds;
    float* nur_ = nu + r * lds;
    for (long long i = tid; i < nv; i += step) {
      uint4 xv = reinterpret_cast<const uint4*>(xr)[i];
      const uint4 gv = reinterpret_cast<const uint4*>(gr)[i];
      float4 mur[V / 4], nur[V / 4];
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        mur[k] = reinterpret_cast<const float4*>(mur_)[i * (V / 4) + k];
        nur[k] = reinterpret_cast<const float4*>(nur_)[i * (V / 4) + k];
      }
      T* xe = reinterpret_cast<T*>(&xv);
      const T* ge = reinterpret_cast<const T*>(&gv);
      float* mue = reinterpret_cast<float*>(mur);
      float* nue = reinterpret_cast<float*>(nur);
#pragma unroll
      for (int j = 0; j < V; ++j) adamw_elem(xe[j], ge[j], mue[j], nue[j], lr, c1, c2, a);
      reinterpret_cast<uint4*>(xr)[i] = xv;
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        reinterpret_cast<float4*>(mur_)[i * (V / 4) + k] = mur[k];
        reinterpret_cast<float4*>(nur_)[i * (V / 4) + k] = nur[k];
      }
    }
    for (long long i = nv * V + tid; i < width; i += step)
      adamw_elem(xr[i], gr[i], mur_[i], nur_[i], lr, c1, c2, a);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The grid of a window: y walks the rows (at most 65,535 at once), x the
// vectors of a row; at most kMaxBlocks blocks in all.
dim3 grid_for(long long rows, long long width, int per_thread) {
  const long long gy = rows < 65535 ? rows : 65535;
  long long cap = kMaxBlocks / gy;
  if (cap < 1) cap = 1;
  long long gx = (width / per_thread + kThreads - 1) / kThreads;
  gx = gx < 1 ? 1 : (gx > cap ? cap : gx);
  return dim3((unsigned)gx, (unsigned)gy);
}

}  // namespace

// A window of `rows` rows of `width` elements: x, g with row stride ldx, m
// with row stride lds (elements). dtype: 0 = float32, 1 = bfloat16 (x, g, m).
// The whole plane: rows 1, width = its size.
extern "C" int sgd_step_launch(void* x, const void* g, void* m, const void* scalars, long long rows,
                               long long width, long long ldx, long long lds, float mom, float wd, int has_wd,
                               int nesterov, int dtype, void* stream) {
  if (rows <= 0 || width <= 0) return 0;
  if (rows > 1 && (ldx < width || lds < width)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const SgdArgs a{mom, wd, has_wd, nesterov};
  const int V = dtype == 0 ? 4 : 8;
  const int vec = aligned16(x) && aligned16(g) && aligned16(m) && (rows == 1 || (ldx % V == 0 && lds % V == 0));
  const float* s = static_cast<const float*>(scalars);
  const dim3 grid = grid_for(rows, width, V);
  if (dtype == 0) {
    sgd_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<float*>(x), static_cast<const float*>(g), static_cast<float*>(m), s, rows, width, ldx, lds, a,
        vec);
  } else if (dtype == 1) {
    sgd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<__nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(m),
        s, rows, width, ldx, lds, a, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// A window as sgd_step_launch's: x, g (parameter dtype, dtype 0 = float32,
// 1 = bfloat16) with row stride ldx; mu, nu float32 with row stride lds; lr,
// c1, c2: one float32 each.
extern "C" int adamw_step_launch(void* x, const void* g, void* mu, void* nu, const void* lr, const void* c1,
                                 const void* c2, long long rows, long long width, long long ldx, long long lds,
                                 float b1, float omb1, float b2, float omb2, float eps, float wd, int has_wd,
                                 int dtype, void* stream) {
  if (rows <= 0 || width <= 0) return 0;
  if (rows > 1 && (ldx < width || lds < width)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const AdamArgs a{b1, omb1, b2, omb2, eps, wd, has_wd};
  const int V = dtype == 0 ? 4 : 8;
  const int vec = aligned16(x) && aligned16(g) && aligned16(mu) && aligned16(nu) &&
                  (rows == 1 || (ldx % V == 0 && lds % 4 == 0));
  const float* lrf = static_cast<const float*>(lr);
  const float* c1f = static_cast<const float*>(c1);
  const float* c2f = static_cast<const float*>(c2);
  float* muf = static_cast<float*>(mu);
  float* nuf = static_cast<float*>(nu);
  const dim3 grid = grid_for(rows, width, V);
  if (dtype == 0) {
    adamw_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<float*>(x), static_cast<const float*>(g), muf, nuf, lrf, c1f, c2f, rows, width, ldx, lds, a,
        vec);
  } else if (dtype == 1) {
    adamw_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<__nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), muf, nuf, lrf, c1f, c2f, rows, width,
        ldx, lds, a, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
