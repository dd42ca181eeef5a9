// The round boundaries of Overlap Local-SGD over one dtype bucket of the
// packed plane: K4 pullback + worker mean, K3 pullback + worker mean +
// anchor momentum, each in one pass over x (m, n); K5, the plain pullback
// x <- (1 - a) x + a z of two equal-size buffers (the gossip strategies' pull
// toward each worker's own debiased neighbour mix); and K8, the consensus
// probe of adaptive tau, standalone or fused into K3/K4.
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
// (_pullback_momentum_kernel):
//   x'_i = (1 - a) x_i + a z                    (eq. 4; dead rows, w_i = 0, keep x_i)
//   mean = sum_i x'_i / m     or  sum_i w_i x'_i (masked)   (eq. 5; K4: of x_i if mean_pre)
//   K3:  v' = b v + (mean - z),  z' = z + v'    (eqs. 10-11)
// with repro/kernels/anchor_mix/ref.py's casts: x', the mean, v' and z' are
// rounded to the plane's dtype where the reference rounds them.
//
// K8 replaces repro/kernels/consensus_probe/kernel.py::probe_flat
// (_probe_kernel) and the probe output of K3/K4 (_accum_probe): over the
// pre-pullback plane, with xbar the unweighted f32 worker mean of all m rows
// (dead rows included, masked or not),
//   drift_sq = sum_{i,j} (x_ij - xbar_j)^2,   scale_sq = sum_j xbar_j^2.
// The TPU kernels add each block's lane partials into VMEM scratch across a
// grid that runs in order; blocks here run in no order. So each thread adds
// its columns' squares into two float64 sums, a block reduces its threads'
// sums in a fixed tree and writes one pair into a per-device workspace, and
// the block that finishes last (an unsigned atomic counter after a
// __threadfence, no float atomics) sums the workspace in a fixed order,
// writes the (2,) float32 result and resets the counter. The grid depends on
// n and the dtype only, so the result is the same bits from run to run, and
// the fused output of K3/K4 equals the standalone K8's on the same plane bit
// for bit (same grid, same column mapping, same device functions) whenever
// both take the 16-byte vector path (n a multiple of the vector width, every
// buffer 16-byte aligned, as fresh allocations are). Each column is read
// twice for the probe (the f32 mean in row order 0 .. m-1 over m, then the
// squared deviations, in float32 and then added in float64; not the one-pass
// sum x^2 - m xbar^2, which cancels near consensus) before the pullback reads
// it again: the re-reads hit L1/L2, so K3/K4's bytes from device memory do
// not change, and the fused probe adds no launch.
//
// What bounds them on the H100: bytes. K3/K4 read and write x once (2 P m n
// bytes, P = 4 or 2) and z, v, z', v' once each (4 P n; K4 2 P n); K8 reads
// x once (P m n). The arithmetic (about 5 float ops an element, K8 about 4
// and two float64 adds) is far below the card's compute rate.
//
// Design: the TPU kernel holds all m rows of a column block in VMEM and
// reduces over the worker axis there. Here each thread owns one 16-byte
// vector of columns (4 float or 8 bf16) and walks the m rows itself, n
// elements apart, so neighbouring threads read neighbouring 16-byte chunks
// of every row and each load coalesces. The worker sum runs in float32 in
// the fixed order i = 0 .. m-1 and is divided by m (a true division), as
// the plain version (repro_torch/kernels/anchor_mix/ref.py) orders it. The
// pullback itself needs no cross-block reduction: K3/K4 without the probe
// equal the plain version bit for bit. x is updated in place (each thread
// reads x_i before it writes x'_i); the anchor outputs go to their own
// buffers. Every op rounds on its own (__f*_rn intrinsics).
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

// The consensus probe's output and scratch: out (2,) float32, ws one float64
// pair a block, counter an unsigned int that is 0 between launches. out ==
// nullptr: no probe.
struct Probe {
  float* out;
  double* ws;
  unsigned int* counter;
};

// K8's per-column work, shared by the standalone kernel and K3/K4: columns
// j0 .. j0+V-1 of the m rows of x (before any write to them). The f32 worker
// mean in row order over m, then (x_ij - xbar_j)^2 and xbar_j^2, each rounded
// to float32 and added to the thread's float64 sums (rows outer, lanes inner).
template <typename T, int V>
__device__ __forceinline__ void probe_columns(const T* x, long long n, long long j0, int m, double& drift,
                                              double& scale) {
  float mu[V];
  for (int i = 0; i < m; ++i) {
    Lanes<T, V> xr;
    xr.load(x + (long long)i * n + j0);
#pragma unroll
    for (int k = 0; k < V; ++k) mu[k] = i == 0 ? to_f(xr.e[k]) : __fadd_rn(mu[k], to_f(xr.e[k]));
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mu[k] = __fdiv_rn(mu[k], (float)m);
    scale += (double)__fmul_rn(mu[k], mu[k]);
  }
  for (int i = 0; i < m; ++i) {
    Lanes<T, V> xr;
    xr.load(x + (long long)i * n + j0);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float d = __fsub_rn(to_f(xr.e[k]), mu[k]);
      drift += (double)__fmul_rn(d, d);
    }
  }
}

__device__ __forceinline__ void block_tree(double* sd, double* ss) {
  const int t = threadIdx.x;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      sd[t] += sd[t + s];
      ss[t] += ss[t + s];
    }
    __syncthreads();
  }
}

// K8's cross-block stage: every block of the launch calls it once with its
// threads' sums. Fixed trees and a fixed order only, no float atomics.
__device__ __forceinline__ void probe_finish(double drift, double scale, const Probe& p) {
  __shared__ double sd[kThreads], ss[kThreads];
  __shared__ bool last;
  const int t = threadIdx.x;
  sd[t] = drift;
  ss[t] = scale;
  block_tree(sd, ss);
  if (t == 0) {
    p.ws[2 * blockIdx.x] = sd[0];
    p.ws[2 * blockIdx.x + 1] = ss[0];
    __threadfence();
    last = atomicAdd(p.counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // thread t sums blocks t, t + kThreads, ... in order; then the fixed tree
  double d = 0.0, s = 0.0;
  for (unsigned int b = t; b < gridDim.x; b += kThreads) {
    d += __ldcg(p.ws + 2 * b);
    s += __ldcg(p.ws + 2 * b + 1);
  }
  sd[t] = d;
  ss[t] = s;
  block_tree(sd, ss);
  if (t == 0) {
    p.out[0] = __double2float_rn(sd[0]);
    p.out[1] = __double2float_rn(ss[0]);
    *p.counter = 0u;
  }
}

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

template <typename T, bool kProbe>
__global__ void __launch_bounds__(kThreads)
boundary_kernel(T* __restrict__ x, const T* __restrict__ z, T* __restrict__ v, T* __restrict__ z_out,
                const float* __restrict__ w, long long n, MixArgs a, int vec, Probe p) {
  constexpr int V = 16 / sizeof(T);
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;
  double drift = 0.0, scale = 0.0;
  long long done = 0;
  if (vec) {
    const long long nv = n / V;
    for (long long c = tid; c < nv; c += step) {
      if constexpr (kProbe) probe_columns<T, V>(x, n, c * V, a.m, drift, scale);
      boundary_columns<T, V>(x, z, v, z_out, w, n, c * V, a);
    }
    done = nv * V;
  }
  for (long long j = done + tid; j < n; j += step) {
    if constexpr (kProbe) probe_columns<T, 1>(x, n, j, a.m, drift, scale);
    boundary_columns<T, 1>(x, z, v, z_out, w, n, j, a);
  }
  if constexpr (kProbe) probe_finish(drift, scale, p);
}

// K8 standalone: the same grid and column mapping as boundary_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const T* __restrict__ x, long long n, int m, int vec, Probe p) {
  constexpr int V = 16 / sizeof(T);
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;
  double drift = 0.0, scale = 0.0;
  long long done = 0;
  if (vec) {
    const long long nv = n / V;
    for (long long c = tid; c < nv; c += step) probe_columns<T, V>(x, n, c * V, m, drift, scale);
    done = nv * V;
  }
  for (long long j = done + tid; j < n; j += step) probe_columns<T, 1>(x, n, j, m, drift, scale);
  probe_finish(drift, scale, p);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int grid_for(long long n) {
  constexpr int V = 16 / sizeof(T);
  long long blocks = (n / V + kThreads - 1) / kThreads;
  return (int)(blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks));
}

template <typename T>
int launch(void* x, const void* z, void* v, void* z_out, const float* w, long long n, const MixArgs& a,
           const Probe& p, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  // rows are n apart: the vector path needs n to keep every row 16-byte aligned
  const int vec = (n % V == 0) && aligned16(x) && aligned16(z) && aligned16(z_out) && (v == nullptr || aligned16(v));
  auto* xt = static_cast<T*>(x);
  auto* zt = static_cast<const T*>(z);
  auto* vt = static_cast<T*>(v);
  auto* ot = static_cast<T*>(z_out);
  if (p.out != nullptr)
    boundary_kernel<T, true><<<grid_for<T>(n), kThreads, 0, st>>>(xt, zt, vt, ot, w, n, a, vec, p);
  else
    boundary_kernel<T, false><<<grid_for<T>(n), kThreads, 0, st>>>(xt, zt, vt, ot, w, n, a, vec, p);
  return (int)cudaGetLastError();
}

int dispatch(void* x, const void* z, void* v, void* z_out, const void* w, int m, long long n, const MixArgs& a,
             const Probe& p, int dtype, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (n <= 0 || m <= 0)
    return p.out == nullptr ? 0 : (int)cudaMemsetAsync(p.out, 0, 2 * sizeof(float), st);
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0) return launch<float>(x, z, v, z_out, wf, n, a, p, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, z, v, z_out, wf, n, a, p, st);
  return (int)cudaErrorInvalidValue;
}

Probe probe_args(void* out, void* ws, void* counter) {
  return Probe{static_cast<float*>(out), static_cast<double*>(ws), static_cast<unsigned int*>(counter)};
}

template <typename T>
int launch_probe(const void* x, int m, long long n, const Probe& p, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int vec = (n % V == 0) && aligned16(x);
  probe_kernel<T><<<grid_for<T>(n), kThreads, 0, st>>>(static_cast<const T*>(x), n, m, vec, p);
  return (int)cudaGetLastError();
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
  const int vec = aligned16(x) && aligned16(z);
  mix_kernel<T><<<grid_for<T>(n), kThreads, 0, st>>>(static_cast<T*>(x), static_cast<const T*>(z), n, oma, alpha, vec);
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
// null (unmasked). stats: (2,) float32 probe output or null (no probe), with
// ws (2 kMaxBlocks float64) and counter (one unsigned int, 0) its scratch.
// dtype: 0 = float32, 1 = bfloat16 (x, z, mean).
extern "C" int pullback_mean_launch(void* x, const void* z, const void* w, void* mean, int m, long long n,
                                    float oma, float alpha, int mean_pre, void* stats, void* ws, void* counter,
                                    int dtype, void* stream) {
  const MixArgs a{oma, alpha, 0.f, m, mean_pre};
  return dispatch(x, z, nullptr, mean, w, m, n, a, probe_args(stats, ws, counter), dtype, stream);
}

// K3. x: (m, n) and v: (n,) updated in place; z: (n,) read; z_next: (n,)
// written; w and the probe as for K4. dtype: 0 = float32, 1 = bfloat16
// (x, z, v, z_next).
extern "C" int pullback_momentum_launch(void* x, const void* z, void* v, const void* w, void* z_next, int m,
                                        long long n, float oma, float alpha, float beta, void* stats, void* ws,
                                        void* counter, int dtype, void* stream) {
  const MixArgs a{oma, alpha, beta, m, 0};
  return dispatch(x, z, v, z_next, w, m, n, a, probe_args(stats, ws, counter), dtype, stream);
}

// K8. x: (m, n) read; stats: (2,) float32 written, [drift_sq, scale_sq];
// ws and counter as for K4. dtype: 0 = float32, 1 = bfloat16.
extern "C" int consensus_probe_launch(const void* x, int m, long long n, void* stats, void* ws, void* counter,
                                      int dtype, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (n <= 0 || m <= 0) return (int)cudaMemsetAsync(stats, 0, 2 * sizeof(float), st);
  const Probe p = probe_args(stats, ws, counter);
  if (dtype == 0) return launch_probe<float>(x, m, n, p, st);
  if (dtype == 1) return launch_probe<__nv_bfloat16>(x, m, n, p, st);
  return (int)cudaErrorInvalidValue;
}
