// The round boundaries of Overlap Local-SGD over one dtype bucket of the
// packed plane: K4 pullback + worker mean, K3 pullback + worker mean +
// anchor momentum, each in one pass over x (m, n); K5, the plain pullback
// x <- (1 - a) x + a z of two equal-size buffers (the gossip strategies' pull
// toward each worker's own debiased neighbour mix); and K8, the consensus
// probe of adaptive tau, standalone or fused into K3/K4.
//
// K5 replaces repro/kernels/anchor_mix/kernel.py::anchor_mix_flat
// (_mix_kernel). Bound by bytes: it reads x and z and writes x once
// (3 P N bytes) at 3 operations an element. A loop over 16-byte vectors
// with 64-bit indices (the full-width gossip plane has 6.2e9 elements), in a
// grid that gives every vector a thread of its own: on the H100 a grid of
// whole resident waves striding over the plane moved the same bytes slower
// than blocks launched for every tile, as torch's elementwise kernels are
// (streaming cache hints made no difference). x is updated in place, each
// element rounded as the plain version rounds it (__f*_rn: no contraction),
// so the two agree bit for bit.
//
// K5, row form: x is `rows` rows of `width` elements, ldx apart, and z the
// same with ldz apart; ldz = 0 gives every row one z (the per-leaf pullback
// of a worker-stacked leaf toward the unstacked anchor, which the reference
// runs as K5 vmapped over the workers). A thread owns a vector of columns
// and walks the rows, so with ldz = 0 it reads its z vector once for all of
// them: (2 rows + 1) P width bytes. The one-row launch is the same-shape K5
// above (the loop body is the same expression, mix1), bit for bit.
//
// K5, gossip form: the push-sum gossip boundary over one dtype bucket in one
// pass, in place on x and mix (m, n). Per column j:
//   z_i    = round(f32(mix_ij) / wsafe_i)                       (the debias)
//   x'_ij  = live_i ? round((1 - a) x_ij + a z_i) : x_ij        (K5; dead or
//            massless rows keep x)
//   mix'_ij = round(sum_k Peff[i,k] f32(x'_kj)), k = 0 .. m-1 in order,
//            each product and add rounded on its own            (the push)
// with wsafe, live (m,) and Peff (m, m) float32 on the device. It reads x
// and mix once and writes each once (4 P m n bytes; dead rows are not
// rewritten); the push is 2 m operations an element, so at the worker
// counts the strategies run the bytes bound it. The reference
// (repro/core/strategy.py, GossipPushSumStrategy._packed_boundary) runs the
// debias, K5, a select and an einsum as four passes. Every step after the
// debias works on one column across the m rows, so a thread owns a vector of
// V columns of all m rows: the m rows' loads go out together, x' stays in
// the registers x was loaded into for the push. The register path is
// compiled for a bound mmax on m of 4 (the LM's workers) and 16 (the
// classifier's); its guards on k < m make each right for every smaller m.
// V is the widest vector of at most 16 bytes whose mmax rows hold at most
// 64 values of x': 16 bytes at mmax 4, 16 bytes in f32 and 8 in bf16 at
// mmax 16 (wider bounds unroll pushes of 32^2 and 64^2 products, which
// spilled and took minutes to compile). A plane of fewer vectors than one
// wave of full blocks (the classifier's) runs a column a thread instead, in
// narrower blocks, so the push spreads over every SM. Past m = 16 a thread
// owns one column, writes x' row by row and reads it back from x for the
// push. A scalar tail takes n not a multiple of V and buffers not aligned
// to V. The grid gives every vector (or column) a thread, as K5's does.
//
// K5, gossip rank form: the push-sum gossip boundary of one rank's r rows
// when the worker axis is spread over torch.distributed ranks. The stacked
// form pushes mix' = Peff @ x' at boundary k and debiases it at k+1; on ranks
// the push is a neighbour exchange of the launch-time rows x' (launched at
// boundary k, waited on at k+1), and the mix is formed where it is consumed.
// Per column j, from the h held rows (this rank's own launch-time copy `own`
// and the received rows `recv`, in ascending global order g_0 < .. < g_{h-1}):
//   mix_i  = round(sum_k Peff[lo+i, g_k] f32(held_kj)), k = 0 .. h-1 in order,
//            each product and add rounded on its own       (mode 0)
//   mix_i  = own_ij                                        (mode 1: own holds
//            the finished mix, the first boundary and the one after a drain)
//   z_i    = round(f32(mix_i) / wsafe_i),  x_ij <- live_i ? round((1-a) x_ij + a z_i) : x_ij
//   own_ij <- x_ij                                         (the next launch-time copy)
// and in mode 2 (the drain) out_ij <- mix_i alone, x untouched. The rows that
// are not held have Peff = 0 in the stacked sum, whose terms are the same
// products in the same order; a skipped exact 0 leaves a finite sum as it is
// (only the sign of a zero sum may differ). wsafe, live (r,) and Peff (m, m)
// are float32 on the device, the held table (2, h) int32: the row's source
// (k >= 0: recv row k, < 0: own row -1-k) and its global index. Up to 16 held
// rows a thread keeps them in registers for a vector of columns (bound mmax 4
// and 16, as the gossip form), so it reads x, own and the received rows once
// and writes x and own once: (3 r + h) P n bytes. Past 16 a thread owns a
// column and reads the held rows from memory, pulling every row back before
// it rewrites own. Bound by bytes.
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
// K3 and K4, rank form: the boundary of one rank's rows when the worker axis
// is spread over torch.distributed ranks (repro_torch/parallel/sharding.py).
// The stacked K3/K4 pull back all m rows and sum them in one pass; on W ranks
// the worker sum is an all-reduce of per-rank f32 partial sums, launched at
// boundary k and waited on at boundary k+1. So the rank form runs the two
// ends of K3/K4 around that collective, per column j, in one pass:
//   finish (S holds boundary k's worker sum S_k):
//     mean = round(S_k / m)                 (K3/K4's __fdiv_rn and rounding)
//     K3: v' = round(b v + (mean - z_k)),  z_{k+1} = round(z_k + v')
//     K4: z_{k+1} = mean
//   pull back the rank's r rows toward z_{k+1} (eq. 4) and write their f32
//   sum, rows 0 .. r-1 in order, over S (the next all-reduce's input).
// Without finish (the first boundary, or after a drain) z is the final
// anchor and only the second part runs; with r = 0 (the drain) only the
// first. The rounding chain is boundary_columns', op for op, so on one rank,
// or on two ranks of one row each (a two-term f32 sum commutes), the run
// equals the stacked one bit for bit. Bound by bytes: x read and written
// (2 P r n), S read and written (8 n: f32 for bf16 planes too, as the
// reference sums in f32), z read and z', v, v' (4 P n; K4 reads no z when it
// finishes and writes z' alone). Replaces the same Pallas kernels as K3/K4.
// The same body takes the masked and EASGD boundaries' operands:
//   w (the rank's rows' slice of a membership's (m,) weights): dead rows
//     (w_i = 0) pass through and the partial sum is sum_i w_i x_i, each
//     product rounded, as boundary_columns weights its terms;
//   mean_pre: the partial sum is of the pre-pullback rows (EASGD's
//     symmetric mix);
//   finish 2: S is a weighted sum, so the mean is round(S_k) with no
//     division (the membership of boundary k, not k+1, decides the form).
//
// K8, rank form: one rank's rows x (r, n) and the global f32 column mean
// xbar (the all-reduced unweighted row sums over m, which no rank holds
// before the collective) give sum_{i,j} (x_ij - xbar_j)^2 over the rank's
// rows and sum_j xbar_j^2, the float64 sums K8 keeps, written as float64 so
// that the ranks' drift sums add in float64 before the one rounding to f32.
// The same per-thread sums, block tree and last-block reduction as K8.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

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

// V consecutive elements of T, moved as one access of V * sizeof(T) bytes
// when that is 16, 8 or 4 (the pointer aligned to it) and element by element
// otherwise.
template <typename T, int V>
struct alignas(V * sizeof(T) >= 16 ? 16 : V * sizeof(T)) Lanes {
  static constexpr int kBytes = V * sizeof(T);
  using Word = typename std::conditional<kBytes == 16, uint4,
               typename std::conditional<kBytes == 8, uint2, unsigned int>::type>::type;
  static constexpr bool kWord = kBytes == 16 || kBytes == 8 || kBytes == 4;
  T e[V];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kWord) {
      *reinterpret_cast<Word*>(e) = *reinterpret_cast<const Word*>(p);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) e[k] = p[k];
    }
  }
  __device__ __forceinline__ void store(T* p) const {
    if constexpr (kWord) {
      *reinterpret_cast<Word*>(p) = *reinterpret_cast<const Word*>(e);
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
  double* out64 = nullptr;  // K8's rank form: the float64 sums, not rounded
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
    if (p.out64 != nullptr) {
      p.out64[0] = sd[0];
      p.out64[1] = ss[0];
    } else {
      p.out[0] = __double2float_rn(sd[0]);
      p.out[1] = __double2float_rn(ss[0]);
    }
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

// V consecutive floats of the rank form's f32 wire buffer, as 16-byte
// accesses when V is a multiple of 4 (the caller's vector path aligns them).
template <int V>
__device__ __forceinline__ void load_f32(float* d, const float* p) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) *reinterpret_cast<float4*>(d + 4 * q) = *reinterpret_cast<const float4*>(p + 4 * q);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) d[k] = p[k];
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float* d) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) *reinterpret_cast<float4*>(p + 4 * q) = *reinterpret_cast<const float4*>(d + 4 * q);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = d[k];
  }
}

struct RankArgs {
  float oma, alpha, beta;
  int rows;      // this rank's rows of x (0: finish only, the drain)
  int m;         // the worker count over all ranks (the mean's divisor)
  int finish;    // s holds the last boundary's worker sum: finish its anchor first (2: a weighted sum)
  int mean_pre;  // the partial sum of the pre-pullback rows (EASGD)
};

// The rank form on columns j0 .. j0+V-1 (see the header). v == nullptr: K4;
// w == nullptr: unmasked.
template <typename T, int V>
__device__ __forceinline__ void rank_columns(T* x, const T* z, T* v, const float* w, float* s, T* z_out, long long n,
                                             long long j0, const RankArgs& a) {
  Lanes<T, V> zr;
  if (!a.finish || v != nullptr) zr.load(z + j0);
  if (a.finish) {
    float sr[V];
    load_f32<V>(sr, s + j0);
    Lanes<T, V> vr{};
    if (v != nullptr) vr.load(v + j0);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const T mean = from_f<T>(a.finish == 2 ? sr[k] : __fdiv_rn(sr[k], (float)a.m));
      if (v == nullptr) {
        zr.e[k] = mean;
      } else {
        const float zf = to_f(zr.e[k]);
        vr.e[k] = from_f<T>(__fadd_rn(__fmul_rn(a.beta, to_f(vr.e[k])), __fsub_rn(to_f(mean), zf)));
        zr.e[k] = from_f<T>(__fadd_rn(zf, to_f(vr.e[k])));
      }
    }
    if (v != nullptr) vr.store(v + j0);
    zr.store(z_out + j0);
  }
  if (a.rows == 0) return;
  float acc[V];
  for (int i = 0; i < a.rows; ++i) {
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
  store_f32<V>(s + j0, acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rank_kernel(T* __restrict__ x, const T* __restrict__ z, T* __restrict__ v, const float* __restrict__ w,
            float* __restrict__ s, T* __restrict__ z_out, long long n, RankArgs a, int vec) {
  constexpr int V = 16 / sizeof(T);
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;
  long long done = 0;
  if (vec) {
    const long long nv = n / V;
    for (long long c = tid; c < nv; c += step) rank_columns<T, V>(x, z, v, w, s, z_out, n, c * V, a);
    done = nv * V;
  }
  for (long long j = done + tid; j < n; j += step) rank_columns<T, 1>(x, z, v, w, s, z_out, n, j, a);
}

// K8's rank form on columns j0 .. j0+V-1 of the rank's rows, xbar given (f32):
// the squares of K8's probe_columns without its mean.
template <typename T, int V>
__device__ __forceinline__ void probe_rank_columns(const T* x, const float* xbar, long long n, long long j0, int rows,
                                                   double& drift, double& scale) {
  float mu[V];
  load_f32<V>(mu, xbar + j0);
#pragma unroll
  for (int k = 0; k < V; ++k) scale += (double)__fmul_rn(mu[k], mu[k]);
  for (int i = 0; i < rows; ++i) {
    Lanes<T, V> xr;
    xr.load(x + (long long)i * n + j0);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float d = __fsub_rn(to_f(xr.e[k]), mu[k]);
      drift += (double)__fmul_rn(d, d);
    }
  }
}

// K8, rank form: the same grid and column mapping as K8.
template <typename T>
__global__ void __launch_bounds__(kThreads)
probe_rank_kernel(const T* __restrict__ x, const float* __restrict__ xbar, long long n, int rows, int vec, Probe p) {
  constexpr int V = 16 / sizeof(T);
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;
  double drift = 0.0, scale = 0.0;
  long long done = 0;
  if (vec) {
    const long long nv = n / V;
    for (long long c = tid; c < nv; c += step) probe_rank_columns<T, V>(x, xbar, n, c * V, rows, drift, scale);
    done = nv * V;
  }
  for (long long j = done + tid; j < n; j += step) probe_rank_columns<T, 1>(x, xbar, n, j, rows, drift, scale);
  probe_finish(drift, scale, p);
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

template <typename T>
int launch_rank(void* x, const void* z, void* v, const float* w, float* s, void* z_out, long long n,
                const RankArgs& a, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  // rows are n apart: the vector path needs n to keep every row 16-byte aligned
  const int vec = (n % V == 0) && aligned16(x) && aligned16(z) && aligned16(s) && aligned16(z_out) &&
                  aligned16(v);
  rank_kernel<T><<<grid_for<T>(n), kThreads, 0, st>>>(static_cast<T*>(x), static_cast<const T*>(z),
                                                       static_cast<T*>(v), w, s, static_cast<T*>(z_out), n, a, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_probe_rank(const void* x, const float* xbar, int rows, long long n, const Probe& p, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int vec = (n % V == 0) && aligned16(x) && aligned16(xbar);
  probe_rank_kernel<T><<<grid_for<T>(n), kThreads, 0, st>>>(static_cast<const T*>(x), xbar, n, rows, vec, p);
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

// The SMs of the current device (cards of one host are alike: read once).
int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// A block for every `per_block` of `units` work items (the kernels' loops
// stride by the grid, so the cap at 2^31 - 1 blocks keeps any size right).
int tile_grid(long long units, long long per_block) {
  const long long want = (units + per_block - 1) / per_block;
  return (int)(want < 1 ? 1 : (want > 0x7fffffffLL ? 0x7fffffffLL : want));
}

__device__ __forceinline__ float mix1(float oma, float alpha, float x, float z) {
  return __fadd_rn(__fmul_rn(oma, x), __fmul_rn(alpha, z));
}

// K5: x[i, j] <- (1 - a) x[i, j] + a z[i, j] for i < rows, j < width, V
// elements a vector; x's rows ldx apart, z's ldz apart (0: one z row).
template <typename T>
__global__ void __launch_bounds__(kThreads)
mix_kernel(T* __restrict__ x, const T* __restrict__ z, int rows, long long width, long long ldx, long long ldz,
           float oma, float alpha, int vec) {
  constexpr int V = 16 / sizeof(T);
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;
  long long done = 0;
  if (vec) {
    const long long nv = width / V;
    for (long long c = tid; c < nv; c += step) {
      Lanes<T, V> zr;
      zr.load(z + c * V);
      for (int i = 0; i < rows; ++i) {
        if (ldz != 0 && i > 0) zr.load(z + i * ldz + c * V);
        T* xp = x + i * ldx + c * V;
        Lanes<T, V> xr;
        xr.load(xp);
#pragma unroll
        for (int k = 0; k < V; ++k) xr.e[k] = from_f<T>(mix1(oma, alpha, to_f(xr.e[k]), to_f(zr.e[k])));
        xr.store(xp);
      }
    }
    done = nv * V;
  }
  for (long long j = done + tid; j < width; j += step) {
    for (int i = 0; i < rows; ++i) {
      T* xp = x + i * ldx + j;
      *xp = from_f<T>(mix1(oma, alpha, to_f(*xp), to_f(z[i * ldz + j])));
    }
  }
}

template <typename T>
int launch_mix(void* x, const void* z, int rows, long long width, long long ldx, long long ldz, float oma,
               float alpha, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  // every row's start must keep the 16-byte alignment of the first
  const int vec = aligned16(x) && aligned16(z) && (rows == 1 || (ldx % V == 0 && ldz % V == 0));
  mix_kernel<T><<<tile_grid(vec ? width / V : width, kThreads), kThreads, 0, st>>>(
      static_cast<T*>(x), static_cast<const T*>(z), rows, width, ldx, ldz, oma, alpha, vec);
  return (int)cudaGetLastError();
}

// ---- K5, gossip form -------------------------------------------------------

constexpr int kGossipThreads = 256;
constexpr int kGossipRegs = 64;  // values of x' a thread holds: m V <= 64

// The vector width of the register path for T at a bound mmax on m.
template <typename T, int MMAX>
__host__ __device__ constexpr int gossip_vec() {
  constexpr int full = 16 / (int)sizeof(T);
  constexpr int fit = kGossipRegs / MMAX;
  return full < fit ? full : fit;
}

struct GossipArgs {
  const float* wsafe;  // (m,) the consumed push weights, 1 where none arrived
  const float* live;   // (m,) > 0: the row moves
  const float* peff;   // (m, m) row-major
  long long n;
  int m;
  float oma, alpha;
};

// Columns j0 .. j0+V-1 of all m rows: every row's loads first, then the
// debias and pullback row by row (x' kept in the registers x was loaded into,
// written back where the row moves), then the push row by row.
template <typename T, int V, int MMAX>
__device__ __forceinline__ void gossip_columns(T* x, T* mix, long long j0, const GossipArgs& a, const float* sP,
                                               const float* sW, const float* sL) {
  Lanes<T, V> xr[MMAX], mr[MMAX];
#pragma unroll
  for (int k = 0; k < MMAX; ++k) {
    if (k < a.m) {
      xr[k].load(x + (long long)k * a.n + j0);
      mr[k].load(mix + (long long)k * a.n + j0);
    }
  }
#pragma unroll
  for (int k = 0; k < MMAX; ++k) {
    if (k < a.m && sL[k] > 0.f) {
      const float w = sW[k];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float z = to_f(from_f<T>(__fdiv_rn(to_f(mr[k].e[e]), w)));
        xr[k].e[e] = from_f<T>(mix1(a.oma, a.alpha, to_f(xr[k].e[e]), z));
      }
      xr[k].store(x + (long long)k * a.n + j0);
    }
  }
#pragma unroll
  for (int i = 0; i < MMAX; ++i) {
    if (i < a.m) {
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = __fmul_rn(sP[i * MMAX], to_f(xr[0].e[e]));
#pragma unroll
      for (int k = 1; k < MMAX; ++k) {
        if (k < a.m) {
          const float p = sP[i * MMAX + k];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(p, to_f(xr[k].e[e])));
        }
      }
      Lanes<T, V> out;
#pragma unroll
      for (int e = 0; e < V; ++e) out.e[e] = from_f<T>(acc[e]);
      out.store(mix + (long long)i * a.n + j0);
    }
  }
}

// The register path: m <= MMAX <= 16. Peff, wsafe and live go to shared
// memory once a block; vectors of V columns, then a scalar tail.
template <typename T, int MMAX>
__global__ void __launch_bounds__(kGossipThreads)
gossip_kernel(T* __restrict__ x, T* __restrict__ mix, GossipArgs a, int vec) {
  constexpr int V = gossip_vec<T, MMAX>();
  __shared__ float sP[MMAX * MMAX], sW[MMAX], sL[MMAX];
  for (int t = threadIdx.x; t < MMAX * MMAX; t += blockDim.x) {
    const int i = t / MMAX, k = t % MMAX;
    sP[t] = (i < a.m && k < a.m) ? a.peff[i * a.m + k] : 0.f;
  }
  for (int t = threadIdx.x; t < MMAX; t += blockDim.x) {
    sW[t] = t < a.m ? a.wsafe[t] : 1.f;
    sL[t] = t < a.m ? a.live[t] : 0.f;
  }
  __syncthreads();
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long nv = a.n / V;
    for (long long c = tid; c < nv; c += step) gossip_columns<T, V, MMAX>(x, mix, c * V, a, sP, sW, sL);
    done = nv * V;
  }
  for (long long j = done + tid; j < a.n; j += step) gossip_columns<T, 1, MMAX>(x, mix, j, a, sP, sW, sL);
}

// Any m: one column a thread. Pass 1 debiases and pulls back row by row,
// writing x' into x; pass 2 pushes row by row, reading x' back from x and
// Peff through the read-only cache (every thread of a warp reads the same
// element).
template <typename T>
__global__ void __launch_bounds__(kGossipThreads)
gossip_column_kernel(T* __restrict__ x, T* __restrict__ mix, GossipArgs a) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = tid; j < a.n; j += step) {
    for (int k = 0; k < a.m; ++k) {
      if (__ldg(a.live + k) > 0.f) {
        T* px = x + (long long)k * a.n + j;
        const float z = to_f(from_f<T>(__fdiv_rn(to_f(mix[(long long)k * a.n + j]), __ldg(a.wsafe + k))));
        *px = from_f<T>(mix1(a.oma, a.alpha, to_f(*px), z));
      }
    }
    for (int i = 0; i < a.m; ++i) {
      const float* prow = a.peff + (long long)i * a.m;
      float acc = 0.f;
      for (int k = 0; k < a.m; ++k) {
        const float prod = __fmul_rn(__ldg(prow + k), to_f(x[(long long)k * a.n + j]));
        acc = k == 0 ? prod : __fadd_rn(acc, prod);
      }
      mix[(long long)i * a.n + j] = from_f<T>(acc);
    }
  }
}

template <typename T, int MMAX>
int launch_gossip_regs(T* x, T* mix, const GossipArgs& a, cudaStream_t st) {
  constexpr int V = gossip_vec<T, MMAX>();
  // rows are n apart: the vector path needs n to keep every row aligned to V
  // and enough columns: a plane of fewer vectors than one wave of full
  // blocks takes the scalar path, a column a thread, which spreads the push
  // over V times more threads (the classifier's 17,408 columns)
  const uintptr_t mask = (uintptr_t)(V * sizeof(T)) - 1;
  const int use_vec = (a.n % V == 0) && a.n / V >= (long long)num_sms() * kGossipThreads &&
                      !(reinterpret_cast<uintptr_t>(x) & mask) && !(reinterpret_cast<uintptr_t>(mix) & mask);
  const long long units = use_vec ? a.n / V : a.n;
  // small planes: narrower blocks, so that the columns reach every SM
  int threads = kGossipThreads;
  while (threads > 32 && (units + threads - 1) / threads < num_sms()) threads /= 2;
  gossip_kernel<T, MMAX><<<tile_grid(units, threads), threads, 0, st>>>(x, mix, a, use_vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gossip(void* xv, void* mixv, const GossipArgs& a, cudaStream_t st) {
  T* x = static_cast<T*>(xv);
  T* mix = static_cast<T*>(mixv);
  if (a.m <= 4) return launch_gossip_regs<T, 4>(x, mix, a, st);
  if (a.m <= 16) return launch_gossip_regs<T, 16>(x, mix, a, st);
  gossip_column_kernel<T><<<tile_grid(a.n, kGossipThreads), kGossipThreads, 0, st>>>(x, mix, a);
  return (int)cudaGetLastError();
}


// ---- K5, gossip rank form ---------------------------------------------------

struct GossipRankArgs {
  const float* wsafe;  // (r,) the consumed push weights of the rank's rows
  const float* live;   // (r,) > 0: the row moves
  const float* peff;   // (m, m) row-major, the launch-time Peff
  const int* held;     // (2, h): source code, global index
  long long n;
  int r, h, m, lo, own_at, mode;  // own_at: the first own row's place among the held rows
  float oma, alpha;
};

// The register path: h <= HMAX. Columns j0 .. j0+V-1 of every held row are
// loaded first; each own row's mix from them, then its pullback and copy.
template <typename T, int V, int HMAX>
__device__ __forceinline__ void gossip_rank_columns(T* x, T* own, const T* recv, T* out, long long j0,
                                                    const GossipRankArgs& a, const float* sP, const int* sC) {
  Lanes<T, V> hr[HMAX];
#pragma unroll
  for (int k = 0; k < HMAX; ++k) {
    if (k < a.h) {
      const int c = sC[k];
      hr[k].load((c >= 0 ? recv + (long long)c * a.n : own + (long long)(-1 - c) * a.n) + j0);
    }
  }
#pragma unroll
  for (int i = 0; i < HMAX; ++i) {
    if (i < a.r) {
      Lanes<T, V> mix;
      if (a.mode == 1) {
#pragma unroll
        for (int k = 0; k < HMAX; ++k)
          if (k == a.own_at + i) mix = hr[k];
      } else {
        float acc[V];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = __fmul_rn(sP[i * HMAX], to_f(hr[0].e[e]));
#pragma unroll
        for (int k = 1; k < HMAX; ++k) {
          if (k < a.h) {
            const float p = sP[i * HMAX + k];
#pragma unroll
            for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(p, to_f(hr[k].e[e])));
          }
        }
#pragma unroll
        for (int e = 0; e < V; ++e) mix.e[e] = from_f<T>(acc[e]);
      }
      if (a.mode == 2) {
        mix.store(out + (long long)i * a.n + j0);
        continue;
      }
      T* px = x + (long long)i * a.n + j0;
      Lanes<T, V> xr;
      xr.load(px);
      if (a.live[i] > 0.f) {
        const float w = a.wsafe[i];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float z = to_f(from_f<T>(__fdiv_rn(to_f(mix.e[e]), w)));
          xr.e[e] = from_f<T>(mix1(a.oma, a.alpha, to_f(xr.e[e]), z));
        }
        xr.store(px);
      }
      xr.store(own + (long long)i * a.n + j0);
    }
  }
}

template <typename T, int HMAX>
__global__ void __launch_bounds__(kGossipThreads)
gossip_rank_kernel(T* __restrict__ x, T* own, const T* __restrict__ recv, T* out, GossipRankArgs a, int vec) {
  constexpr int V = gossip_vec<T, HMAX>();
  __shared__ float sP[HMAX * HMAX];
  __shared__ int sC[HMAX];
  for (int t = threadIdx.x; t < HMAX * HMAX; t += blockDim.x) {
    const int i = t / HMAX, k = t % HMAX;
    sP[t] = (i < a.r && k < a.h) ? a.peff[(long long)(a.lo + i) * a.m + a.held[a.h + k]] : 0.f;
  }
  for (int t = threadIdx.x; t < HMAX; t += blockDim.x) sC[t] = t < a.h ? a.held[t] : 0;
  __syncthreads();
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long nv = a.n / V;
    for (long long c = tid; c < nv; c += step) gossip_rank_columns<T, V, HMAX>(x, own, recv, out, c * V, a, sP, sC);
    done = nv * V;
  }
  for (long long j = done + tid; j < a.n; j += step) gossip_rank_columns<T, 1, HMAX>(x, own, recv, out, j, a, sP, sC);
}

// Any h: a column a thread, the held rows read from memory. Modes 0 and 1
// pull every row back first and then copy the rows into own, so that no
// row's mix reads a rewritten own row; mode 2 writes out, which is not own.
template <typename T>
__global__ void __launch_bounds__(kGossipThreads)
gossip_rank_column_kernel(T* __restrict__ x, T* own, const T* __restrict__ recv, T* out, GossipRankArgs a) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = tid; j < a.n; j += step) {
    for (int i = 0; i < a.r; ++i) {
      float mix;
      if (a.mode == 1) {
        mix = to_f(own[(long long)i * a.n + j]);
      } else {
        const float* prow = a.peff + (long long)(a.lo + i) * a.m;
        float acc = 0.f;
        for (int k = 0; k < a.h; ++k) {
          const int c = __ldg(a.held + k);
          const T v = c >= 0 ? recv[(long long)c * a.n + j] : own[(long long)(-1 - c) * a.n + j];
          const float prod = __fmul_rn(__ldg(prow + __ldg(a.held + a.h + k)), to_f(v));
          acc = k == 0 ? prod : __fadd_rn(acc, prod);
        }
        mix = to_f(from_f<T>(acc));
      }
      if (a.mode == 2) {
        out[(long long)i * a.n + j] = from_f<T>(mix);
      } else if (__ldg(a.live + i) > 0.f) {
        T* px = x + (long long)i * a.n + j;
        const float z = to_f(from_f<T>(__fdiv_rn(mix, __ldg(a.wsafe + i))));
        *px = from_f<T>(mix1(a.oma, a.alpha, to_f(*px), z));
      }
    }
    if (a.mode != 2)
      for (int i = 0; i < a.r; ++i) own[(long long)i * a.n + j] = x[(long long)i * a.n + j];
  }
}

template <typename T, int HMAX>
int launch_gossip_rank_regs(T* x, T* own, const T* recv, T* out, const GossipRankArgs& a, cudaStream_t st) {
  constexpr int V = gossip_vec<T, HMAX>();
  const uintptr_t mask = (uintptr_t)(V * sizeof(T)) - 1;
  const int use_vec = (a.n % V == 0) && !(reinterpret_cast<uintptr_t>(x) & mask) &&
                      !(reinterpret_cast<uintptr_t>(own) & mask) && !(reinterpret_cast<uintptr_t>(recv) & mask) &&
                      !(reinterpret_cast<uintptr_t>(out) & mask);
  const long long units = use_vec ? a.n / V : a.n;
  int threads = kGossipThreads;
  while (threads > 32 && (units + threads - 1) / threads < num_sms()) threads /= 2;
  gossip_rank_kernel<T, HMAX><<<tile_grid(units, threads), threads, 0, st>>>(x, own, recv, out, a, use_vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gossip_rank(void* xv, void* ownv, const void* recvv, void* outv, const GossipRankArgs& a, cudaStream_t st) {
  T* x = static_cast<T*>(xv);
  T* own = static_cast<T*>(ownv);
  const T* recv = static_cast<const T*>(recvv);
  T* out = static_cast<T*>(outv);
  if (a.h <= 4) return launch_gossip_rank_regs<T, 4>(x, own, recv, out, a, st);
  if (a.h <= 16) return launch_gossip_rank_regs<T, 16>(x, own, recv, out, a, st);
  gossip_rank_column_kernel<T><<<tile_grid(a.n, kGossipThreads), kGossipThreads, 0, st>>>(x, own, recv, out, a);
  return (int)cudaGetLastError();
}

}  // namespace

// K5. x: rows of width elements, ldx apart, updated in place; z: rows of
// width elements ldz apart (ldz 0: one row for all of x's). The same-shape
// launch is rows 1, width n. dtype: 0 = float32, 1 = bfloat16 (x and z).
extern "C" int anchor_mix_launch(void* x, const void* z, int rows, long long width, long long ldx, long long ldz,
                                 float oma, float alpha, int dtype, void* stream) {
  if (rows <= 0 || width <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_mix<float>(x, z, rows, width, ldx, ldz, oma, alpha, st);
  if (dtype == 1) return launch_mix<__nv_bfloat16>(x, z, rows, width, ldx, ldz, oma, alpha, st);
  return (int)cudaErrorInvalidValue;
}

// K5, gossip form. x, mix: (m, n) updated in place; wsafe, live: (m,)
// float32; peff: (m, m) float32, row-major. dtype: 0 = float32,
// 1 = bfloat16 (x, mix).
extern "C" int gossip_boundary_launch(void* x, void* mix, const void* wsafe, const void* live, const void* peff,
                                      int m, long long n, float oma, float alpha, int dtype, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const GossipArgs a{static_cast<const float*>(wsafe), static_cast<const float*>(live),
                     static_cast<const float*>(peff), n, m, oma, alpha};
  if (dtype == 0) return launch_gossip<float>(x, mix, a, st);
  if (dtype == 1) return launch_gossip<__nv_bfloat16>(x, mix, a, st);
  return (int)cudaErrorInvalidValue;
}

// K5, gossip rank form. x: (r, n) this rank's rows, updated in place (modes 0
// and 1); own: (r, n) their launch-time copy, read, then overwritten with x
// (modes 0 and 1); recv: (hr, n) the received rows (may be null when none);
// out: (r, n) the mix (mode 2; may be own when h <= 16); held: (2, h) int32 on
// the device; peff: (m, m), wsafe, live: (r,) float32. lo: the rank's first
// global row; own_at: its place among the held rows. dtype: 0 = float32,
// 1 = bfloat16 (x, own, recv, out).
extern "C" int gossip_rank_launch(void* x, void* own, const void* recv, void* out, const void* held,
                                  const void* peff, const void* wsafe, const void* live, int r, int h, int m, int lo,
                                  int own_at, long long n, float oma, float alpha, int mode, int dtype, void* stream) {
  if (n <= 0 || r <= 0) return 0;
  if (h < r || mode < 0 || mode > 2 || lo < 0 || lo + r > m) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const GossipRankArgs a{static_cast<const float*>(wsafe), static_cast<const float*>(live),
                         static_cast<const float*>(peff), static_cast<const int*>(held), n, r, h, m, lo, own_at, mode,
                         oma, alpha};
  if (dtype == 0) return launch_gossip_rank<float>(x, own, recv, out, a, st);
  if (dtype == 1) return launch_gossip_rank<__nv_bfloat16>(x, own, recv, out, a, st);
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

// K3/K4, rank form. x: (rows, n), this rank's rows, updated in place (rows 0:
// the drain); z: (n,) the anchor (finish: z_k, the momentum's base; else the
// final anchor); v: (n,) updated in place, or null (K4); w: (rows,) float32,
// the rows' membership weights, or null (unmasked); s: (n,) float32, read
// when finish (S_k), overwritten with the rows' partial sum (of the
// pre-pullback rows when mean_pre) when rows > 0; z_out: (n,) z_{k+1},
// written when finish. m: the worker count over all ranks. finish: 0 none,
// 1 mean = S / m, 2 mean = S (a weighted sum). dtype: 0 = float32,
// 1 = bfloat16 (x, z, v, z_out).
extern "C" int pullback_rank_launch(void* x, const void* z, void* v, const void* w, void* s, void* z_out, int rows,
                                    long long n, int m, float oma, float alpha, float beta, int finish, int mean_pre,
                                    int dtype, void* stream) {
  if (n <= 0 || rows < 0 || m <= 0 || finish < 0 || finish > 2) return n <= 0 ? 0 : (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const RankArgs a{oma, alpha, beta, rows, m, finish, mean_pre};
  float* sf = static_cast<float*>(s);
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0) return launch_rank<float>(x, z, v, wf, sf, z_out, n, a, st);
  if (dtype == 1) return launch_rank<__nv_bfloat16>(x, z, v, wf, sf, z_out, n, a, st);
  return (int)cudaErrorInvalidValue;
}

// K8, rank form. x: (rows, n) read; xbar: (n,) float32, the global column
// mean; stats: (2,) float64 written, [drift_sq over the rows, scale_sq]; ws
// and counter as for K4. dtype: 0 = float32, 1 = bfloat16 (x).
extern "C" int consensus_probe_rank_launch(const void* x, int rows, long long n, const void* xbar, void* stats,
                                           void* ws, void* counter, int dtype, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (n <= 0 || rows <= 0) return (int)cudaMemsetAsync(stats, 0, 2 * sizeof(double), st);
  Probe p = probe_args(nullptr, ws, counter);
  p.out64 = static_cast<double*>(stats);
  const float* xb = static_cast<const float*>(xbar);
  if (dtype == 0) return launch_probe_rank<float>(x, xb, rows, n, p, st);
  if (dtype == 1) return launch_probe_rank<__nv_bfloat16>(x, xb, rows, n, p, st);
  return (int)cudaErrorInvalidValue;
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
