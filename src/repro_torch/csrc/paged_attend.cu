// Paged decode attention: one new token per slot attends over its page table
// with an online softmax, grouped-query (G query heads share a KV head).
//
// Replaces the Pallas TPU kernel
// repro/kernels/paged_attn/kernel.py::paged_attend_decode (_attend_kernel).
// Same function: q (S, KV, G, D) pre-scaled, pools (P, page, KV, D), the
// query of slot s sits at position lengths[s] (its K/V already appended) and
// sees key positions k with k <= lengths[s] and, with a window w > 0,
// k > lengths[s] - w. Scores, softmax statistics and the accumulator are
// float32; the output is divided by max(l, 1e-30) and rounded once to q's
// type. The TPU padding of G to 8 and D to 128 (paged_attn/ops.py) is not
// carried over: G = 7 and D = 128 are handled as they are.
//
// What bounds it on the H100: bytes. Each (slot, kv head) reads its visible
// keys and values once (2 * len * D elements) and does 4 * G * D flops per
// key, about 7 flops per byte in bf16 for qwen2-7b, far below the ~295 at
// which the tensor cores would bind. At serving sizes (4 slots, <= 512
// positions) one call reads about a megabyte, so latency and the serial
// chain of the online softmax dominate.
//
// Design: one block of eight warps (four for D = 256) per (slot, kv head),
// sized so the merge buffer fits static shared memory. The block loads its
// slot's length and page-table entries itself (this replaces scalar
// prefetch) and walks only the visible positions, not all maxp pages. The
// G query rows sit in shared memory as float32. Each warp takes tiles of 32
// consecutive positions (tiles interleaved across the warps): lane j scores
// position j of the tile against all G rows from its own K row, the tile's
// max and sum come from a fixed butterfly of shuffles, and then every lane
// accumulates its D/32 columns of p @ V over the tile's positions, each V row
// read by the whole warp at once, eight rows' loads in flight together. The
// online softmax therefore rescales once per tile of 32 positions (the
// Pallas body rescales once per page). The warps' (m, l, acc) partials are
// merged in shared memory in warp order, with
// the safe-max rule of the Pallas body for empty partials, so the result is
// deterministic.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGMax = 8;
// warps per block: 8 while the merge buffer (warps x G x D floats) stays
// within static shared memory, else 4
__host__ __device__ constexpr int warps_for(int vpl) { return vpl <= 4 ? 8 : 4; }
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// N consecutive elements at p (aligned to N * sizeof(T)) as float32.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* __restrict__ p, float* out) {
  constexpr int B = N * (int)sizeof(T);
  if constexpr (B % 16 == 0) {
    constexpr int per = 16 / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < B / 16; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < per; ++i) out[c * per + i] = to_f(e[i]);
    }
  } else if constexpr (B == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
  } else if constexpr (B == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(p[i]);
  }
}

template <typename T, int VPL>
__global__ void __launch_bounds__(warps_for(VPL) * 32)
paged_attend_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v, const int* __restrict__ pt,
                    const int* __restrict__ lengths, T* __restrict__ out, int KV, int G, int maxp,
                    int page, int num_pages, int window) {
  constexpr int D = VPL * 32;
  constexpr int kWarps = warps_for(VPL);
  constexpr int kBatch = 8;  // V rows loaded together in p @ V
  __shared__ __align__(16) float sq[kGMax][D];
  __shared__ float sm_m[kWarps][kGMax];
  __shared__ float sm_l[kWarps][kGMax];
  __shared__ float sm_acc[kWarps][kGMax][D];

  const int s = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = lengths[s];
  const int hi = min(len, maxp * page - 1);
  const int lo = window > 0 ? max(0, len - window + 1) : 0;

  const T* qb = q + (size_t)(s * KV + h) * G * D;
  for (int idx = threadIdx.x; idx < G * D; idx += kWarps * 32) sq[idx / D][idx % D] = to_f(qb[idx]);
  __syncthreads();

  float m[kGMax], l[kGMax], acc[kGMax][VPL];
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) acc[g][i] = 0.f;
  }

  for (int base = lo + warp * 32; base <= hi; base += kWarps * 32) {
    // lane j owns position base + j: its element offset in the pools, or -1
    const int pos = base + lane;
    long long row = -1;
    if (pos <= hi) {
      const int pid = pt[(size_t)s * maxp + pos / page];
      if (pid >= 0 && pid < num_pages)  // never otherwise from the engine; keeps reads in bounds
        row = (((long long)pid * page + pos % page) * KV + h) * D;
    }
    float sc[kGMax];
#pragma unroll
    for (int g = 0; g < kGMax; ++g) sc[g] = 0.f;
    if (row >= 0) {
      const T* kr = pool_k + row;
#pragma unroll 2
      for (int d0 = 0; d0 < D; d0 += 32) {  // 32 elements of the K row in flight
        float kf[32];
        load_f<T, 32>(kr + d0, kf);
#pragma unroll
        for (int g = 0; g < kGMax; ++g) {
          if (g < G) {
#pragma unroll
            for (int i = 0; i < 32; ++i) sc[g] += sq[g][d0 + i] * kf[i];
          }
        }
      }
    }
    // online softmax over the tile: one rescale per 32 positions
#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      if (g < G) {
        const float sg = row >= 0 ? sc[g] : -INFINITY;
        const float mn = fmaxf(m[g], warp_max(sg));
        const float safe = mn == -INFINITY ? 0.f : mn;
        const float corr = expf(m[g] - safe);  // 0 while nothing was visible
        const float p = row >= 0 ? expf(sg - safe) : 0.f;
        l[g] = l[g] * corr + warp_sum(p);
#pragma unroll
        for (int i = 0; i < VPL; ++i) acc[g][i] *= corr;
        m[g] = mn;
        sc[g] = p;
      }
    }
    // p @ V: the warp reads V rows kBatch at a time (all loads issued before
    // any is used), each lane its D/32 columns; positions past the tile's
    // end have row -1 and p = 0
    const int cnt = min(32, hi - base + 1);
    for (int j0 = 0; j0 < cnt; j0 += kBatch) {
      float vf[kBatch][VPL];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long rj = __shfl_sync(kFull, row, j0 + u);
        if (rj >= 0) {
          load_f<T, VPL>(pool_v + rj + lane * VPL, vf[u]);
        } else {
#pragma unroll
          for (int i = 0; i < VPL; ++i) vf[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int g = 0; g < kGMax; ++g) {
          if (g < G) {
            const float pj = __shfl_sync(kFull, sc[g], j0 + u);
#pragma unroll
            for (int i = 0; i < VPL; ++i) acc[g][i] += pj * vf[u][i];
          }
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    if (g < G) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < VPL; ++i) sm_acc[warp][g][lane * VPL + i] = acc[g][i];
    }
  }
  __syncthreads();

  T* ob = out + (size_t)(s * KV + h) * G * D;
  for (int idx = threadIdx.x; idx < G * D; idx += kWarps * 32) {
    const int g = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    const float safe = mx == -INFINITY ? 0.f : mx;
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][g] - safe);
      L += sm_l[w][g] * f;
      A += sm_acc[w][g][d] * f;
    }
    ob[g * D + d] = from_f<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* pk, const void* pv, const int* pt, const int* ln, void* out,
           int S, int KV, int G, int D, int maxp, int page, int num_pages, int window,
           cudaStream_t st) {
  dim3 grid(S, KV);
  constexpr int w1 = warps_for(1), w2 = warps_for(2), w4 = warps_for(4), w8 = warps_for(8);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(pk);
  const T* vv = static_cast<const T*>(pv);
  T* oo = static_cast<T*>(out);
  switch (D) {
    case 32:
      paged_attend_kernel<T, 1><<<grid, w1 * 32, 0, st>>>(qq, kk, vv, pt, ln, oo, KV, G, maxp, page, num_pages, window);
      break;
    case 64:
      paged_attend_kernel<T, 2><<<grid, w2 * 32, 0, st>>>(qq, kk, vv, pt, ln, oo, KV, G, maxp, page, num_pages, window);
      break;
    case 128:
      paged_attend_kernel<T, 4><<<grid, w4 * 32, 0, st>>>(qq, kk, vv, pt, ln, oo, KV, G, maxp, page, num_pages, window);
      break;
    case 256:
      paged_attend_kernel<T, 8><<<grid, w8 * 32, 0, st>>>(qq, kk, vv, pt, ln, oo, KV, G, maxp, page, num_pages, window);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (S, KV, G, D); pool_k, pool_v: (num_pages, page, KV, D), all contiguous,
// 16-byte aligned and of one element type (dtype 0 = float32, 1 = bfloat16);
// page_tables (S, maxp) and lengths (S,) int32. window <= 0 means no window.
// Requires G <= 8 and D in {32, 64, 128, 256}.
extern "C" int paged_attend_launch(const void* q, const void* pool_k, const void* pool_v,
                                   const void* page_tables, const void* lengths, void* out, int S,
                                   int KV, int G, int D, int maxp, int page, int num_pages,
                                   int window, int dtype, void* stream) {
  if (S <= 0) return 0;
  if (G < 1 || G > kGMax || KV < 1 || KV > 65535 || maxp <= 0 || page <= 0)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)pool_k | (uintptr_t)pool_v) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_tables);
  const int* ln = static_cast<const int*>(lengths);
  if (dtype == 0)
    return launch<float>(q, pool_k, pool_v, pt, ln, out, S, KV, G, D, maxp, page, num_pages, window, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, pool_k, pool_v, pt, ln, out, S, KV, G, D, maxp, page, num_pages, window, st);
  return (int)cudaErrorInvalidValue;
}
