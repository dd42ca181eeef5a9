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
// carried over: any G <= 16 and D in {32, 64, 80, 128, 256} are handled as
// they are.
//
// What bounds it on the H100: bytes, and below them latency. Each (slot, kv
// head) reads its visible keys and values once (2 * len * D elements) and
// does 4 * G * D flops per key, about 7 flops per byte in bf16 for qwen2-7b,
// far below the ~295 at which the tensor cores would bind. At serving sizes
// (4 slots, <= 512 positions) one call reads about a megabyte: what costs is
// the number of CTAs in flight and each one's serial chain.
//
// Design (flash-decoding): the grid is (slot, kv head, split). A split covers
// `span` positions, whole pages, chosen by the wrapper from the host-known
// shapes (kernels/paged_attn/ops.py::decode_splits: about one wave of the
// 132 SMs, 128 CTAs at the serving shape where the old grid had 16), never
// from the lengths, so the bits of the result depend on the shapes only.
// Each CTA writes the f32 (m, l, acc) of its positions to a workspace; a
// split that lies wholly past the slot's length or before its window writes
// nothing. The merge runs in the same launch: each CTA then takes a ticket
// from an integer counter of its (slot, kv head), and the CTA that draws the
// last one merges the partials of every non-empty split, always in split
// order, with the safe-max rule of the Pallas body for empty ones, writes
// the output and resets the counter. Which CTA merges may vary between runs;
// the merge order and its bits do not. No float atomics.
//
// bf16 (tensor cores): a CTA of four warps stages 64 positions at a time
// from the split's first (K and V rows with 16-byte cp.async, zero-filled
// outside the visible positions, two stages; the first tile's page ids are
// loaded beside the slot's length, and the query rows come in the first
// tile's copy), and each warp takes 16 of them. The G query rows, padded to 16,
// are the A operand of mma.sync.m16n8k16 (Q.K^T: q and K are bf16, so the
// products are exact, summed in f32); the warp's online softmax rescales
// once per 16 positions; P.V splits the f32 p into a bf16 high part and a
// bf16 low part and issues both products (p - hi - lo is below 2^-16 p), so
// the result stays within one bf16 rounding of the f32 plain value. The
// four warps' partials are merged in warp order in dynamic shared memory
// (above 48 KB at D 256, so every D keeps four warps and every G one tile).
//
// f32 (CUDA cores): each warp takes tiles of 32 positions of the split
// (interleaved across the warps); lane j scores position j against all G
// rows from its own K row (32 columns at a time, then a 16-column tail where
// D is not a multiple of 32), the tile's max and sum come from a fixed
// butterfly of shuffles, and every lane accumulates its ceil(D/32) columns
// of p @ V over the tile, eight V rows' loads in flight together. The
// warps' partials are merged in warp order in static shared memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroupMax = 16;
constexpr int kStaticSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// the split: positions [a, b] of a slot (empty when a > b)

struct Span {
  int a, b;
};

__device__ __forceinline__ Span split_span(int len, int maxp, int page, int window, int split, int span) {
  const int hi = min(len, maxp * page - 1);
  const int lo = window > 0 ? max(0, len - window + 1) : 0;
  return {max(lo, split * span), min(hi, split * span + span - 1)};
}

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

// A split's partial in the workspace: G x D floats acc, then G floats m and
// G floats l, the whole rounded up to 16 bytes.
__host__ __device__ constexpr int part_stride(int G, int D) { return (G * (D + 2) + 3) / 4 * 4; }

// The CTA's partial of one split, from its warps' (m, l, acc) in shared
// memory (m[w * rows + g], acc[(w * rows + g) * D + d]), merged in warp
// order, to the workspace.
template <int kWarps, int kRows>
__device__ __forceinline__ void write_partial(const float* sm_m, const float* sm_l, const float* sm_acc,
                                              float* __restrict__ part, int G, int D) {
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * kRows + g]);
    const float safe = mx == -INFINITY ? 0.f : mx;
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w * kRows + g] - safe);
      L += sm_l[w * kRows + g] * f;
      A += sm_acc[(w * kRows + g) * D + d] * f;
    }
    part[idx] = A;
    if (d == 0) {
      part[G * D + g] = mx;
      part[G * D + G + g] = L;
    }
  }
}

// Every CTA of a (slot, kv head) takes a ticket once its partial is written;
// the one that draws the last merges the non-empty splits in split order,
// writes the output in T and resets the counter for the next launch. A
// thread takes four columns of a row at a time and loads eight splits'
// (m, l, acc) together, merging batch after batch online (the merge is a
// chain of L2 round trips otherwise).
template <typename T>
__device__ __forceinline__ void finish_splits(const float* __restrict__ ws, int* __restrict__ counters,
                                              T* __restrict__ out, int len, int s, int h, int KV, int G, int D,
                                              int maxp, int page, int window, int nsplit, int span) {
  constexpr int kBatch = 8;
  __shared__ int last;
  __threadfence();  // this CTA's partial is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counters + s * KV + h, 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int stride = part_stride(G, D), D4 = D / 4;
  const float* base = ws + (size_t)(s * KV + h) * nsplit * stride;
  T* ob = out + (size_t)(s * KV + h) * G * D;
  for (int idx = threadIdx.x; idx < G * D4; idx += blockDim.x) {
    const int g = idx / D4, d = (idx % D4) * 4;
    float mx = -INFINITY, L = 0.f, A[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < nsplit; s0 += kBatch) {
      float mv[kBatch], lv[kBatch];
      float4 av[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const Span r = split_span(len, maxp, page, window, s0 + u, span);
        mv[u] = -INFINITY;  // an empty split: m = -inf, l = 0, acc = 0
        lv[u] = 0.f;
        av[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (s0 + u < nsplit && r.a <= r.b) {
          const float* part = base + (s0 + u) * stride;
          mv[u] = __ldcg(part + G * D + g);
          lv[u] = __ldcg(part + G * D + G + g);
          av[u] = __ldcg(reinterpret_cast<const float4*>(part + g * D + d));
        }
      }
      float bm = mx;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) bm = fmaxf(bm, mv[u]);
      const float safe = bm == -INFINITY ? 0.f : bm;
      const float corr = expf(mx - safe);  // 0 while nothing was merged
      L *= corr;
#pragma unroll
      for (int i = 0; i < 4; ++i) A[i] *= corr;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {  // in split order
        const float f = expf(mv[u] - safe);
        L += lv[u] * f;
        A[0] += av[u].x * f;
        A[1] += av[u].y * f;
        A[2] += av[u].z * f;
        A[3] += av[u].w * f;
      }
      mx = bm;
    }
    const float inv = fmaxf(L, 1e-30f);
#pragma unroll
    for (int i = 0; i < 4; ++i) ob[g * D + d + i] = from_f<T>(A[i] / inv);
  }
  if (threadIdx.x == 0) counters[s * KV + h] = 0;
}

// ---------------------------------------------------------------------------
// f32 route: the CUDA cores

// group capacity GM of 8 or 16 (G <= GM): the registers acc[GM][VPL] and the
// shared merge buffer grow with GM, so groups of at most 8 keep the smaller
// instance
__host__ __device__ constexpr int smem_bytes(int gm, int d, int warps) {
  return 4 * (gm * d + 2 * warps * gm + warps * gm * d);
}
// warps per block: the most of 8, 4, 2, 1 whose buffers fit static shared memory
__host__ __device__ constexpr int warps_for(int d, int gm) {
  return smem_bytes(gm, d, 8) <= kStaticSmem ? 8
         : smem_bytes(gm, d, 4) <= kStaticSmem ? 4
         : smem_bytes(gm, d, 2) <= kStaticSmem ? 2 : 1;
}
static_assert(smem_bytes(16, 256, warps_for(256, 16)) <= kStaticSmem, "G 16, D 256 fits static shared memory");

template <int D, int kGMax>
__global__ void __launch_bounds__(warps_for(D, kGMax) * 32)
paged_attend_f32_kernel(const float* __restrict__ q, const float* __restrict__ pool_k,
                        const float* __restrict__ pool_v, const int* __restrict__ pt,
                        const int* __restrict__ lengths, float* __restrict__ out, float* __restrict__ ws,
                        int* __restrict__ counters, int KV, int G, int maxp, int page, int num_pages, int window,
                        int nsplit, int span) {
  static_assert(D % 16 == 0, "the Q.K loop steps 32 columns, then a 16-column tail");
  constexpr int VPL = (D + 31) / 32;  // columns a lane owns in p @ V; the last lanes own fewer where D % 32 != 0
  constexpr int kWarps = warps_for(D, kGMax);
  constexpr int kBatch = 8;  // V rows loaded together in p @ V
  __shared__ __align__(16) float sq[kGMax][D];
  __shared__ float sm_m[kWarps][kGMax];
  __shared__ float sm_l[kWarps][kGMax];
  __shared__ float sm_acc[kWarps][kGMax][D];

  const int s = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = lengths[s];
  const Span r = split_span(len, maxp, page, window, sp, span);
  if (r.a <= r.b) {
    const float* qb = q + (size_t)(s * KV + h) * G * D;
    for (int idx = threadIdx.x; idx < G * D; idx += kWarps * 32) sq[idx / D][idx % D] = qb[idx];
    __syncthreads();

    float m[kGMax], l[kGMax], acc[kGMax][VPL];
#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) acc[g][i] = 0.f;
    }

    for (int base = r.a + warp * 32; base <= r.b; base += kWarps * 32) {
      // lane j owns position base + j: its element offset in the pools, or -1
      const int pos = base + lane;
      long long row = -1;
      if (pos <= r.b) {
        const int pid = pt[(size_t)s * maxp + pos / page];
        if (pid >= 0 && pid < num_pages)  // never otherwise from the engine; keeps reads in bounds
          row = (((long long)pid * page + pos % page) * KV + h) * D;
      }
      float sc[kGMax];
#pragma unroll
      for (int g = 0; g < kGMax; ++g) sc[g] = 0.f;
      if (row >= 0) {
        const float* kr = pool_k + row;
#pragma unroll 2
        for (int d0 = 0; d0 + 32 <= D; d0 += 32) {  // 32 elements of the K row in flight
          float kf[32];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const float4 v = reinterpret_cast<const float4*>(kr + d0)[c];
            kf[4 * c] = v.x, kf[4 * c + 1] = v.y, kf[4 * c + 2] = v.z, kf[4 * c + 3] = v.w;
          }
#pragma unroll
          for (int g = 0; g < kGMax; ++g) {
            if (g < G) {
#pragma unroll
              for (int i = 0; i < 32; ++i) sc[g] += sq[g][d0 + i] * kf[i];
            }
          }
        }
        if constexpr (D % 32 != 0) {  // the last 16 columns, in the same order
          constexpr int d0 = D - 16;
          float kf[16];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float4 v = reinterpret_cast<const float4*>(kr + d0)[c];
            kf[4 * c] = v.x, kf[4 * c + 1] = v.y, kf[4 * c + 2] = v.z, kf[4 * c + 3] = v.w;
          }
#pragma unroll
          for (int g = 0; g < kGMax; ++g) {
            if (g < G) {
#pragma unroll
              for (int i = 0; i < 16; ++i) sc[g] += sq[g][d0 + i] * kf[i];
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
      const int cnt = min(32, r.b - base + 1);
      for (int j0 = 0; j0 < cnt; j0 += kBatch) {
        float vf[kBatch][VPL];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const long long rj = __shfl_sync(kFull, row, j0 + u);
#pragma unroll
          for (int i = 0; i < VPL; ++i)  // a lane's columns past D read as zero
            vf[u][i] = rj >= 0 && lane * VPL + i < D ? pool_v[rj + lane * VPL + i] : 0.f;
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
        for (int i = 0; i < VPL; ++i)
          if (lane * VPL + i < D) sm_acc[warp][g][lane * VPL + i] = acc[g][i];
      }
    }
    __syncthreads();
    float* part = ws + ((size_t)(s * KV + h) * nsplit + sp) * part_stride(G, D);
    write_partial<kWarps, kGMax>(&sm_m[0][0], &sm_l[0][0], &sm_acc[0][0][0], part, G, D);
  }
  finish_splits<float>(ws, counters, out, len, s, h, KV, G, D, maxp, page, window, nsplit, span);
}

// ---------------------------------------------------------------------------
// bf16 route: the tensor cores

constexpr int kTile = 64;   // positions a CTA stages at a time, 16 a warp
constexpr int kTcWarps = 4;

__host__ __device__ constexpr int tc_ld(int d) { return d + 8; }  // a padded row: conflict-free ldmatrix
__host__ __device__ constexpr int tc_smem_bytes(int d) {
  // Q (16 rows), K and V (two stages of kTile rows each) in bf16, the rows'
  // valid flags, then the warps' f32 (m, l) and accumulators
  return 2 * (16 + 4 * kTile) * tc_ld(d) + 4 * 2 * kTile + 4 * (2 * kTcWarps * 16 + kTcWarps * 16 * d);
}
static_assert(tc_smem_bytes(256) <= 232448, "D 256 fits one CTA's shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values as a bf16 pair (hi) and the pair of their remainders (lo)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int D>
__global__ void __launch_bounds__(kTcWarps * 32)
paged_attend_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ pool_k,
                       const __nv_bfloat16* __restrict__ pool_v, const int* __restrict__ pt,
                       const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                       int* __restrict__ counters, int KV, int G, int maxp, int page, int num_pages, int window,
                       int nsplit, int span) {
  static_assert(D % 16 == 0, "Q.K^T steps 16 columns, P.V 16 columns at a time");
  constexpr int LD = tc_ld(D), CH = D / 8;  // row stride; 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [16][LD]
  __nv_bfloat16* sK = sQ + 16 * LD;                                 // [2][kTile][LD]
  __nv_bfloat16* sV = sK + 2 * kTile * LD;                          // [2][kTile][LD]
  int* sValid = reinterpret_cast<int*>(sV + 2 * kTile * LD);        // [2][kTile]
  float* sM = reinterpret_cast<float*>(sValid + 2 * kTile);         // [warps][16]
  float* sL = sM + kTcWarps * 16;                                   // [warps][16]
  float* sAcc = sL + kTcWarps * 16;                                 // [warps][16][D]

  const int s = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  constexpr int kPer = kTile * CH / (kTcWarps * 32);  // 16-byte chunks of a tile a thread stages
  static_assert(kTile * CH % (kTcWarps * 32) == 0, "a tile's chunks split evenly over the threads");
  // tiles run from the split's first position; the first tile's page ids are
  // loaded before (and beside) the slot's length, which they do not need
  const int base = sp * span;
  int pid0[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int pos = base + (tid + k * kTcWarps * 32) / CH;
    pid0[k] = pos < maxp * page ? pt[(size_t)s * maxp + pos / page] : -1;
  }
  const int len = lengths[s];
  const Span r = split_span(len, maxp, page, window, sp, span);
  if (r.a <= r.b) {
    // positions t0 .. t0 + kTile - 1 into stage buf: K and V rows, zero
    // outside [a, b] or where the page id is out of range, and each row's
    // flag; the first tile also brings the G query rows (zero rows to 16)
    auto stage = [&](int buf, int t0, bool first) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int c = tid + k * kTcWarps * 32, row = c / CH, col = (c % CH) * 8, pos = t0 + row;
        const int pid = first ? pid0[k] : pos < maxp * page ? pt[(size_t)s * maxp + pos / page] : -1;
        long long off = -1;
        if (pos >= r.a && pos <= r.b && pid >= 0 && pid < num_pages)
          off = (((long long)pid * page + pos % page) * KV + h) * D + col;
        if (col == 0) sValid[buf * kTile + row] = off >= 0;
        const int bytes = off >= 0 ? 16 : 0;
        cp_async16(sK + (buf * kTile + row) * LD + col, pool_k + (off >= 0 ? off : 0), bytes);
        cp_async16(sV + (buf * kTile + row) * LD + col, pool_v + (off >= 0 ? off : 0), bytes);
      }
      if (first) {
        const __nv_bfloat16* qb = q + (size_t)(s * KV + h) * G * D;
        for (int c = tid; c < 16 * CH; c += kTcWarps * 32) {
          const int row = c / CH, col = (c % CH) * 8;
          cp_async16(sQ + row * LD + col, qb + (row < G ? row * D + col : 0), row < G ? 16 : 0);
        }
      }
      cp_async_commit();
    };

    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows gid and gid + 8
    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    const int ntiles = (r.b - base) / kTile + 1;  // the first tiles may lie before a window: all masked
    stage(0, base, true);
    for (int it = 0; it < ntiles; ++it) {
      const int buf = it & 1, t0 = base + it * kTile, p0 = warp * 16;
      if (it + 1 < ntiles) {
        stage(buf ^ 1, t0 + kTile, false);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (t0 + p0 <= r.b && t0 + p0 + 15 >= r.a) {  // the warp's 16 positions hold one of the split's
        const __nv_bfloat16* kb = sK + buf * kTile * LD;
        const __nv_bfloat16* vb = sV + buf * kTile * LD;
        // S = Q K^T: 16 query rows x the warp's 16 positions (two n-tiles)
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4], b[4];
          ldsm_x4(a, sQ + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk * 16 + (lane >> 4) * 8);
          ldsm_x4(b, kb + (p0 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 + ((lane >> 3) & 1) * 8);
          mma16816(sc[0], a, b[0], b[1]);
          mma16816(sc[1], a, b[2], b[3]);
        }
        // online softmax over the warp's 16 positions, rows gid (i < 2) and gid + 8
        const int* valid = sValid + buf * kTile + p0;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (!valid[nt * 8 + 2 * tig + (i & 1)]) sc[nt][i] = -INFINITY;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float tmax = fmaxf(fmaxf(sc[0][2 * rr], sc[0][2 * rr + 1]), fmaxf(sc[1][2 * rr], sc[1][2 * rr + 1]));
          tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 1));
          tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 2));
          const float mn = fmaxf(m[rr], tmax);
          const float safe = mn == -INFINITY ? 0.f : mn;
          const float corr = expf(m[rr] - safe);  // 0 while nothing was visible
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int i = 2 * rr; i < 2 * rr + 2; ++i) {
              sc[nt][i] = sc[nt][i] == -INFINITY ? 0.f : expf(sc[nt][i] - safe);
              sum += sc[nt][i];
            }
          l[rr] = l[rr] * corr + sum;  // this thread's columns; the quad's sum at the end
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            acc[j][2 * rr] *= corr;
            acc[j][2 * rr + 1] *= corr;
          }
          m[rr] = mn;
        }
        // P . V with P = hi + lo (the score fragments are P's A fragments)
        uint32_t ph[4], pl[4];
        split2(sc[0][0], sc[0][1], ph[0], pl[0]);
        split2(sc[0][2], sc[0][3], ph[1], pl[1]);
        split2(sc[1][0], sc[1][1], ph[2], pl[2]);
        split2(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
        for (int jj = 0; jj < D / 16; ++jj) {
          uint32_t b[4];
          ldsm_x4_t(b, vb + (p0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + jj * 16 + (lane >> 4) * 8);
          mma16816(acc[2 * jj], ph, b[0], b[1]);
          mma16816(acc[2 * jj], pl, b[0], b[1]);
          mma16816(acc[2 * jj + 1], ph, b[2], b[3]);
          mma16816(acc[2 * jj + 1], pl, b[2], b[3]);
        }
      }
      __syncthreads();  // stage buf is read; the next iteration may refill it
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(kFull, l[rr], 1);
      l[rr] += __shfl_xor_sync(kFull, l[rr], 2);
    }
    if (tig == 0) {
      sM[warp * 16 + gid] = m[0];
      sM[warp * 16 + gid + 8] = m[1];
      sL[warp * 16 + gid] = l[0];
      sL[warp * 16 + gid + 8] = l[1];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * tig;
      sAcc[(warp * 16 + gid) * D + col] = acc[j][0];
      sAcc[(warp * 16 + gid) * D + col + 1] = acc[j][1];
      sAcc[(warp * 16 + gid + 8) * D + col] = acc[j][2];
      sAcc[(warp * 16 + gid + 8) * D + col + 1] = acc[j][3];
    }
    __syncthreads();
    float* part = ws + ((size_t)(s * KV + h) * nsplit + sp) * part_stride(G, D);
    write_partial<kTcWarps, 16>(sM, sL, sAcc, part, G, D);
  }
  finish_splits<__nv_bfloat16>(ws, counters, out, len, s, h, KV, G, D, maxp, page, window, nsplit, span);
}

// ---------------------------------------------------------------------------
// launch

// Shared memory above 48 KB must be opted into; raised once per kernel to the
// largest size asked for so far.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t* opted) {
  if (bytes <= *opted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *opted = bytes;
  return err;
}

struct Args {
  const void *q, *pk, *pv;
  const int *pt, *ln;
  void* out;
  float* ws;
  int* counters;
  int S, KV, G, maxp, page, num_pages, window, nsplit, span;
  cudaStream_t st;
};

template <int D>
int launch_tc(const Args& a) {
  static size_t opted = kStaticSmem;
  const size_t smem = tc_smem_bytes(D);
  const cudaError_t ready = allow_smem(paged_attend_tc_kernel<D>, smem, &opted);
  if (ready != cudaSuccess) return (int)ready;
  paged_attend_tc_kernel<D><<<dim3(a.S, a.KV, a.nsplit), kTcWarps * 32, smem, a.st>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.pk),
      static_cast<const __nv_bfloat16*>(a.pv), a.pt, a.ln, static_cast<__nv_bfloat16*>(a.out), a.ws, a.counters, a.KV,
      a.G, a.maxp, a.page, a.num_pages, a.window, a.nsplit, a.span);
  return (int)cudaGetLastError();
}

template <int D, int GM>
int launch_f32(const Args& a) {
  paged_attend_f32_kernel<D, GM><<<dim3(a.S, a.KV, a.nsplit), warps_for(D, GM) * 32, 0, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.pk), static_cast<const float*>(a.pv), a.pt, a.ln,
      static_cast<float*>(a.out), a.ws, a.counters, a.KV, a.G, a.maxp, a.page, a.num_pages, a.window, a.nsplit,
      a.span);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dim(const Args& a, int dtype) {
  if (dtype == 1) return launch_tc<D>(a);
  return a.G <= 8 ? launch_f32<D, 8>(a) : launch_f32<D, 16>(a);
}

}  // namespace

// q, out: (S, KV, G, D); pool_k, pool_v: (num_pages, page, KV, D), all contiguous,
// 16-byte aligned and of one element type (dtype 0 = float32, 1 = bfloat16);
// page_tables (S, maxp) and lengths (S,) int32. window <= 0 means no window.
// Requires G <= 16 and D in {32, 64, 80, 128, 256}. The grid is (S, KV,
// nsplit), a split `span` positions; workspace: S * KV * nsplit partials of
// G * (D + 2) floats rounded up to 4, 16-byte aligned; counters: S * KV
// ints, zero on entry and left zero.
extern "C" int paged_attend_launch(const void* q, const void* pool_k, const void* pool_v,
                                   const void* page_tables, const void* lengths, void* out, void* workspace,
                                   void* counters, int S, int KV, int G, int D, int maxp, int page, int num_pages,
                                   int window, int nsplit, int span, int dtype, void* stream) {
  if (S <= 0) return 0;
  if (G < 1 || G > kGroupMax || KV < 1 || KV > 65535 || maxp <= 0 || page <= 0 || nsplit < 1 || nsplit > 65535 ||
      span < 1 || (long long)nsplit * span < (long long)maxp * page || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)pool_k | (uintptr_t)pool_v | (uintptr_t)workspace) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const Args a{q, pool_k, pool_v, static_cast<const int*>(page_tables), static_cast<const int*>(lengths), out,
               static_cast<float*>(workspace), static_cast<int*>(counters), S, KV, G, maxp, page, num_pages, window,
               nsplit, span, reinterpret_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return launch_dim<32>(a, dtype);
    case 64: return launch_dim<64>(a, dtype);
    case 80: return launch_dim<80>(a, dtype);
    case 128: return launch_dim<128>(a, dtype);
    case 256: return launch_dim<256>(a, dtype);
    default: return (int)cudaErrorInvalidValue;
  }
}
