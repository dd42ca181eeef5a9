// Mamba2 SSD chunked scan, forward and backward, for float32 and bfloat16
// x/B/C with float32 dt and A, head dims P and state dims N up to 64 and
// chunks of L up to 128 steps.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan/kernel.py::ssd_scan_bh
// (_ssd_kernel). The reference has no backward kernel (it differentiates the
// chunked jnp recompute, ssd_scan/ops.py:52-57); the backward kernels here
// are new and compute the same gradient in closed form.
//
// What it computes, per (batch, head) row with a = A[h] and per chunk of L
// steps, with dA = dt a, cum its inclusive cumsum over the chunk, T = cum[L-1]
// and xbar = x dt:
//   G[l][m] = (C[l].B[m]) e^(cum[l] - cum[m])            (m <= l, else 0)
//   y[l]    = sum_{m<=l} G[l][m] xbar[m] + e^cum[l] (S C[l])
//   S       <- e^T S + sum_l xbar[l]^T (B[l] e^(T - cum[l]))
// with the state S (P x N, f32) carried across chunks from zero. y is
// written in f32 before the D-skip term (the wrapper adds x D in f32 and
// rounds once, as the reference's ssd_chunked does, ref.py:120-121); the
// final S in f32. Every pairwise exponent is <= 0 (A < 0, dt >= 0), so
// nothing overflows; expf (no fast-math, no flush to zero) keeps e^cum
// accurate down to the subnormals it reaches at the end of a long chunk.
//
// Layouts are the model's own: x and y (B, S, H, P), dt (B, S, H), B and C
// (B, S, G, N) read by group (head h reads group h / (H / G); no repeat to
// the heads), A (H,). S need not be a whole number of chunks: rows at or past
// S read as x = B = C = 0 and dt = 0 (an identity decay, as the reference's
// zero padding) and write nothing, so the final state is the padded
// reference's.
//
// What bounds it on the H100: at zamba2's training shape (B 2, S 512, H 64,
// P = N = 64, L 128, bf16 x/B/C) the function moves ~19 MB and its
// GEMM-shaped products (C.B^T, G.xbar, C.S^T, xbar^T.B and the backward's)
// are tensor-core work, so the bound is a few microseconds.
//
// Design: chunk-parallel, two launches a direction. The only serial
// dependence is the state, carried forward across chunks (the backward: its
// cotangent, carried backward), and it is linear:
//   forward:  S_in[c+1] = e^T[c] S_in[c] + S_loc[c],   S_in[0] = 0
//   backward: D[c-1] = e^T[c] D[c] + dS_loc[c],        D[nc-1] = dstate
// with S_loc[c] = sum_l xbar[l]^T (B[l] e^(T-cum[l])) and dS_loc[c] = sum_l
// e^cum[l] dy[l]^T C[l], each local to its chunk. So the first kernel of a
// direction runs a CTA per (row, chunk) that computes its chunk's local
// P x N tile and T; the CTA that draws the last ticket of its row (an integer
// counter the wrapper holds, reset after use) then runs the recurrence over
// the row's tiles in chunk order, in place, turning them into the state
// entering each chunk (the forward saves these for the backward, and writes
// the final state) or the cotangent leaving it. The second kernel runs a CTA
// per chunk again (the backward: per chunk and block of heads) and does
// everything else from its one tile. Nothing is summed across CTAs in a
// varying order: the same bits every run, no float atomics.
//
// The GEMM-shaped products run on mma.sync.m16n8k16 (bf16 in, f32 sums).
// Each operand is staged in shared memory as bf16 tiles (rows padded to 72
// elements, conflict-free ldmatrix): bf16 x, B and C go in exactly; an f32
// operand (the state and its cotangent, dy, B scaled by dt e^(T-cum), and on
// the f32 route x, B and C too) as a bf16 high part and a bf16 low part (the
// remainder), and a product issues hi.hi, hi.lo and lo.hi (lo.lo is below
// 2^-16 of it). The decayed scores, dt folded into them, never leave
// registers: the f32 accumulator fragments of C.B^T (and of x.dy^T) are
// scaled, split and reused as the A fragments of the next product. A warp
// owns 16 rows of the chunk; in the backward the same 16 rows as m (dxbar,
// dB: the triangle's upper part) and as l (dC: the lower part), so every
// warp does about the same work and every row sum of Z = dCB * CB stays in
// one warp.
//
// Backward, per chunk with D the cotangent of the chunk's final state and
// S_prev its starting state:
//   dxbar[m] = sum_{l>=m} G[l][m] dy[l] + e^(T-cum[m]) D B[m]
//   dx = dxbar dt;   ddt (from xbar) = dxbar . x
//   dCB[l][m] = (dy[l].xbar[m]) e^(cum[l]-cum[m])             (m <= l)
//   dC[l] = sum_{m<=l} dCB[l][m] B[m] + e^cum[l] dy[l] S_prev
//   dB[m] = sum_{l>=m} dCB[l][m] C[l] + e^(T-cum[m]) xbar[m] D
//   dcum[l] = sum_{m<l} Z[l][m] - sum_{l'>l} Z[l'][l] + e^cum[l] q[l]
//             - e^(T-cum[l]) w[l],   Z = dCB (C.B), q[l] = C[l].(dy[l] S_prev),
//             w[l] = B[l].(xbar[l] D);  dcum[L-1] += dT,
//   dT = sum_l e^(T-cum[l]) w[l] + e^T (D : S_prev)
//   ddA[t] = sum_{s>=t} dcum[s];  ddt += a ddA;  da = sum_t ddA[t] dt[t]
// A CTA takes a block of heads of one group (the wrapper picks how many:
// about one wave of CTAs) and sums their dB and dC in registers in head
// order, so it writes one partial a block of heads; da is written a (batch,
// chunk, head). The wrapper sums those partials in a fixed order.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxDim = 64;     // P and N
constexpr int kMaxChunk = 128;  // L: a warp a 16 rows of the chunk, eight warps
constexpr int LD = kMaxDim + 8; // bf16 row stride of every staged tile: conflict-free ldmatrix
constexpr int kTile = kMaxChunk * LD;  // elements of a chunk tile (kMaxChunk rows)
constexpr int kState = kMaxDim * LD;   // elements of a state tile (kMaxDim rows)
constexpr int kLocalThreads = 128;     // the local kernels: a warp a 16 rows of P
constexpr int kThreads = 256;          // the main kernels: a warp a 16 rows of the chunk

struct Dims {
  int b, s, h, g, p, n, L, nc;
  int pp, np, lp;  // P, N and L rounded up to 16 (the tensor cores' step)
  int hpc;         // heads a CTA of the backward's main kernel
};

template <typename T>
__host__ __device__ constexpr int parts() {  // bf16 tiles an input operand takes: exact, or hi + lo
  return std::is_same<T, float>::value ? 2 : 1;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// ---------------------------------------------------------------------------
// tensor-core fragments

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
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

// A (16 x 16) at rows r0, columns k0 of a tile stored [row][k]
__device__ __forceinline__ void lda(uint32_t* a, const bf16* t, int r0, int k0) {
  const int ln = threadIdx.x & 31;
  ldsm_x4(a, t + (r0 + (ln & 7) + ((ln >> 3) & 1) * 8) * LD + k0 + (ln >> 4) * 8);
}
// A (16 x 16) at rows r0, columns k0 of a tile stored [k][row]
__device__ __forceinline__ void lda_t(uint32_t* a, const bf16* t, int r0, int k0) {
  const int ln = threadIdx.x & 31;
  ldsm_x4_t(a, t + (k0 + (ln & 7) + (ln >> 4) * 8) * LD + r0 + ((ln >> 3) & 1) * 8);
}
// B (16 x 8) of the n-tiles at n0 (b[0], b[1]) and n0 + 8 (b[2], b[3]), rows
// k0 .. k0 + 15, from a tile stored [n][k]
__device__ __forceinline__ void ldb(uint32_t* b, const bf16* t, int n0, int k0) {
  const int ln = threadIdx.x & 31;
  ldsm_x4(b, t + (n0 + (ln & 7) + (ln >> 4) * 8) * LD + k0 + ((ln >> 3) & 1) * 8);
}
// the same from a tile stored [k][n]
__device__ __forceinline__ void ldb_t(uint32_t* b, const bf16* t, int k0, int n0) {
  const int ln = threadIdx.x & 31;
  ldsm_x4_t(b, t + (k0 + (ln & 7) + ((ln >> 3) & 1) * 8) * LD + n0 + (ln >> 4) * 8);
}

// an operand in shared memory: its hi tile and, for an f32 value, its lo tile
struct Op {
  const bf16* hi;
  const bf16* lo;
};

// two f32 values as a bf16 pair (hi) and the pair of their remainders (lo)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the accumulator fragments of two n-tiles (16 columns) as the A fragments
// (hi, lo) of one k step of the next product
__device__ __forceinline__ void frag_a(const float* c0, const float* c1, uint32_t (*a)[4]) {
  split2(c0[0], c0[1], a[0][0], a[1][0]);
  split2(c0[2], c0[3], a[0][1], a[1][1]);
  split2(c1[0], c1[1], a[0][2], a[1][2]);
  split2(c1[2], c1[3], a[0][3], a[1][3]);
}

// one k step: acc[j] (the n-tile at n0 + 8 j, j < nt) += a . B[k .. k+15],
// with a's AP parts in registers and B's BP parts stored [k][n] (BT) or [n][k]
template <bool BT, int AP, int BP, int NT>
__device__ __forceinline__ void mma_step(float (*acc)[4], uint32_t (*a)[4], Op B, int n0, int nt, int k) {
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    if (j < nt) {
      uint32_t b[BP][4];
#pragma unroll
      for (int v = 0; v < BP; ++v) {
        const bf16* t = v == 0 ? B.hi : B.lo;
        if constexpr (BT) ldb_t(b[v], t, k, n0 + 8 * j);
        else ldb(b[v], t, n0 + 8 * j, k);
      }
#pragma unroll
      for (int u = 0; u < AP; ++u)
#pragma unroll
        for (int v = 0; v < BP; ++v)
          if (u + v < 2) {  // lo . lo dropped
            mma16816(acc[j], a[u], b[v][0], b[v][1]);
            mma16816(acc[j + 1], a[u], b[v][2], b[v][3]);
          }
    }
  }
}

// acc += A (16 rows at r0, k in [0, k1)) . B, A stored [row][k] or, with
// AT, [k][row]
template <bool AT, bool BT, int AP, int BP, int NT>
__device__ __forceinline__ void mma_tile(float (*acc)[4], Op A, int r0, Op B, int n0, int nt, int k1) {
  for (int k = 0; k < k1; k += 16) {
    uint32_t a[AP][4];
#pragma unroll
    for (int u = 0; u < AP; ++u) {
      const bf16* t = u == 0 ? A.hi : A.lo;
      if constexpr (AT) lda_t(a[u], t, r0, k);
      else lda(a[u], t, r0, k);
    }
    mma_step<BT, AP, BP, NT>(acc, a, B, n0, nt, k);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// the sum over a quad (the four lanes that hold one row of a fragment)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows / columns of an accumulator element: row r0 + gid + 8 (i >> 1), column 8 j + 2 tig + (i & 1)
__device__ __forceinline__ int frag_row(int i) { return ((threadIdx.x & 31) >> 2) + 8 * (i >> 1); }
__device__ __forceinline__ int frag_col(int j, int i) { return 8 * j + 2 * (threadIdx.x & 3) + (i & 1); }

// ---------------------------------------------------------------------------
// staging

__device__ __forceinline__ float warp_sum(float v) {  // the same bits in every lane
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// v as bf16 (hi) and its remainder (lo)
__device__ __forceinline__ void split1(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(v);
  lo = __float2bfloat16(v - __bfloat162float(hi));
}

// rows [0, rows) x columns [0, cols) of a slice at src (row stride `stride`
// elements), row r scaled by scale[r] when scale is not null, into the bf16
// tile hi (and the remainder into lo, when not null), zeros up to rp x cp.
// Whole 16-byte vectors where the layout allows (four in flight a thread),
// else element by element.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long stride, int rows, int cols, int rp, int cp,
                                      const float* scale, bf16* hi, bf16* lo) {
  constexpr int V = 16 / (int)sizeof(T), U = 4;
  if (cols % V == 0 && stride % V == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int cv = cp / V, total = rp * cv;
    for (int e0 = threadIdx.x; e0 < total; e0 += U * blockDim.x) {
      uint4 raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * blockDim.x, r = e / cv, c = (e - r * cv) * V;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (e < total && r < rows && c < cols) raw[u] = __ldg(reinterpret_cast<const uint4*>(src + r * stride + c));
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * blockDim.x, r = e / cv, c = (e - r * cv) * V;
        if (e >= total) continue;
        const T* vals = reinterpret_cast<const T*>(&raw[u]);
        const float sc = scale != nullptr && r < rows ? scale[r] : 1.f;
        uint32_t hw[V / 2], lw[V / 2];  // bf16 pairs
#pragma unroll
        for (int i = 0; i < V / 2; ++i) split2(to_f(vals[2 * i]) * sc, to_f(vals[2 * i + 1]) * sc, hw[i], lw[i]);
        if constexpr (V == 8) {
          *reinterpret_cast<uint4*>(hi + r * LD + c) = make_uint4(hw[0], hw[1], hw[2], hw[3]);
          if (lo != nullptr) *reinterpret_cast<uint4*>(lo + r * LD + c) = make_uint4(lw[0], lw[1], lw[2], lw[3]);
        } else {
          *reinterpret_cast<uint2*>(hi + r * LD + c) = make_uint2(hw[0], hw[1]);
          if (lo != nullptr) *reinterpret_cast<uint2*>(lo + r * LD + c) = make_uint2(lw[0], lw[1]);
        }
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < rp * cp; e += blockDim.x) {
    const int r = e / cp, c = e - r * cp;
    float v = 0.f;
    if (r < rows && c < cols) {
      v = to_f(src[r * stride + c]);
      if (scale != nullptr) v *= scale[r];
    }
    bf16 h, l;
    split1(v, h, l);
    hi[r * LD + c] = h;
    if (lo != nullptr) lo[r * LD + c] = l;
  }
}

// dt of the chunk's steps (0 past S and past L; dt_row points at step 0 and
// steps are `stride` apart), cum = the inclusive cumsum of dt a (each product
// rounded; a lane sums its run of at most four steps in order, then a warp
// scan adds the runs), e^cum and e^(T - cum); returns T = cum[L-1]
__device__ __forceinline__ float chunk_steps(const float* __restrict__ dt_row, long long stride, int valid,
                                             const Dims& d, float a, float* DT, float* CUM, float* ECUM, float* DEC) {
  for (int l = threadIdx.x; l < d.lp; l += blockDim.x) DT[l] = l < valid ? dt_row[l * stride] : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, per = (d.lp + 31) / 32;  // at most 4
    float v[4], run = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = lane * per + i;
      if (i < per && l < d.lp) run = __fadd_rn(run, __fmul_rn(DT[l], a));
      v[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl = __fadd_rn(incl, t);
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = lane * per + i;
      if (i < per && l < d.lp) CUM[l] = __fadd_rn(excl, v[i]);
    }
  }
  __syncthreads();
  const float T = CUM[d.L - 1];
  for (int l = threadIdx.x; l < d.lp; l += blockDim.x) {
    ECUM[l] = expf(CUM[l]);
    DEC[l] = expf(T - CUM[l]);
  }
  __syncthreads();
  return T;
}

// a P x N accumulator (warp rows r0 ..) to out[p * N + n]
template <int NT>
__device__ __forceinline__ void store_state(float (*acc)[4], float* out, int r0, const Dims& d) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + frag_row(i), c = frag_col(j, i);
      if (r < d.p && c < d.n) out[r * d.n + c] = acc[j][i];
    }
}

// The recurrence S <- e^T[c] S + tile[c] of one row, over V elements a
// thread (a 16-byte vector, or one) and eight chunks' loads in flight.
template <int V>
__device__ __forceinline__ void scan_elems(float* __restrict__ base, const float* __restrict__ tb, int pn,
                                           const float* __restrict__ init, float* __restrict__ fin, bool backward,
                                           int nc) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  constexpr int kB = 8;
  for (int e = threadIdx.x * V; e < pn; e += blockDim.x * V) {
    float s[V];
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = init != nullptr ? init[e + i] : 0.f;
    for (int k0 = 0; k0 < nc; k0 += kB) {
      Vec loc[kB];
      float et[kB];
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const int c = backward ? nc - 1 - (k0 + u) : k0 + u;
        if (k0 + u < nc) {
          loc[u] = __ldcg(reinterpret_cast<const Vec*>(base + (long long)c * pn + e));
          et[u] = __ldcg(tb + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        if (k0 + u >= nc) break;
        const int c = backward ? nc - 1 - (k0 + u) : k0 + u;
        const float f = expf(et[u]);
        const float* lv = reinterpret_cast<const float*>(&loc[u]);
        Vec out;
        float* ov = reinterpret_cast<float*>(&out);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          ov[i] = s[i];
          s[i] = fmaf(f, s[i], lv[i]);
        }
        __stcg(reinterpret_cast<Vec*>(base + (long long)c * pn + e), out);
      }
    }
    if (fin != nullptr)
#pragma unroll
      for (int i = 0; i < V; ++i) fin[e + i] = s[i];
  }
}

// The ticket of a local kernel: once its tile and T are written, every CTA
// of a row takes one; the CTA that draws the last runs the recurrence
// S <- e^T[c] S + tile[c] over the row's tiles, in place, each tile replaced
// by the S that precedes it: forward from init (or zero) over c = 0 .. nc-1,
// or backward over c = nc-1 .. 0, and writes the S after the last to `fin`
// when not null. Resets the counter.
__device__ __forceinline__ void scan_row(float* __restrict__ tiles, const float* __restrict__ tbuf,
                                         int* __restrict__ counters, int row, const float* __restrict__ init,
                                         float* __restrict__ fin, bool backward, const Dims& d) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counters + row, 1) == d.nc - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int pn = d.p * d.n;
  float* base = tiles + (long long)row * d.nc * pn;
  const float* tb = tbuf + (long long)row * d.nc;
  const float* in = init != nullptr ? init + (long long)row * pn : nullptr;
  float* out = fin != nullptr ? fin + (long long)row * pn : nullptr;
  if (pn % 4 == 0) scan_elems<4>(base, tb, pn, in, out, backward, d.nc);
  else scan_elems<1>(base, tb, pn, in, out, backward, d.nc);
  if (threadIdx.x == 0) counters[row] = 0;
}

// ---------------------------------------------------------------------------
// forward

// shared memory of each kernel, in bytes (tiles at their largest)
template <typename T>
constexpr size_t fwd_local_smem() {
  return 2 * (size_t)(parts<T>() + 2) * kTile + 4 * 5 * kMaxChunk;
}
template <typename T>
constexpr size_t fwd_smem() {
  return 2 * (size_t)(3 * parts<T>() * kTile + 2 * kState) + 4 * 4 * kMaxChunk;
}
template <typename T>
constexpr size_t bwd_local_smem() {
  return 2 * (size_t)(parts<T>() + 2) * kTile + 4 * 4 * kMaxChunk;
}
template <typename T>
constexpr size_t bwd_smem() {
  return 2 * (size_t)((3 * parts<T>() + 2) * kTile + 4 * kState) + 4 * (9 * kMaxChunk + kThreads);
}
static_assert(bwd_smem<float>() <= 232448 && fwd_smem<float>() <= 232448, "the f32 tiles fit one CTA");

// S_loc = sum_l x[l]^T (dt[l] e^(T - cum[l]) B[l]) and T of one (row, chunk);
// then the row's scan (the last CTA): the state entering each chunk, in
// place, and the final state.
template <typename T>
__global__ void __launch_bounds__(kLocalThreads)
ssd_fwd_local_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                     const T* __restrict__ B, float* __restrict__ states, float* __restrict__ tbuf,
                     float* __restrict__ state_out, int* __restrict__ counters, Dims d) {
  constexpr int XP = parts<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sX = reinterpret_cast<bf16*>(smem_raw);  // [XP] x [l][p]
  bf16* sW = sX + XP * kTile;                    // [2] W = dt e^(T - cum) B [l][n]
  float* DT = reinterpret_cast<float*>(sW + 2 * kTile);
  float* CUM = DT + kMaxChunk;
  float* ECUM = CUM + kMaxChunk;
  float* DEC = ECUM + kMaxChunk;
  float* SC = DEC + kMaxChunk;

  const int c = blockIdx.x % d.nc, row = blockIdx.x / d.nc, bi = row / d.h, hi = row % d.h;
  const int gi = hi / (d.h / d.g), t0 = c * d.L, valid = min(d.L, d.s - t0);
  const long long xrow = ((long long)bi * d.s + t0) * d.h + hi;  // (bi, t0, hi)
  const float Tc = chunk_steps(dt + xrow, d.h, valid, d, A[hi], DT, CUM, ECUM, DEC);
  for (int l = threadIdx.x; l < d.lp; l += blockDim.x) SC[l] = DT[l] * DEC[l];
  __syncthreads();
  stage<T>(x + xrow * d.p, (long long)d.h * d.p, valid, d.p, d.lp, d.pp, nullptr, sX, XP == 2 ? sX + kTile : nullptr);
  stage<T>(B + (((long long)bi * d.s + t0) * d.g + gi) * d.n, (long long)d.g * d.n, valid, d.n, d.lp, d.np, SC, sW,
           sW + kTile);
  __syncthreads();
  const int r0 = 16 * (threadIdx.x >> 5);
  if (r0 < d.pp) {  // rows p of S_loc: A = x^T, stored [l][p]; B = W, stored [l][n]
    float acc[8][4];
    zero<8>(acc);
    mma_tile<true, true, XP, 2, 8>(acc, Op{sX, sX + kTile}, r0, Op{sW, sW + kTile}, 0, d.np / 8, d.lp);
    store_state<8>(acc, states + ((long long)row * d.nc + c) * d.p * d.n, r0, d);
  }
  if (threadIdx.x == 0) tbuf[(long long)row * d.nc + c] = Tc;
  scan_row(states, tbuf, counters, row, nullptr, state_out, false, d);
}

// y of one (row, chunk): sum_{m<=l} (C[l].B[m]) e^(cum[l]-cum[m]) dt[m] x[m]
// + e^cum[l] C[l] S_in^T, S_in the state entering the chunk (the local
// kernel's scan).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
               const T* __restrict__ B, const T* __restrict__ C, float* __restrict__ y,
               const float* __restrict__ states, Dims d) {
  constexpr int XP = parts<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sX = reinterpret_cast<bf16*>(smem_raw);  // [XP] [m][p]
  bf16* sB = sX + XP * kTile;                    // [XP] [m][n]
  bf16* sC = sB + XP * kTile;                    // [XP] [l][n]
  bf16* sS = sC + XP * kTile;                    // [2] S_in [p][n]
  float* DT = reinterpret_cast<float*>(sS + 2 * kState);
  float* CUM = DT + kMaxChunk;
  float* ECUM = CUM + kMaxChunk;
  float* DEC = ECUM + kMaxChunk;

  const int c = blockIdx.x % d.nc, row = blockIdx.x / d.nc, bi = row / d.h, hi = row % d.h;
  const int gi = hi / (d.h / d.g), t0 = c * d.L, valid = min(d.L, d.s - t0);
  const long long xrow = ((long long)bi * d.s + t0) * d.h + hi;
  const long long brow = (((long long)bi * d.s + t0) * d.g + gi) * d.n;
  chunk_steps(dt + xrow, d.h, valid, d, A[hi], DT, CUM, ECUM, DEC);
  stage<T>(x + xrow * d.p, (long long)d.h * d.p, valid, d.p, d.lp, d.pp, nullptr, sX, XP == 2 ? sX + kTile : nullptr);
  stage<T>(B + brow, (long long)d.g * d.n, valid, d.n, d.lp, d.np, nullptr, sB, XP == 2 ? sB + kTile : nullptr);
  stage<T>(C + brow, (long long)d.g * d.n, valid, d.n, d.lp, d.np, nullptr, sC, XP == 2 ? sC + kTile : nullptr);
  stage<float>(states + ((long long)row * d.nc + c) * d.p * d.n, d.n, d.p, d.n, d.pp, d.np, nullptr, sS, sS + kState);
  __syncthreads();

  const int w = threadIdx.x >> 5, r0 = 16 * w;
  if (r0 >= d.lp) return;
  const Op oX{sX, sX + kTile}, oB{sB, sB + kTile}, oC{sC, sC + kTile}, oS{sS, sS + kState};
  float yacc[8][4], iacc[8][4];
  zero<8>(yacc);
  zero<8>(iacc);
  for (int j = 0; j <= w; ++j) {  // the m tiles up to the diagonal
    float cb[2][4];
    zero<2>(cb);
    mma_tile<false, false, XP, XP, 2>(cb, oC, r0, oB, 16 * j, 2, d.np);  // C[l] . B[m]
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = r0 + frag_row(i), m = 16 * j + frag_col(nt, i);
        cb[nt][i] = m <= l ? cb[nt][i] * expf(CUM[l] - CUM[m]) * DT[m] : 0.f;
      }
    uint32_t ga[2][4];
    frag_a(cb[0], cb[1], ga);
    mma_step<true, 2, XP, 8>(yacc, ga, oX, 0, d.pp / 8, 16 * j);  // . x[m], stored [m][p]
  }
  mma_tile<false, false, XP, 2, 8>(iacc, oC, r0, oS, 0, d.pp / 8, d.np);  // C[l] . S_in[p], stored [p][n]
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = r0 + frag_row(i), p = frag_col(j, i);
      if (l < valid && p < d.p) y[(xrow + (long long)l * d.h) * d.p + p] = fmaf(ECUM[l], iacc[j][i], yacc[j][i]);
    }
}

// ---------------------------------------------------------------------------
// backward

// dS_loc = sum_l e^cum[l] dy[l]^T C[l] and T of one (row, chunk); then the
// row's scan (the last CTA): from dstate backward, the cotangent of the
// state leaving each chunk, in place.
template <typename T>
__global__ void __launch_bounds__(kLocalThreads)
ssd_bwd_local_kernel(const float* __restrict__ dt, const float* __restrict__ A, const T* __restrict__ C,
                     const float* __restrict__ dy, const float* __restrict__ dstate, float* __restrict__ dws,
                     float* __restrict__ tbuf, int* __restrict__ counters, Dims d) {
  constexpr int XP = parts<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sU = reinterpret_cast<bf16*>(smem_raw);  // [2] e^cum dy [l][p]
  bf16* sC = sU + 2 * kTile;                     // [XP] [l][n]
  float* DT = reinterpret_cast<float*>(sC + XP * kTile);
  float* CUM = DT + kMaxChunk;
  float* ECUM = CUM + kMaxChunk;
  float* DEC = ECUM + kMaxChunk;

  const int c = blockIdx.x % d.nc, row = blockIdx.x / d.nc, bi = row / d.h, hi = row % d.h;
  const int gi = hi / (d.h / d.g), t0 = c * d.L, valid = min(d.L, d.s - t0);
  const long long xrow = ((long long)bi * d.s + t0) * d.h + hi;
  const float Tc = chunk_steps(dt + xrow, d.h, valid, d, A[hi], DT, CUM, ECUM, DEC);
  stage<float>(dy + xrow * d.p, (long long)d.h * d.p, valid, d.p, d.lp, d.pp, ECUM, sU, sU + kTile);
  stage<T>(C + (((long long)bi * d.s + t0) * d.g + gi) * d.n, (long long)d.g * d.n, valid, d.n, d.lp, d.np, nullptr,
           sC, XP == 2 ? sC + kTile : nullptr);
  __syncthreads();
  const int r0 = 16 * (threadIdx.x >> 5);
  if (r0 < d.pp) {  // rows p: A = (e^cum dy)^T, stored [l][p]; B = C, stored [l][n]
    float acc[8][4];
    zero<8>(acc);
    mma_tile<true, true, 2, XP, 8>(acc, Op{sU, sU + kTile}, r0, Op{sC, sC + kTile}, 0, d.np / 8, d.lp);
    store_state<8>(acc, dws + ((long long)row * d.nc + c) * d.p * d.n, r0, d);
  }
  if (threadIdx.x == 0) tbuf[(long long)row * d.nc + c] = Tc;
  scan_row(dws, tbuf, counters, row, dstate, nullptr, true, d);
}

// Everything else of one (batch, chunk, block of heads), head after head:
// dx, ddt, da (a chunk's share), and the block's dB and dC summed in head
// order.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
               const T* __restrict__ B, const T* __restrict__ C, const float* __restrict__ dy,
               const float* __restrict__ states, const float* __restrict__ dws, T* __restrict__ dx,
               float* __restrict__ ddt, float* __restrict__ da_part, float* __restrict__ db_part,
               float* __restrict__ dc_part, Dims d) {
  constexpr int XP = parts<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sB = reinterpret_cast<bf16*>(smem_raw);  // [XP] [m][n]
  bf16* sC = sB + XP * kTile;                    // [XP] [l][n]
  bf16* sX = sC + XP * kTile;                    // [XP] [m][p]
  bf16* sDY = sX + XP * kTile;                   // [2] [l][p]
  bf16* sSP = sDY + 2 * kTile;                   // [2] S_prev [p][n]
  bf16* sDS = sSP + 2 * kState;                  // [2] D [p][n]
  float* DT = reinterpret_cast<float*>(sDS + 2 * kState);
  float* CUM = DT + kMaxChunk;
  float* ECUM = CUM + kMaxChunk;
  float* DEC = ECUM + kMaxChunk;
  float* DDTX = DEC + kMaxChunk;  // dxbar[m] . x[m]
  float* W = DDTX + kMaxChunk;    // w[m] = B[m] . (xbar[m] D)
  float* Q = W + kMaxChunk;       // q[l] = C[l] . (dy[l] S_prev)
  float* RS = Q + kMaxChunk;      // sum_{m<l} Z[l][m]
  float* CS = RS + kMaxChunk;     // sum_{l'>l} Z[l'][l]
  float* RED = CS + kMaxChunk;    // each thread's share of D : S_prev

  const int nhb = d.h / d.hpc;
  const int c = blockIdx.x % d.nc, rest = blockIdx.x / d.nc, hb = rest % nhb, bi = rest / nhb;
  const int h0 = hb * d.hpc, gi = h0 / (d.h / d.g), t0 = c * d.L, valid = min(d.L, d.s - t0);
  const long long bt0 = (long long)bi * d.s + t0;
  const long long brow = (bt0 * d.g + gi) * d.n;
  stage<T>(B + brow, (long long)d.g * d.n, valid, d.n, d.lp, d.np, nullptr, sB, XP == 2 ? sB + kTile : nullptr);
  stage<T>(C + brow, (long long)d.g * d.n, valid, d.n, d.lp, d.np, nullptr, sC, XP == 2 ? sC + kTile : nullptr);

  const int w = threadIdx.x >> 5, r0 = 16 * w, tig = threadIdx.x & 3;
  const bool active = r0 < d.lp;
  const Op oB{sB, sB + kTile}, oC{sC, sC + kTile}, oX{sX, sX + kTile}, oDY{sDY, sDY + kTile};
  const Op oSP{sSP, sSP + kState}, oDS{sDS, sDS + kState};
  float dBa[8][4], dCa[8][4];  // the block's dB (rows m) and dC (rows l), summed over its heads in order
  zero<8>(dBa);
  zero<8>(dCa);

  for (int hh = 0; hh < d.hpc; ++hh) {
    const int h = h0 + hh, row = bi * d.h + h;
    const float a = A[h];
    const long long xrow = bt0 * d.h + h;
    const long long tile = ((long long)row * d.nc + c) * d.p * d.n;
    __syncthreads();  // the previous head's readers are done
    chunk_steps(dt + xrow, d.h, valid, d, a, DT, CUM, ECUM, DEC);
    stage<T>(x + xrow * d.p, (long long)d.h * d.p, valid, d.p, d.lp, d.pp, nullptr, sX,
             XP == 2 ? sX + kTile : nullptr);
    stage<float>(dy + xrow * d.p, (long long)d.h * d.p, valid, d.p, d.lp, d.pp, nullptr, sDY, sDY + kTile);
    stage<float>(states + tile, d.n, d.p, d.n, d.pp, d.np, nullptr, sSP, sSP + kState);
    stage<float>(dws + tile, d.n, d.p, d.n, d.pp, d.np, nullptr, sDS, sDS + kState);
    float ssp = 0.f;  // this thread's share of D : S_prev
    if ((d.p * d.n) % 4 == 0) {
      const float4* D4 = reinterpret_cast<const float4*>(dws + tile);
      const float4* S4 = reinterpret_cast<const float4*>(states + tile);
#pragma unroll 4
      for (int e = threadIdx.x; e < d.p * d.n / 4; e += kThreads) {
        const float4 u = __ldg(D4 + e), v = __ldg(S4 + e);
        ssp = fmaf(u.x, v.x, fmaf(u.y, v.y, fmaf(u.z, v.z, fmaf(u.w, v.w, ssp))));
      }
    } else {
      for (int e = threadIdx.x; e < d.p * d.n; e += kThreads) ssp = fmaf(dws[tile + e], states[tile + e], ssp);
    }
    RED[threadIdx.x] = ssp;
    __syncthreads();

    if (active) {
      float dxa[8][4], tmp[8][4];
      float wp[2] = {0.f, 0.f}, qp[2] = {0.f, 0.f}, csp[2] = {0.f, 0.f}, rsp[2] = {0.f, 0.f}, ddp[2] = {0.f, 0.f};
      // the state terms: dxbar = e^(T-cum[m]) B[m] . D[p]
      zero<8>(dxa);
      mma_tile<false, false, XP, 2, 8>(dxa, oB, r0, oDS, 0, d.pp / 8, d.np);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) dxa[j][i] *= DEC[r0 + frag_row(i)];
      // dB += e^(T-cum[m]) dt[m] x[m] D; w[m] = dt[m] B[m] . (x[m] D)
      zero<8>(tmp);
      mma_tile<false, true, XP, 2, 8>(tmp, oX, r0, oDS, 0, d.np / 8, d.pp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = r0 + frag_row(i), n = frag_col(j, i);
          if (n >= d.np) continue;  // past the staged columns
          float bv = __bfloat162float(sB[m * LD + n]);
          if constexpr (XP == 2) bv += __bfloat162float(sB[kTile + m * LD + n]);
          wp[i >> 1] = fmaf(bv, tmp[j][i], wp[i >> 1]);
          dBa[j][i] = fmaf(DEC[m] * DT[m], tmp[j][i], dBa[j][i]);
        }
      // dC += e^cum[l] dy[l] S_prev; q[l] = C[l] . (dy[l] S_prev)
      zero<8>(tmp);
      mma_tile<false, true, 2, 2, 8>(tmp, oDY, r0, oSP, 0, d.np / 8, d.pp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = r0 + frag_row(i), n = frag_col(j, i);
          if (n >= d.np) continue;
          float cv = __bfloat162float(sC[l * LD + n]);
          if constexpr (XP == 2) cv += __bfloat162float(sC[kTile + l * LD + n]);
          qp[i >> 1] = fmaf(cv, tmp[j][i], qp[i >> 1]);
          dCa[j][i] = fmaf(ECUM[l], tmp[j][i], dCa[j][i]);
        }
      // rows m, columns l >= m: G^T and dCB^T tile by tile; dxbar += G^T dy,
      // dB += dCB^T C, and the column sums of Z
      for (int j = w; 16 * j < d.lp; ++j) {
        float bc[2][4], xd[2][4];
        zero<2>(bc);
        zero<2>(xd);
        mma_tile<false, false, XP, XP, 2>(bc, oB, r0, oC, 16 * j, 2, d.np);   // B[m] . C[l]
        mma_tile<false, false, XP, 2, 2>(xd, oX, r0, oDY, 16 * j, 2, d.pp);   // x[m] . dy[l]
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int m = r0 + frag_row(i), l = 16 * j + frag_col(nt, i);
            const float e = l >= m ? expf(CUM[l] - CUM[m]) : 0.f;
            const float g = bc[nt][i] * e, dcb = xd[nt][i] * DT[m] * e;
            if (l > m) csp[i >> 1] = fmaf(dcb, bc[nt][i], csp[i >> 1]);
            bc[nt][i] = g;
            xd[nt][i] = dcb;
          }
        uint32_t ga[2][4], da[2][4];
        frag_a(bc[0], bc[1], ga);
        frag_a(xd[0], xd[1], da);
        mma_step<true, 2, 2, 8>(dxa, ga, oDY, 0, d.pp / 8, 16 * j);   // . dy[l], stored [l][p]
        mma_step<true, 2, XP, 8>(dBa, da, oC, 0, d.np / 8, 16 * j);   // . C[l], stored [l][n]
      }
      // rows l, columns m <= l: dCB; dC += dCB B, and the row sums of Z
      for (int j = 0; j <= w; ++j) {
        float cb[2][4], yx[2][4];
        zero<2>(cb);
        zero<2>(yx);
        mma_tile<false, false, XP, XP, 2>(cb, oC, r0, oB, 16 * j, 2, d.np);   // C[l] . B[m]
        mma_tile<false, false, 2, XP, 2>(yx, oDY, r0, oX, 16 * j, 2, d.pp);   // dy[l] . x[m]
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int l = r0 + frag_row(i), m = 16 * j + frag_col(nt, i);
            const float dcb = m <= l ? yx[nt][i] * DT[m] * expf(CUM[l] - CUM[m]) : 0.f;
            if (m < l) rsp[i >> 1] = fmaf(dcb, cb[nt][i], rsp[i >> 1]);
            yx[nt][i] = dcb;
          }
        uint32_t da[2][4];
        frag_a(yx[0], yx[1], da);
        mma_step<true, 2, XP, 8>(dCa, da, oB, 0, d.np / 8, 16 * j);   // . B[m], stored [m][n]
      }
      // dx = dxbar dt; dxbar . x
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = r0 + frag_row(i), p = frag_col(j, i);
          if (p >= d.pp) continue;
          float xv = __bfloat162float(sX[m * LD + p]);
          if constexpr (XP == 2) xv += __bfloat162float(sX[kTile + m * LD + p]);
          ddp[i >> 1] = fmaf(dxa[j][i], xv, ddp[i >> 1]);
          if (m < valid && p < d.p) dx[(xrow + (long long)m * d.h) * d.p + p] = from_f<T>(dxa[j][i] * DT[m]);
        }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float dd = quad_sum(ddp[rr]), ww = quad_sum(wp[rr]), qq = quad_sum(qp[rr]);
        const float cs = quad_sum(csp[rr]), rs = quad_sum(rsp[rr]);
        if (tig == 0) {
          const int r = r0 + frag_row(2 * rr);
          DDTX[r] = dd;
          W[r] = DT[r] * ww;
          Q[r] = qq;
          CS[r] = cs;
          RS[r] = rs;
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // dT into dcum[L-1], then ddA by a reverse cumsum (a warp scan): ddt and da
      const int lane = threadIdx.x, per = (d.L + 31) / 32;  // a lane's run of at most four steps
      float ss = 0.f, dT = 0.f;
      for (int k = lane; k < kThreads; k += 32) ss += RED[k];
      for (int l = lane; l < d.L; l += 32) dT = fmaf(DEC[l], W[l], dT);
      const float top = fmaf(expf(CUM[d.L - 1]), warp_sum(ss), warp_sum(dT));
      float v[4], run = 0.f;  // v[i]: the sum of dcum over the lane's steps from i to its run's end
#pragma unroll
      for (int i = 3; i >= 0; --i) {
        const int l = lane * per + i;
        if (i < per && l < d.L) run += fmaf(ECUM[l], Q[l], fmaf(-DEC[l], W[l], RS[l] - CS[l]));
        v[i] = run;
      }
      float incl = run;  // the sum over this lane's run and every later one
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += t;
      }
      float later = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) later = 0.f;
      float dap = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = lane * per + i;
        if (i < per && l < d.L) {
          const float acc = top + (later + v[i]);  // ddA[l]
          if (l < valid) ddt[xrow + (long long)l * d.h] = fmaf(a, acc, DDTX[l]);
          dap = fmaf(acc, DT[l], dap);
        }
      }
      const float da = warp_sum(dap);
      if (lane == 0) da_part[((long long)bi * d.nc + c) * d.h + h] = da;
    }
  }
  if (!active) return;
  // the block's dB (rows m) and dC (rows l): (B, S, H / hpc, N) partials
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + frag_row(i), n = frag_col(j, i);
      if (r < valid && n < d.n) {
        const long long o = ((bt0 + r) * nhb + hb) * d.n + n;
        db_part[o] = dBa[j][i];
        dc_part[o] = dCa[j][i];
      }
    }
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

int round16(int v) { return (v + 15) / 16 * 16; }

bool make_dims(int b, int s, int h, int g, int p, int n, int chunk, int hpc, Dims* d) {
  if (b < 1 || s < 1 || h < 1 || g < 1 || h % g != 0) return false;
  if (p < 1 || p > kMaxDim || n < 1 || n > kMaxDim || chunk < 1 || chunk > kMaxChunk) return false;
  if (hpc < 1 || (h / g) % hpc != 0) return false;
  const long long nc = (s + chunk - 1) / chunk;
  if ((long long)b * h * nc >= (1LL << 31)) return false;
  *d = Dims{b, s, h, g, p, n, chunk, (int)nc, round16(p), round16(n), round16(chunk), hpc};
  return true;
}

template <typename T>
int fwd_local(const void* x, const void* dt, const void* A, const void* B, void* states, void* tbuf, void* state,
              void* counters, const Dims& d, cudaStream_t st) {
  static size_t opted = 48 * 1024;
  const cudaError_t ready = allow_smem(ssd_fwd_local_kernel<T>, fwd_local_smem<T>(), &opted);
  if (ready != cudaSuccess) return (int)ready;
  ssd_fwd_local_kernel<T><<<d.b * d.h * d.nc, kLocalThreads, fwd_local_smem<T>(), st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<float*>(states), static_cast<float*>(tbuf), static_cast<float*>(state),
      static_cast<int*>(counters), d);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y, const void* states,
        const Dims& d, cudaStream_t st) {
  static size_t opted = 48 * 1024;
  const cudaError_t ready = allow_smem(ssd_fwd_kernel<T>, fwd_smem<T>(), &opted);
  if (ready != cudaSuccess) return (int)ready;
  ssd_fwd_kernel<T><<<d.b * d.h * d.nc, kThreads, fwd_smem<T>(), st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<float*>(y), static_cast<const float*>(states),
      d);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_local(const void* dt, const void* A, const void* C, const void* dy, const void* dstate, void* dws, void* tbuf,
              void* counters, const Dims& d, cudaStream_t st) {
  static size_t opted = 48 * 1024;
  const cudaError_t ready = allow_smem(ssd_bwd_local_kernel<T>, bwd_local_smem<T>(), &opted);
  if (ready != cudaSuccess) return (int)ready;
  ssd_bwd_local_kernel<T><<<d.b * d.h * d.nc, kLocalThreads, bwd_local_smem<T>(), st>>>(
      static_cast<const float*>(dt), static_cast<const float*>(A), static_cast<const T*>(C),
      static_cast<const float*>(dy), static_cast<const float*>(dstate), static_cast<float*>(dws),
      static_cast<float*>(tbuf), static_cast<int*>(counters), d);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const void* dt, const void* A, const void* B, const void* C, const void* dy,
        const void* states, const void* dws, void* dx, void* ddt, void* da_part, void* db_part, void* dc_part,
        const Dims& d, cudaStream_t st) {
  static size_t opted = 48 * 1024;
  const cudaError_t ready = allow_smem(ssd_bwd_kernel<T>, bwd_smem<T>(), &opted);
  if (ready != cudaSuccess) return (int)ready;
  ssd_bwd_kernel<T><<<d.b * (d.h / d.hpc) * d.nc, kThreads, bwd_smem<T>(), st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<const float*>(dy),
      static_cast<const float*>(states), static_cast<const float*>(dws), static_cast<T*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(da_part), static_cast<float*>(db_part),
      static_cast<float*>(dc_part), d);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C); dt, A, y and the states are
// float32. x, y: (b, s, h, p) contiguous; dt: (b, s, h); A: (h,); B, C:
// (b, s, g, n). Scratch the wrapper owns: states (b * h, nc, p, n) and tbuf
// (b * h * nc) f32; counters (b * h) int32, zero on entry and left zero.

// The forward's first launch: every chunk's local state and T, then each
// row's scan: states[row, c] = the state entering chunk c; state (b, h, p, n)
// = the final state.
extern "C" int ssd_fwd_local_launch(const void* x, const void* dt, const void* A, const void* B, void* states,
                                    void* tbuf, void* state, void* counters, int b, int s, int h, int g, int p, int n,
                                    int chunk, int dtype, void* stream) {
  Dims d;
  if (!make_dims(b, s, h, g, p, n, chunk, 1, &d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd_local<float>(x, dt, A, B, states, tbuf, state, counters, d, st);
  if (dtype == 1) return fwd_local<bf16>(x, dt, A, B, states, tbuf, state, counters, d, st);
  return (int)cudaErrorInvalidValue;
}

// The forward's second launch: y (b, s, h, p) f32 before the D-skip, from the
// states the first left.
extern "C" int ssd_fwd_launch(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y,
                              const void* states, int b, int s, int h, int g, int p, int n, int chunk, int dtype,
                              void* stream) {
  Dims d;
  if (!make_dims(b, s, h, g, p, n, chunk, 1, &d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, dt, A, B, C, y, states, d, st);
  if (dtype == 1) return fwd<bf16>(x, dt, A, B, C, y, states, d, st);
  return (int)cudaErrorInvalidValue;
}

// The backward's first launch: dy (b, s, h, p) f32 and dstate (the final
// state's cotangent, (b, h, p, n) f32, null for zero) to dws (b * h, nc, p,
// n): the cotangent of the state leaving each chunk; tbuf as the forward's.
extern "C" int ssd_bwd_local_launch(const void* dt, const void* A, const void* C, const void* dy, const void* dstate,
                                    void* dws, void* tbuf, void* counters, int b, int s, int h, int g, int p, int n,
                                    int chunk, int dtype, void* stream) {
  Dims d;
  if (!make_dims(b, s, h, g, p, n, chunk, 1, &d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd_local<float>(dt, A, C, dy, dstate, dws, tbuf, counters, d, st);
  if (dtype == 1) return bwd_local<bf16>(dt, A, C, dy, dstate, dws, tbuf, counters, d, st);
  return (int)cudaErrorInvalidValue;
}

// The backward's second launch, a CTA per (batch, chunk, block of hpc heads
// of one group): dx (b, s, h, p) in x's type; ddt (b, s, h) f32; da_part
// (b, nc, h) f32, each chunk's share of dA; db_part, dc_part (b, s, h / hpc,
// n) f32, each block's share of its group's dB and dC.
extern "C" int ssd_bwd_launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                              const void* dy, const void* states, const void* dws, void* dx, void* ddt, void* da_part,
                              void* db_part, void* dc_part, int b, int s, int h, int g, int p, int n, int chunk,
                              int hpc, int dtype, void* stream) {
  Dims d;
  if (!make_dims(b, s, h, g, p, n, chunk, hpc, &d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd<float>(x, dt, A, B, C, dy, states, dws, dx, ddt, da_part, db_part, dc_part, d, st);
  if (dtype == 1) return bwd<bf16>(x, dt, A, B, C, dy, states, dws, dx, ddt, da_part, db_part, dc_part, d, st);
  return (int)cudaErrorInvalidValue;
}
