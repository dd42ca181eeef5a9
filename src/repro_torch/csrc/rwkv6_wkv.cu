// RWKV-6 chunked WKV recurrence, forward and backward, for float32 and
// bfloat16 r/k/v/u with float32 decays w, head dims N = P in {32, 64} and
// chunks of L in {16, 32, 64} steps.
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_wkv/kernel.py::wkv_bh
// (_wkv_kernel). The reference has no backward kernel (it differentiates the
// chunked jnp recompute, rwkv6_wkv/ops.py:43-50); the backward kernels here
// are new and compute the same gradient in closed form.
//
// What it computes, per (batch, head) row and per chunk of L steps, with
// logw = log(max(w, 1e-30)), cum its inclusive cumsum over the chunk,
// cum_excl = cum - logw and total = cum[L-1]:
//   A[l][m] = sum_n r[l][n] e^(cum_excl[l][n] - cum[m][n]) k[m][n]   (m < l)
//   y[l]    = sum_{m<l} A[l][m] v[m] + (sum_n r[l][n] u[n] k[l][n]) v[l]
//             + sum_n r[l][n] e^cum_excl[l][n] S[n][:]
//   S       <- e^total S + sum_l (k[l] e^(total - cum[l]))^T v[l]
// with the state S (N x P, f32) carried across chunks; y is rounded once to
// r's type, the final S returned in f32 (repro/kernels/rwkv6_wkv/ref.py::
// wkv_chunked, op for op up to the order of sums).
//
// Layouts are the model's own: r, k, v, w, y and the gradients (B, S, H, N),
// u (H, N); no transpose to (B*H, S, N) and no padding of S to whole
// chunks: the last chunk is bounds-checked, rows past S read as r = k = v = 0,
// w = 1 (as the reference pads) and write nothing.
//
// What bounds it on the H100: bytes. At the rwkv6 slice (B 2, S 512, H 64,
// N 64, L 32, bf16 r/k/v/u, f32 w) the function moves 52 MB forward and 94 MB
// backward (15.7 / 28.2 us at 3.35 TB/s); its GEMM-shaped products are
// tensor-core work, and the pairwise exponentials of the diagonal blocks
// (below) and the per-element ones are 44 M a direction on the SFU (10.6
// us). This design also writes, scans and re-reads the N x N state of every
// chunk (16 KB a chunk at the slice, 33.5 MB a direction), which the
// function does not need: at L 32 that state traffic, not the chunk's own
// rows, sets each local kernel's bytes.
//
// Design: chunk-parallel, two launches a direction. The only serial
// dependence is the state, carried forward across chunks (the backward: its
// cotangent, carried backward), and it is linear, with a decay for each row
// n of the N x P state:
//   forward:  S_in[c+1] = e^total[c] (.)rows S_in[c] + S_loc[c],   S_in[0] = 0
//   backward: D[c-1] = e^total[c] (.)rows D[c] + dS_loc[c],        D[nc-1] = dstate
// with S_loc[c] = sum_l (k[l] e^(total-cum[l]))^T v[l] and dS_loc[c] =
// sum_l (r[l] e^cum_excl[l])^T dy[l], each local to its chunk. So the first
// kernel of a direction (wkv_fwd_local, wkv_bwd_local) runs a CTA per (row,
// chunk) that computes its chunk's local N x P tile and total; the CTA that
// draws the last ticket of its row (an int32 counter the wrapper holds, left
// at zero) then runs the recurrence over the row's tiles in chunk order, in
// place, sixteen chunks' loads in flight, turning them into the state entering
// each chunk (the forward keeps these for the backward, and writes the final
// state) or the cotangent leaving it. The second kernel (wkv_fwd, wkv_bwd)
// runs a CTA per (row, chunk) again and does everything else from its one
// state tile. Nothing is summed across CTAs in a varying order: the same bits
// every run, no float atomics.
//
// The intra-chunk scores by sub-blocks of 16 rows. The decay is per channel,
// so A is not one product of two matrices, and factoring the whole chunk as
// (r e^cum_excl) (k e^-cum)^T overflows at the decays the model reaches
// (e^-cum grows as e^(69 L) for w near 1e-30). With c_J = cum at the last row
// of key sub-block J, an off-diagonal block (query rows l in I, keys m in
// J < I) is
//   A_IJ = (r_I (.) e^(cum_excl_I - c_J)) . (k_J (.) e^(c_J - cum_J))^T,
// one tensor-core product of two scaled 16 x N tiles. Both exponents are
// <= 0 when log w <= 0 (the model's w is exp(-exp(.)), padding has w = 1):
// cum_excl[l] - c_J sums log w over steps 16J+16 .. l-1 and c_J - cum[m] over
// m+1 .. 16J+15. So no factor overflows, and a factor underflows only where
// the exact product, which it bounds, is already below f32's normal range.
// Only the diagonal 16 x 16 blocks take the pairwise exponential
// e^(cum_excl[l] - cum[m]), each once (240 of the 496 pairs of a chunk at
// L 32, 480 of 2016 at L 64): a thread per (sub-block, column n) walks the
// block's 120 pairs and its 16 bonus terms, and a warp's 32 columns are
// summed per pair by a butterfly over the lanes (the two warps of a 64-wide
// block in order through shared memory). The backward reuses each pair's
// exponential for A, Q and R in the same pass.
//
// cum is summed down each column in step order by one thread, the order of
// torch.cumsum in the plain version: at strong decay (w of 1e-30 beside 0.5)
// |cum| reaches 69 L, and a cumsum in another order moves y by ~2e-5 of its
// largest value through the cancellation in cum_excl[l] - cum[m] alone.
//
// The per-pair and per-element factors inside a chunk are __expf
// (ex2.approx, within 2 + 1.17|x| ulps; every exponent is <= 0), the chunk's
// log w and e^total the full-precision logf and expf.
//
// The GEMM-shaped products run on mma.sync.m16n8k16 (bf16 in, f32 sums). An
// operand is staged in shared memory as bf16 tiles (rows padded to 72
// elements, conflict-free ldmatrix) or built in registers: bf16 v and dy go
// in exactly; an f32 operand (the scaled r and k, the scores, the state and
// its cotangent, and on the f32 route v and dy too) as a bf16 high part and a
// bf16 low part (the remainder), and a product issues hi.hi, hi.lo and lo.hi
// (lo.lo is below 2^-16 of it). The scores never leave registers: the f32
// accumulator fragments of a score block are split and reused as the A
// fragments of the next product. The state and its cotangent are read from
// L2 straight into B fragments, split as they arrive; r and k stay in
// shared memory in the input type. A CTA's loads of its chunk (r, k, v, w,
// dy) go out in one batch of 16-byte vectors. A main kernel's CTA has four
// warps; warp w takes sub-block w / wpb and a 1/wpb slice of the columns
// (wpb = 4 / (L/16), at most N/16 slices), so a chunk of 32 rows keeps four
// warps busy (the 16 x 16 score blocks are formed by each slice's warp). At
// the slice the backward's main kernel holds 70 KB of shared memory and 168
// registers a thread: three CTAs an SM.
//
// Backward, per chunk with D the cotangent of the chunk's final state and
// S_prev its starting state, dA[l][m] = dy[l].v[m] (its diagonal dD[l] the
// bonus's cotangent):
//   dv[m]  = sum_{l>=m} A[l][m] dy[l] + sum_n k[m][n] e^(total-cum[m][n]) D[n][:]
//   Q[l][n] = sum_{m<l} dA[l][m] k[m][n] e^(cum_excl[l][n]-cum[m][n]),
//   R[m][n] = sum_{l>m} dA[l][m] r[l][n] e^(cum_excl[l][n]-cum[m][n]),
//   g[l][n] = dy[l].S_prev[n][:],  h[m][n] = D[n][:].v[m]
//   dr = Q + dD u k + g e^cum_excl;  dk = R + dD u r + h e^(total-cum)
//   du[n] = sum_l dD[l] r[l][n] k[l][n]   (a partial per (row, chunk); the
//           wrapper sums them, chunks first, then the batch)
//   dcum_excl = r (Q + g e^cum_excl);  dcum = -k R - h k e^(total-cum)
//   dtotal[n] = sum_m h k e^(total-cum) + e^total[n] D[n][:].S_prev[n][:]
//   dlogw[t] = sum_{s>=t} dcum[s] + sum_{s>t} dcum_excl[s] + dtotal
//   dw = dlogw / w where w > 1e-30, half that at w = 1e-30 (the gradient of
//        max(w, 1e-30) at the tie, as jnp.maximum and torch.maximum), else 0
// The off-diagonal blocks of Q and R by the same factoring: Q_I +=
// e^(cum_excl_I - c_J) (.) (dA_IJ . (k_J e^(c_J - cum_J))) and R_J +=
// e^(c_J - cum_J) (.) (dA_IJ^T . (r_I e^(cum_excl_I - c_J))), each a
// tensor-core product and an elementwise scale. Warp w holds its sub-block's
// rows both as queries l (dr, Q, g) and as keys m (dk, dv, R, h).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxDim = 64;      // N = P
constexpr int LD = kMaxDim + 8;  // bf16 row stride of every staged tile: conflict-free ldmatrix
constexpr int FP = kMaxDim + 4;  // f32 row stride of the [L][N] tiles
constexpr int kThreads = 128;  // every kernel: four warps
constexpr int kPairs = 136;      // pairs (l, m <= l) of a 16 x 16 diagonal block, the bonus included
constexpr int kAB = 16 * 17;     // a 16 x 16 f32 block, rows padded by one

struct Dims {
  int b, s, h, n, L, nc;
  int lgn;  // log2(n): n is 32 or 64, so e / n and e % n are shifts
  int nb;   // L / 16 sub-blocks of rows
  int wpb;  // warps on one sub-block in the main kernels, each a slice of the columns
};

// row stride of the chunk's r and k tiles, held in the input type: f32
// [L][FP], or bf16 [L][LD] (16-byte rows)
template <typename T>
__host__ __device__ constexpr int rstride() {
  return std::is_same<T, float>::value ? FP : LD;
}

// two neighbouring values of a tile as f32
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// e^x for the per-pair and per-element factors inside a chunk: ex2.approx
// of x log2(e), within 2 + 1.17|x| ulps (CUDA C++ Programming Guide, the
// intrinsic functions); every x here is <= 0 and a factor that large in |x|
// multiplies terms that small
__device__ __forceinline__ float fexp(float x) { return __expf(x); }

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

// one k step: acc[j] (the n-tile at n0 + 8 j, j < NT) += a . B[k .. k+15],
// with a's AP parts in registers and B's BP parts stored [k][n] (BT) or [n][k]
template <bool BT, int AP, int BP, int NT>
__device__ __forceinline__ void mma_step(float (*acc)[4], uint32_t (*a)[4], Op B, int n0, int k) {
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
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

// acc += A (16 rows at r0, k in [0, k1)) . B, A stored [row][k] or, with
// AT, [k][row]
template <bool AT, bool BT, int AP, int BP, int NT>
__device__ __forceinline__ void mma_tile(float (*acc)[4], Op A, int r0, Op B, int n0, int k1) {
  for (int k = 0; k < k1; k += 16) {
    uint32_t a[AP][4];
#pragma unroll
    for (int u = 0; u < AP; ++u) {
      const bf16* t = u == 0 ? A.hi : A.lo;
      if constexpr (AT) lda_t(a[u], t, r0, k);
      else lda(a[u], t, r0, k);
    }
    mma_step<BT, AP, BP, NT>(acc, a, B, n0, k);
  }
}

// one k step against an f32 matrix X (row stride ld; global or shared
// memory), split into hi + lo as it is read: B[k][n] = X[k][n] (BT) or X[n][k]
template <bool BT, int AP, int NT>
__device__ __forceinline__ void mma_step_f32(float (*acc)[4], uint32_t (*a)[4], const float* X, int ld, int n0, int k) {
  const int ln = threadIdx.x & 31, g = ln >> 2, tg = ln & 3;
  float x[NT][2][2];  // every load of the step in flight before the products
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + 8 * j + g, kk = k + 2 * tg + 8 * q;
      if constexpr (BT) {
        x[j][q][0] = X[kk * ld + n];
        x[j][q][1] = X[(kk + 1) * ld + n];
      } else {
        const float2 t = *reinterpret_cast<const float2*>(X + n * ld + kk);
        x[j][q][0] = t.x;
        x[j][q][1] = t.y;
      }
    }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t bh[2], bl[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) split2(x[j][q][0], x[j][q][1], bh[q], bl[q]);
#pragma unroll
    for (int u = 0; u < AP; ++u) {
      mma16816(acc[j], a[u], bh[0], bh[1]);
      if (u == 0) mma16816(acc[j], a[0], bl[0], bl[1]);
    }
  }
}

// acc += A (16 rows at r0 of a tile stored [row][k], k in [0, k1)) . X
template <bool BT, int AP, int NT>
__device__ __forceinline__ void mma_tile_f32(float (*acc)[4], Op A, int r0, const float* X, int ld, int n0, int k1) {
  for (int k = 0; k < k1; k += 16) {
    uint32_t a[AP][4];
#pragma unroll
    for (int u = 0; u < AP; ++u) lda(a[u], u == 0 ? A.hi : A.lo, r0, k);
    mma_step_f32<BT, AP, NT>(acc, a, X, ld, n0, k);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// rows / columns of an accumulator element: row r0 + gid + 8 (i >> 1), column 8 j + 2 tig + (i & 1)
__device__ __forceinline__ int frag_row(int i) { return ((threadIdx.x & 31) >> 2) + 8 * (i >> 1); }
__device__ __forceinline__ int frag_col(int j, int i) { return 8 * j + 2 * (threadIdx.x & 3) + (i & 1); }

// The A fragments (hi, lo) of rows r0 .. r0+15, columns k0 .. k0+15 of
// X (.) e^(E - ref), X an r or k tile, E an f32 tile [l][FP], ref a vector over the columns
// (zero when null): r e^cum_excl, or r e^(cum_excl - c_J); with NEG,
// X (.) e^(ref - E): k e^(total - cum).
template <bool NEG = false, typename TX>
__device__ __forceinline__ void frag_scaled(uint32_t (*a)[4], const TX* X, const float* E, const float* ref, int r0,
                                            int k0) {
  const int ln = threadIdx.x & 31, g = ln >> 2, tg = ln & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int l = r0 + g + 8 * (q & 1), n = k0 + 2 * tg + 8 * (q >> 1);
    const float2 x = ld2(X + l * rstride<TX>() + n);
    const float2 e = ld2(E + l * FP + n);
    const float c0 = ref != nullptr ? ref[n] : 0.f, c1 = ref != nullptr ? ref[n + 1] : 0.f;
    if constexpr (NEG) split2(x.x * fexp(c0 - e.x), x.y * fexp(c1 - e.y), a[0][q], a[1][q]);
    else split2(x.x * fexp(e.x - c0), x.y * fexp(e.y - c1), a[0][q], a[1][q]);
  }
}

// The B fragments (hi, lo) of X (.) e^(E - ref) as B[k = column n][col = row
// l], for the two n-tiles of rows l0 .. l0+15 and the k step k0: b[part][tile][reg]
template <typename TX>
__device__ __forceinline__ void frag_b_rows(uint32_t (*b)[2][2], const TX* X, const float* E, const float* ref,
                                            int l0, int k0) {
  const int ln = threadIdx.x & 31, g = ln >> 2, tg = ln & 3;
#pragma unroll
  for (int tt = 0; tt < 2; ++tt)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int l = l0 + 8 * tt + g, n = k0 + 2 * tg + 8 * q;
      const float2 x = ld2(X + l * rstride<TX>() + n);
      const float2 e = ld2(E + l * FP + n);
      split2(x.x * fexp(e.x - ref[n]), x.y * fexp(e.y - ref[n + 1]), b[0][tt][q], b[1][tt][q]);
    }
}

// The B fragments (hi, lo) of X (.) e^(E - ref) as B[k = row l][col = column
// n], rows l0 .. l0+15, the n-tile at n0: b[part][reg]
template <typename TX>
__device__ __forceinline__ void frag_b_cols(uint32_t (*b)[2], const TX* X, const float* E, const float* ref, int l0,
                                            int n0) {
  const int ln = threadIdx.x & 31, g = ln >> 2, tg = ln & 3;
  const int n = n0 + g, rs = rstride<TX>();
  const float c = ref[n];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int l = l0 + 2 * tg + 8 * q;
    split2(to_f(X[l * rs + n]) * fexp(E[l * FP + n] - c), to_f(X[(l + 1) * rs + n]) * fexp(E[(l + 1) * FP + n] - c),
           b[0][q], b[1][q]);
  }
}

// The A fragments (hi, lo) of a 16 x 16 f32 block stored [row][col] (row
// stride 17), or of its transpose
__device__ __forceinline__ void frag_block(uint32_t (*a)[4], const float* A, bool tr) {
  const int ln = threadIdx.x & 31, g = ln >> 2, tg = ln & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = g + 8 * (q & 1), j = 2 * tg + 8 * (q >> 1);
    const float x = tr ? A[j * 17 + i] : A[i * 17 + j];
    const float y = tr ? A[(j + 1) * 17 + i] : A[i * 17 + j + 1];
    split2(x, y, a[0][q], a[1][q]);
  }
}

// ---------------------------------------------------------------------------
// staging

// v as bf16 (hi) and its remainder (lo)
__device__ __forceinline__ void split1(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(v);
  lo = __float2bfloat16(v - __bfloat162float(hi));
}

// 16-byte vector u of a T tensor (bf16: 8 values, f32: 4) as f32 values
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* out) {
  const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) out[i] = to_f(vals[i]);
}

// V f32 values to the bf16 tile hi (and their remainders to lo when not null) at element o
template <int V>
__device__ __forceinline__ void put_split(const float* x, bf16* hi, bf16* lo, int o) {
  uint32_t hw[V / 2], lw[V / 2];
#pragma unroll
  for (int i = 0; i < V / 2; ++i) split2(x[2 * i], x[2 * i + 1], hw[i], lw[i]);
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(hi + o) = make_uint4(hw[0], hw[1], hw[2], hw[3]);
    if (lo != nullptr) *reinterpret_cast<uint4*>(lo + o) = make_uint4(lw[0], lw[1], lw[2], lw[3]);
  } else {
    *reinterpret_cast<uint2*>(hi + o) = make_uint2(hw[0], hw[1]);
    if (lo != nullptr) *reinterpret_cast<uint2*>(lo + o) = make_uint2(lw[0], lw[1]);
  }
}

// The chunk's rows of a, b, c, c2 (T) and w (f32) in one batch of 16-byte
// loads, four vectors of each in flight a thread: a and b as they are into
// the tiles A, B (row stride rstride<T>()); c and c2 into the bf16 tiles Ch, C2h (and their remainders into Cl,
// C2l on the f32 route); w into W when not null and log(max(w, 1e-30)) into
// LW. A null source among a, b, c, c2 is skipped. Rows at or past `valid`
// read a = b = c = c2 = 0 and w = 1 (log w = 0).
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ c,
                                           const T* __restrict__ c2, const float* __restrict__ w, long long tstride,
                                           int valid, const Dims& d, T* A, T* B, bf16* Ch, bf16* Cl,
                                           bf16* C2h, bf16* C2l, float* W, float* LW) {
  constexpr int VT = 16 / (int)sizeof(T), U = 4, LVT = VT == 8 ? 3 : 2;
  const int st = d.lgn - LVT, sw = d.lgn - 2;  // log2 of the vectors a row
  const int cvt = 1 << st, tt = d.L * cvt, cvw = 1 << sw, tw = d.L * cvw;  // tw >= tt
  for (int e0 = threadIdx.x; e0 < tw; e0 += U * blockDim.x) {
    uint4 ra[U], rb[U], rc[U], rd[U];
    float4 rw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * blockDim.x, lt = e >> st, ct = (e & (cvt - 1)) * VT, lw = e >> sw, cw = (e & (cvw - 1)) * 4;
      const bool okt = e < tt && lt < valid, okw = e < tw && lw < valid;
      const long long ot = lt * tstride + ct;
      ra[u] = rb[u] = rc[u] = rd[u] = make_uint4(0u, 0u, 0u, 0u);
      if (okt && a != nullptr) ra[u] = __ldg(reinterpret_cast<const uint4*>(a + ot));
      if (okt && b != nullptr) rb[u] = __ldg(reinterpret_cast<const uint4*>(b + ot));
      if (okt && c != nullptr) rc[u] = __ldg(reinterpret_cast<const uint4*>(c + ot));
      if (okt && c2 != nullptr) rd[u] = __ldg(reinterpret_cast<const uint4*>(c2 + ot));
      rw[u] = okw ? __ldg(reinterpret_cast<const float4*>(w + lw * tstride + cw)) : make_float4(1.f, 1.f, 1.f, 1.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * blockDim.x, lt = e >> st, ct = (e & (cvt - 1)) * VT, lw = e >> sw, cw = (e & (cvw - 1)) * 4;
      if (e < tt) {
        if (a != nullptr) *reinterpret_cast<uint4*>(A + lt * rstride<T>() + ct) = ra[u];
        if (b != nullptr) *reinterpret_cast<uint4*>(B + lt * rstride<T>() + ct) = rb[u];
        if constexpr (VT == 8) {  // bf16: the operand tiles take the values as they are
          if (c != nullptr) *reinterpret_cast<uint4*>(Ch + lt * LD + ct) = rc[u];
          if (c2 != nullptr) *reinterpret_cast<uint4*>(C2h + lt * LD + ct) = rd[u];
        } else {
          float x[VT];
          if (c != nullptr) {
            unpack<T>(rc[u], x);
            put_split<VT>(x, Ch, Cl, lt * LD + ct);
          }
          if (c2 != nullptr) {
            unpack<T>(rd[u], x);
            put_split<VT>(x, C2h, C2l, lt * LD + ct);
          }
        }
      }
      if (e < tw) {
        const float x[4] = {rw[u].x, rw[u].y, rw[u].z, rw[u].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (W != nullptr) W[lw * FP + cw + i] = x[i];
          LW[lw * FP + cw + i] = logf(fmaxf(x[i], 1e-30f));
        }
      }
    }
  }
}

// The cumsum of the log-decays (in CE on entry), a column a thread in step
// order (the plain version's torch.cumsum order, so that both hold the same
// bits): cum (inclusive), cum_excl = cum - log w (in place of log w), total =
// cum[L-1]. Starts and ends with the block synchronised.
__device__ __forceinline__ void chunk_cum(const Dims& d, float* CUM, float* CE, float* TOT) {
  __syncthreads();
  for (int n = threadIdx.x; n < d.n; n += blockDim.x) {
    float acc = 0.f;
#pragma unroll 8
    for (int l = 0; l < d.L; ++l) {
      const float lw = CE[l * FP + n];
      acc = __fadd_rn(acc, lw);
      CUM[l * FP + n] = acc;
      CE[l * FP + n] = __fsub_rn(acc, lw);
    }
    TOT[n] = acc;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the diagonal blocks

// one level of the butterfly below: lanes that differ in bit O swap halves
template <int O>
__device__ __forceinline__ void butterfly_level(float* v, int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float lo = v[i], hi = v[i + O];
    v[i] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, O);
  }
}

// v[0..31] of each lane -> v[0] of lane j = the sum over the warp's lanes of
// v[j] (a butterfly: the same order, and so the same bits, every run). Every
// index is a constant, so v stays in registers.
__device__ __forceinline__ void butterfly(float* v) {
  const int lane = threadIdx.x & 31;
  butterfly_level<16>(v, lane);
  butterfly_level<8>(v, lane);
  butterfly_level<4>(v, lane);
  butterfly_level<2>(v, lane);
  butterfly_level<1>(v, lane);
}

// shared memory of a main kernel (the backward's extra tiles when bwd),
// carved in order from base; returns the bytes it takes
template <typename T>
struct Tiles {
  float *cum, *ce;          // [L][FP]
  T *r, *k;                 // [L][rstride<T>()]
  bf16* kh;                 // [2][L][LD]: k e^(c_J - cum), J the row's sub-block
  bf16* v;                  // [XP][L][LD]
  float* A;                 // [nb][kAB]: the diagonal blocks' scores, the bonus on the diagonal
  float* part;              // [nb][N / 32][kPairs]: each warp's pair sums of those
  float *u, *tot;           // [N]
  // backward
  bf16* dy;                 // [XP][L][LD]
  float *q, *rr;            // [L][FP]: the diagonal blocks' Q and R, then dcum_excl and dcum
  float *dA, *du, *dt;      // [nb][kAB] dA's diagonal blocks; [nb][N] du and dtotal partials

  __host__ __device__ __forceinline__ static unsigned char* take(unsigned char* base, size_t& off, size_t bytes) {
    unsigned char* p = reinterpret_cast<unsigned char*>(reinterpret_cast<uintptr_t>(base) + off);
    off += (bytes + 15) / 16 * 16;
    return p;
  }

  __host__ __device__ __forceinline__ size_t carve(unsigned char* base, int L, int n, int xp, bool bwd) {
    size_t off = 0;
    const int nb = L / 16;
    cum = reinterpret_cast<float*>(take(base, off, 4 * L * FP));
    ce = reinterpret_cast<float*>(take(base, off, 4 * L * FP));
    r = reinterpret_cast<T*>(take(base, off, sizeof(T) * L * rstride<T>()));
    k = reinterpret_cast<T*>(take(base, off, sizeof(T) * L * rstride<T>()));
    kh = reinterpret_cast<bf16*>(take(base, off, 2 * 2 * L * LD));
    v = reinterpret_cast<bf16*>(take(base, off, 2 * xp * L * LD));
    A = reinterpret_cast<float*>(take(base, off, 4 * nb * kAB));
    part = reinterpret_cast<float*>(take(base, off, 4 * nb * (n / 32) * kPairs));
    u = reinterpret_cast<float*>(take(base, off, 4 * n));
    tot = reinterpret_cast<float*>(take(base, off, 4 * n));
    if (bwd) {
      dy = reinterpret_cast<bf16*>(take(base, off, 2 * xp * L * LD));
      q = reinterpret_cast<float*>(take(base, off, 4 * L * FP));
      rr = reinterpret_cast<float*>(take(base, off, 4 * L * FP));
      dA = reinterpret_cast<float*>(take(base, off, 4 * nb * kAB));
      du = reinterpret_cast<float*>(take(base, off, 4 * nb * n));
      dt = reinterpret_cast<float*>(take(base, off, 4 * nb * n));
    }
    return off;
  }
};

// The diagonal blocks, a thread per (sub-block, column n): each pair's
// exponential once; the scores' terms r e k (and the bonus r u k) summed over
// the warp's 32 columns by butterflies into t.part. BWD: also Q and R's
// diagonal parts (to t.q, t.rr) and du's partial (t.du) from dA's block.
template <bool BWD, typename T>
__device__ __forceinline__ void diag_blocks(const Tiles<T>& t, const Dims& d) {
  const int lane = threadIdx.x & 31;
  for (int item = threadIdx.x; item < d.nb * d.n; item += blockDim.x) {  // whole warps: nb * N is a multiple of 32
    const int blk = item >> d.lgn, n = item & (d.n - 1), l0 = 16 * blk;
    float cm[16], ce[16], rv[16], kv[16], q[16], rr[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int o = (l0 + i) * FP + n, orr = (l0 + i) * rstride<T>() + n;
      cm[i] = t.cum[o];
      ce[i] = t.ce[o];
      rv[i] = to_f(t.r[orr]);
      kv[i] = to_f(t.k[orr]);
      q[i] = rr[i] = 0.f;
    }
    const float un = t.u[n];
    const float* dA = nullptr;
    if constexpr (BWD) dA = t.dA + blk * kAB;
    float* out = t.part + (blk * (d.n / 32) + n / 32) * kPairs;
    float du = 0.f, part[32];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) {  // a fixed trip count, so that every index below is a constant
        if (j > i) continue;
        const int qi = i * (i + 1) / 2 + j;
        float val;
        if (j < i) {
          const float e = fexp(ce[i] - cm[j]);
          val = rv[i] * e * kv[j];
          if constexpr (BWD) {
            const float da = dA[i * 17 + j];
            q[i] = fmaf(da * kv[j], e, q[i]);
            rr[j] = fmaf(da * rv[i], e, rr[j]);
          }
        } else {
          val = rv[i] * un * kv[i];
          if constexpr (BWD) du = fmaf(dA[i * 17 + i] * rv[i], kv[i], du);
        }
        part[qi & 31] = val;
        if ((qi & 31) == 31 || qi == kPairs - 1) {
#pragma unroll
          for (int s = (qi & 31) + 1; s < 32; ++s) part[s] = 0.f;
          butterfly(part);
          if (lane <= (qi & 31)) out[(qi & ~31) + lane] = part[0];
        }
      }
    if constexpr (BWD) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        t.q[(l0 + i) * FP + n] = q[i];
        t.rr[(l0 + i) * FP + n] = rr[i];
      }
      t.du[blk * d.n + n] = du;
    }
  }
}

// the diagonal blocks' scores: the warps' pair sums added in column order
template <typename T>
__device__ __forceinline__ void sum_parts(const Tiles<T>& t, const Dims& d) {
  const int np = d.n / 32;
  for (int e = threadIdx.x; e < d.nb * 256; e += blockDim.x) {
    const int blk = e >> 8, i = (e >> 4) & 15, j = e & 15;
    float a = 0.f;
    if (j <= i)
      for (int p = 0; p < np; ++p) a += t.part[(blk * np + p) * kPairs + i * (i + 1) / 2 + j];
    t.A[blk * kAB + i * 17 + j] = a;
  }
}

// X (an r or k tile) times e^(ref - cum) into the bf16 tiles hi, lo: ref = total
// (a vector over the columns), or with `to_block` the cum at the last row of
// the row's sub-block of 16 (c_J)
template <typename TX>
__device__ __forceinline__ void stage_decayed(const TX* X, const float* CUM, const float* tot, bool to_block,
                                              const Dims& d, bf16* hi, bf16* lo) {
  for (int e = threadIdx.x; e < d.L * d.n; e += blockDim.x) {
    const int l = e >> d.lgn, n = e & (d.n - 1);
    const float ref = to_block ? CUM[(l | 15) * FP + n] : tot[n];
    split1(to_f(X[l * rstride<TX>() + n]) * fexp(ref - CUM[l * FP + n]), hi[l * LD + n], lo[l * LD + n]);
  }
}

// ---------------------------------------------------------------------------
// the row's scan (the local kernels' last CTA)

// The recurrence S <- e^total[c] (.)rows S + tile[c] of one row (tb holds
// e^total), over V
// elements a thread (a 16-byte vector, or one; all in one row n of the
// N x N tile) and sixteen chunks' loads in flight.
template <int V>
__device__ __forceinline__ void scan_elems(float* __restrict__ base, const float* __restrict__ tb, int n,
                                           const float* __restrict__ init, float* __restrict__ fin, bool backward,
                                           int nc) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  constexpr int kB = 16;  // every chunk's load in flight up to 16 chunks
  const int pn = n * n;
  for (int e = threadIdx.x * V; e < pn; e += blockDim.x * V) {
    const int rn = e / n;
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
          et[u] = __ldcg(tb + (long long)c * n + rn);
        }
      }
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        if (k0 + u >= nc) break;
        const int c = backward ? nc - 1 - (k0 + u) : k0 + u;
        const float f = et[u];
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

// The ticket of a local kernel: once its tile and total are written, every
// CTA of a row takes one; the CTA that draws the last runs the recurrence over
// the row's tiles, in place, each tile replaced by the S that precedes it:
// forward from zero over c = 0 .. nc-1, or backward from init over
// c = nc-1 .. 0, and writes the S after the last to `fin` when not null.
// Resets the counter.
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
  const int pn = d.n * d.n;
  float* base = tiles + (long long)row * d.nc * pn;
  const float* tb = tbuf + (long long)row * d.nc * d.n;
  const float* in = init != nullptr ? init + (long long)row * pn : nullptr;
  float* out = fin != nullptr ? fin + (long long)row * pn : nullptr;
  scan_elems<4>(base, tb, d.n, in, out, backward, d.nc);
  if (threadIdx.x == 0) counters[row] = 0;
}

// ---------------------------------------------------------------------------
// the kernels

// shared memory of the local kernels: cum, cum_excl [L][FP] and X [L][rstride]
// (then the local tile, f32 [N][FP]); X scaled [2][L][LD]; Y [XP][L][LD];
// total [N]
template <typename T>
__host__ __device__ __forceinline__ size_t local_head(int L, int n) {
  const size_t tiles = 4 * (size_t)2 * L * FP + sizeof(T) * (size_t)L * rstride<T>(), out = 4 * (size_t)n * FP;
  return ((tiles > out ? tiles : out) + 15) / 16 * 16;
}
template <typename T>
size_t local_smem(int L, int n) {
  return local_head<T>(L, n) + 2 * 2 * (size_t)L * LD + 2 * parts<T>() * (size_t)L * LD + 4 * (size_t)n;
}

// One (row, chunk) of a local kernel: the local tile X^T . Y, X the chunk's
// k e^(total - cum) (forward) or r e^cum_excl (backward), Y its v or dy;
// total; then the row's scan.
template <typename T, bool BWD>
__device__ __forceinline__ void local_chunk(const T* __restrict__ x, const T* __restrict__ yv,
                                            const float* __restrict__ w, const float* __restrict__ dstate,
                                            float* __restrict__ tiles, float* __restrict__ tbuf,
                                            float* __restrict__ state_out, int* __restrict__ counters, const Dims& d) {
  constexpr int XP = parts<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* CUM = reinterpret_cast<float*>(smem_raw);
  float* CE = CUM + d.L * FP;
  T* XT = reinterpret_cast<T*>(CE + d.L * FP);                             // x [l][rstride]
  float* OUT = CUM;                                                        // then the local tile [n][p]
  bf16* sX = reinterpret_cast<bf16*>(smem_raw + local_head<T>(d.L, d.n));  // [2] [l][n]
  bf16* sY = sX + 2 * d.L * LD;                                            // [XP] [l][p]
  float* TOT = reinterpret_cast<float*>(sY + XP * d.L * LD);

  const int c = blockIdx.x % d.nc, row = blockIdx.x / d.nc, bi = row / d.h, hi = row % d.h;
  const int t0 = c * d.L, valid = min(d.L, d.s - t0);
  const long long tstride = (long long)d.h * d.n;
  const long long base = ((long long)bi * d.s + t0) * tstride + (long long)hi * d.n;  // (bi, t0, hi, 0)
  load_chunk<T>(x + base, nullptr, yv + base, nullptr, w + base, tstride, valid, d, XT, nullptr, sY,
                XP == 2 ? sY + d.L * LD : nullptr, nullptr, nullptr, nullptr, CE);
  chunk_cum(d, CUM, CE, TOT);
  for (int e = threadIdx.x; e < d.L * d.n; e += blockDim.x) {
    const int l = e >> d.lgn, n = e & (d.n - 1);
    const float ex = BWD ? CE[l * FP + n] : TOT[n] - CUM[l * FP + n];
    split1(to_f(XT[l * rstride<T>() + n]) * fexp(ex), sX[l * LD + n], sX[d.L * LD + l * LD + n]);
  }
  __syncthreads();  // cum, cum_excl and X are read: OUT may take their place
  const int r0 = 16 * (threadIdx.x >> 5);
  if (r0 < d.n) {  // rows n of the tile: A = X^T, stored [l][n]; B = Y, stored [l][p]
    float acc[8][4];
    zero<8>(acc);
    const Op oX{sX, sX + d.L * LD}, oY{sY, sY + d.L * LD};
    if (d.n == 64) mma_tile<true, true, 2, XP, 8>(acc, oX, r0, oY, 0, d.L);
    else mma_tile<true, true, 2, XP, 4>(acc, oX, r0, oY, 0, d.L);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cc = frag_col(j, i);
        if (cc < d.n) OUT[(r0 + frag_row(i)) * FP + cc] = acc[j][i];
      }
  }
  for (int n = threadIdx.x; n < d.n; n += blockDim.x) tbuf[((long long)row * d.nc + c) * d.n + n] = expf(TOT[n]);
  __syncthreads();
  float* dst = tiles + ((long long)row * d.nc + c) * d.n * d.n;
  for (int e = threadIdx.x; e < d.n * d.n / 4; e += blockDim.x) {  // 16-byte stores, a row's on neighbouring lanes
    const int rr = e >> (d.lgn - 2), cc = (e & (d.n / 4 - 1)) * 4;
    *reinterpret_cast<float4*>(dst + rr * d.n + cc) = *reinterpret_cast<const float4*>(OUT + rr * FP + cc);
  }
  scan_row(tiles, tbuf, counters, row, BWD ? dstate : nullptr, BWD ? nullptr : state_out, BWD, d);
}

// the forward's: k e^(total - cum) and v; the states entering the chunks and the final state
template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv_fwd_local_kernel(const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ w,
                     float* __restrict__ states, float* __restrict__ tbuf, float* __restrict__ state_out,
                     int* __restrict__ counters, Dims d) {
  local_chunk<T, false>(k, v, w, nullptr, states, tbuf, state_out, counters, d);
}

// the backward's: r e^cum_excl and dy; the cotangents leaving the chunks, from dstate
template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv_bwd_local_kernel(const T* __restrict__ r, const T* __restrict__ dy, const float* __restrict__ w,
                     const float* __restrict__ dstate, float* __restrict__ dws, float* __restrict__ tbuf,
                     int* __restrict__ counters, Dims d) {
  local_chunk<T, true>(r, dy, w, dstate, dws, tbuf, nullptr, counters, d);
}

// y of one (row, chunk) from S_in, the state entering the chunk (the local
// kernel's scan). Warp w: sub-block I = w / wpb, columns c0 .. c0 + 8 NTW.
template <typename T, int NTW>
__global__ void __launch_bounds__(kThreads, 4)
wkv_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ w, const T* __restrict__ u, T* __restrict__ y,
               const float* __restrict__ states, Dims d) {
  constexpr int XP = parts<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tiles<T> t;
  t.carve(smem_raw, d.L, d.n, XP, false);

  const int c = blockIdx.x % d.nc, row = blockIdx.x / d.nc, bi = row / d.h, hi = row % d.h;
  const int t0 = c * d.L, valid = min(d.L, d.s - t0);
  const long long tstride = (long long)d.h * d.n;
  const long long base = ((long long)bi * d.s + t0) * tstride + (long long)hi * d.n;
  const float* S = states + ((long long)row * d.nc + c) * d.n * d.n;  // S_in [n][p], read from L2 into fragments
  load_chunk<T>(r + base, k + base, v + base, nullptr, w + base, tstride, valid, d, t.r, t.k, t.v,
                XP == 2 ? t.v + d.L * LD : nullptr, nullptr, nullptr, nullptr, t.ce);
  for (int n = threadIdx.x; n < d.n; n += blockDim.x) t.u[n] = to_f(u[(long long)hi * d.n + n]);
  chunk_cum(d, t.cum, t.ce, t.tot);
  stage_decayed(t.k, t.cum, t.tot, true, d, t.kh, t.kh + d.L * LD);
  diag_blocks<false>(t, d);
  __syncthreads();
  sum_parts(t, d);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  if (warp >= d.nb * d.wpb) return;
  const int I = warp / d.wpb, c0 = (warp % d.wpb) * 8 * NTW;
  const Op oV{t.v, t.v + d.L * LD}, oKh{t.kh, t.kh + d.L * LD};
  float yacc[NTW][4];
  zero<NTW>(yacc);
  // inter: (r e^cum_excl)_I . S_in
  for (int s = 0; s < d.n; s += 16) {
    uint32_t a[2][4];
    frag_scaled(a, t.r, t.ce, nullptr, 16 * I, s);
    mma_step_f32<true, 2, NTW>(yacc, a, S, d.n, c0, s);  // S_in stored [n][p]
  }
  // the off-diagonal blocks: A_IJ = (r_I e^(cum_excl_I - c_J)) . (k_J e^(c_J - cum_J))^T, then . v_J
  for (int J = 0; J < I; ++J) {
    const float* cJ = t.cum + (16 * J + 15) * FP;
    float sc[2][4];
    zero<2>(sc);
    for (int s = 0; s < d.n; s += 16) {
      uint32_t a[2][4];
      frag_scaled(a, t.r, t.ce, cJ, 16 * I, s);
      mma_step<false, 2, 2, 2>(sc, a, oKh, 16 * J, s);  // k̂_J stored [m][n]
    }
    uint32_t ga[2][4];
    frag_a(sc[0], sc[1], ga);
    mma_step<true, 2, XP, NTW>(yacc, ga, oV, c0, 16 * J);  // v stored [m][p]
  }
  {  // the diagonal block, the bonus on its diagonal
    uint32_t ga[2][4];
    frag_block(ga, t.A + I * kAB, false);
    mma_step<true, 2, XP, NTW>(yacc, ga, oV, c0, 16 * I);
  }
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = 16 * I + frag_row(i), p = c0 + frag_col(j, i);
      if (l < valid) y[base + l * tstride + p] = from_f<T>(yacc[j][i]);
    }
}

// Everything else of one (row, chunk): dr, dk, dv, dw and du's partial, from
// S_prev (the forward's state entering the chunk) and D (the cotangent
// leaving it, the local kernel's scan). Warp w: sub-block I = w / wpb as
// queries and as keys, columns c0 .. c0 + 8 NTW.
template <typename T, int NTW>
__global__ void __launch_bounds__(kThreads, NTW == 8 ? 1 : 3)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ w, const T* __restrict__ u, const T* __restrict__ dy,
               const float* __restrict__ states, const float* __restrict__ dws, T* __restrict__ dr,
               T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du_part, Dims d) {
  constexpr int XP = parts<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tiles<T> t;
  t.carve(smem_raw, d.L, d.n, XP, true);

  const int c = blockIdx.x % d.nc, row = blockIdx.x / d.nc, bi = row / d.h, hi = row % d.h;
  const int t0 = c * d.L, valid = min(d.L, d.s - t0);
  const long long tstride = (long long)d.h * d.n;
  const long long base = ((long long)bi * d.s + t0) * tstride + (long long)hi * d.n;
  const long long tile = ((long long)row * d.nc + c) * d.n * d.n;
  const float* S = states + tile;  // S_prev [n][p], read from L2 into fragments
  const float* D = dws + tile;     // [n][p]
  load_chunk<T>(r + base, k + base, v + base, dy + base, w + base, tstride, valid, d, t.r, t.k, t.v,
                XP == 2 ? t.v + d.L * LD : nullptr, t.dy, XP == 2 ? t.dy + d.L * LD : nullptr, nullptr, t.ce);
  for (int n = threadIdx.x; n < d.n; n += blockDim.x) t.u[n] = to_f(u[(long long)hi * d.n + n]);
  chunk_cum(d, t.cum, t.ce, t.tot);
  stage_decayed(t.k, t.cum, t.tot, true, d, t.kh, t.kh + d.L * LD);

  const int warp = threadIdx.x >> 5;
  const bool active = warp < d.nb * d.wpb;
  const int I = warp / d.wpb, c0 = (warp % d.wpb) * 8 * NTW;
  const Op oV{t.v, t.v + d.L * LD}, oDY{t.dy, t.dy + d.L * LD}, oKh{t.kh, t.kh + d.L * LD};
  if (active && warp % d.wpb == 0) {  // dA's diagonal block: dy_I . v_I^T
    float acc[2][4];
    zero<2>(acc);
    mma_tile<false, false, XP, XP, 2>(acc, oDY, 16 * I, oV, 16 * I, d.n);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) t.dA[I * kAB + frag_row(i) * 17 + frag_col(j, i)] = acc[j][i];
  }
  __syncthreads();
  diag_blocks<true>(t, d);
  __syncthreads();
  sum_parts(t, d);
  __syncthreads();

  if (active) {
    const float* dAI = t.dA + I * kAB;
    {  // queries l in I: g = dy . S_prev^T, Q; dr and dcum_excl
      float gacc[NTW][4], qacc[NTW][4];
      zero<NTW>(gacc);
      zero<NTW>(qacc);
      mma_tile_f32<false, XP, NTW>(gacc, oDY, 16 * I, S, d.n, c0, d.n);  // S_prev stored [n][p]
      for (int J = 0; J < I; ++J) {
        float da[2][4], tmp[NTW][4];
        zero<2>(da);
        zero<NTW>(tmp);
        mma_tile<false, false, XP, XP, 2>(da, oDY, 16 * I, oV, 16 * J, d.n);  // dA_IJ = dy_I . v_J^T
        uint32_t fa[2][4];
        frag_a(da[0], da[1], fa);
        mma_step<true, 2, 2, NTW>(tmp, fa, oKh, c0, 16 * J);  // . k̂_J, stored [m][n]
        const float* cJ = t.cum + (16 * J + 15) * FP;
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int l = 16 * I + frag_row(i), n = c0 + frag_col(j, i);
            qacc[j][i] = fmaf(fexp(t.ce[l * FP + n] - cJ[n]), tmp[j][i], qacc[j][i]);
          }
      }
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int li = frag_row(i), l = 16 * I + li, n = c0 + frag_col(j, i), o = l * FP + n;
          const int orr = l * rstride<T>() + n;
          const float qq = qacc[j][i] + t.q[o];
          const float gq = fexp(t.ce[o]) * gacc[j][i];
          if (l < valid) dr[base + l * tstride + n] = from_f<T>(qq + dAI[li * 17 + li] * t.u[n] * to_f(t.k[orr]) + gq);
          t.q[o] = to_f(t.r[orr]) * (qq + gq);  // dcum_excl
        }
    }
    {  // keys m in I: h = v . D^T, dv, R; dk, dcum and dtotal's partial
      float hacc[NTW][4], dvacc[NTW][4], racc[NTW][4];
      zero<NTW>(hacc);
      zero<NTW>(dvacc);
      zero<NTW>(racc);
      mma_tile_f32<false, XP, NTW>(hacc, oV, 16 * I, D, d.n, c0, d.n);  // D stored [n][p]
      for (int s = 0; s < d.n; s += 16) {  // k e^(total-cum) . D
        uint32_t a[2][4];
        frag_scaled<true>(a, t.k, t.cum, t.tot, 16 * I, s);
        mma_step_f32<true, 2, NTW>(dvacc, a, D, d.n, c0, s);
      }
      {
        uint32_t fa[2][4];
        frag_block(fa, t.A + I * kAB, true);  // A_II^T, the bonus on its diagonal
        mma_step<true, 2, XP, NTW>(dvacc, fa, oDY, c0, 16 * I);
      }
      const float* cJ = t.cum + (16 * I + 15) * FP;  // c_J, this sub-block as the keys'
      for (int Iq = I + 1; Iq < d.nb; ++Iq) {
        float at[2][4], dat[2][4];
        zero<2>(at);
        zero<2>(dat);
        for (int s = 0; s < d.n; s += 16) {  // A_IqJ^T = k̂_J . (r_Iq e^(cum_excl_Iq - c_J))^T
          uint32_t a[2][4], b[2][2][2];
          lda(a[0], oKh.hi, 16 * I, s);
          lda(a[1], oKh.lo, 16 * I, s);
          frag_b_rows(b, t.r, t.ce, cJ, 16 * Iq, s);
#pragma unroll
          for (int tt = 0; tt < 2; ++tt) {
            mma16816(at[tt], a[0], b[0][tt][0], b[0][tt][1]);
            mma16816(at[tt], a[0], b[1][tt][0], b[1][tt][1]);
            mma16816(at[tt], a[1], b[0][tt][0], b[0][tt][1]);
          }
        }
        mma_tile<false, false, XP, XP, 2>(dat, oV, 16 * I, oDY, 16 * Iq, d.n);  // dA_IqJ^T = v_J . dy_Iq^T
        uint32_t fa[2][4];
        frag_a(at[0], at[1], fa);
        mma_step<true, 2, XP, NTW>(dvacc, fa, oDY, c0, 16 * Iq);  // . dy_Iq, stored [l][p]
        frag_a(dat[0], dat[1], fa);
#pragma unroll
        for (int j = 0; j < NTW; ++j) {  // . (r_Iq e^(cum_excl_Iq - c_J))
          uint32_t b[2][2];
          frag_b_cols(b, t.r, t.ce, cJ, 16 * Iq, c0 + 8 * j);
          mma16816(racc[j], fa[0], b[0][0], b[0][1]);
          mma16816(racc[j], fa[0], b[1][0], b[1][1]);
          mma16816(racc[j], fa[1], b[0][0], b[0][1]);
        }
      }
      float dtp[NTW][2];
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        dtp[j][0] = dtp[j][1] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int mi = frag_row(i), m = 16 * I + mi, n = c0 + frag_col(j, i), o = m * FP + n;
          const float kv = to_f(t.k[m * rstride<T>() + n]), rv = to_f(t.r[m * rstride<T>() + n]);
          const float rtot = fmaf(fexp(cJ[n] - t.cum[o]), racc[j][i], t.rr[o]);
          const float ek = fexp(t.tot[n] - t.cum[o]);
          const float kh = kv * ek * hacc[j][i];
          if (m < valid) {
            dk[base + m * tstride + n] = from_f<T>(rtot + dAI[mi * 17 + mi] * t.u[n] * rv + ek * hacc[j][i]);
            dv[base + m * tstride + n] = from_f<T>(dvacc[j][i]);
          }
          t.rr[o] = -kv * rtot - kh;  // dcum
          dtp[j][i & 1] += kh;
        }
      }
      const int lane = threadIdx.x & 31;
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {  // the sum over the sub-block's 16 rows (the lanes' gid bits)
          float s = dtp[j][cc];
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          s += __shfl_xor_sync(0xffffffffu, s, 8);
          s += __shfl_xor_sync(0xffffffffu, s, 16);
          if (lane < 4) t.dt[I * d.n + c0 + 8 * j + 2 * lane + cc] = s;
        }
    }
  }
  __syncthreads();
  // a column a thread: dtotal, then dlog w by a reverse cumsum and dw (w read
  // 16 rows at a time, all in flight); du's partial
  for (int n = threadIdx.x; n < d.n; n += blockDim.x) {
    float dtot = 0.f, du = 0.f, ds = 0.f;
    for (int blk = 0; blk < d.nb; ++blk) {
      dtot += t.dt[blk * d.n + n];
      du += t.du[blk * d.n + n];
    }
#pragma unroll 4
    for (int p = 0; p < d.n; p += 4) {  // D[n][:] . S_prev[n][:], 16-byte loads from L2
      const float4 a = __ldg(reinterpret_cast<const float4*>(D + n * d.n + p));
      const float4 b = __ldg(reinterpret_cast<const float4*>(S + n * d.n + p));
      ds = fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, ds))));
    }
    dtot = fmaf(expf(t.tot[n]), ds, dtot);
    float acc_c = 0.f, acc_e = 0.f;
    for (int l0 = d.L - 16; l0 >= 0; l0 -= 16) {
      float wv[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) wv[i] = l0 + i < valid ? __ldg(w + base + (l0 + i) * tstride + n) : 1.f;
#pragma unroll
      for (int i = 15; i >= 0; --i) {
        const int l = l0 + i;
        acc_c += t.rr[l * FP + n];
        if (l < valid) {
          const float g = acc_c + acc_e + dtot;
          const float q = __fdividef(g, wv[i]);  // within 2 ulp
          dw[base + l * tstride + n] = wv[i] > 1e-30f ? q : (wv[i] == 1e-30f ? 0.5f * q : 0.f);
        }
        acc_e += t.q[l * FP + n];
      }
    }
    du_part[((long long)row * d.nc + c) * d.n + n] = du;
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

bool make_dims(int b, int s, int h, int n, int chunk, Dims* d) {
  if (b < 1 || s < 1 || h < 1 || (n != 32 && n != 64)) return false;
  if (chunk != 16 && chunk != 32 && chunk != 64) return false;
  const long long nc = (s + chunk - 1) / chunk;
  if ((long long)b * h * nc >= (1LL << 31)) return false;
  const int nb = chunk / 16;
  *d = Dims{b, s, h, n, chunk, (int)nc, n == 64 ? 6 : 5, nb, 4 / nb < n / 16 ? 4 / nb : n / 16};
  return true;
}

int ntw(const Dims& d) { return d.n / (8 * d.wpb); }  // 2, 4 or 8

template <typename T>
int fwd_local(const void* k, const void* v, const void* w, void* states, void* tbuf, void* state, void* counters,
              const Dims& d, cudaStream_t st) {
  static size_t opted = 48 * 1024;
  const size_t smem = local_smem<T>(d.L, d.n);
  const cudaError_t ready = allow_smem(wkv_fwd_local_kernel<T>, smem, &opted);
  if (ready != cudaSuccess) return (int)ready;
  wkv_fwd_local_kernel<T><<<d.b * d.h * d.nc, kThreads, smem, st>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(w), static_cast<float*>(states),
      static_cast<float*>(tbuf), static_cast<float*>(state), static_cast<int*>(counters), d);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_local(const void* r, const void* dy, const void* w, const void* dstate, void* dws, void* tbuf,
              void* counters, const Dims& d, cudaStream_t st) {
  static size_t opted = 48 * 1024;
  const size_t smem = local_smem<T>(d.L, d.n);
  const cudaError_t ready = allow_smem(wkv_bwd_local_kernel<T>, smem, &opted);
  if (ready != cudaSuccess) return (int)ready;
  wkv_bwd_local_kernel<T><<<d.b * d.h * d.nc, kThreads, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(dy), static_cast<const float*>(w),
      static_cast<const float*>(dstate), static_cast<float*>(dws), static_cast<float*>(tbuf),
      static_cast<int*>(counters), d);
  return (int)cudaGetLastError();
}

template <typename T, int NTW>
int fwd_main(const void* r, const void* k, const void* v, const void* w, const void* u, void* y, const void* states,
             const Dims& d, cudaStream_t st) {
  static size_t opted = 48 * 1024;
  Tiles<T> t;
  const size_t smem = t.carve(nullptr, d.L, d.n, parts<T>(), false);
  const cudaError_t ready = allow_smem(wkv_fwd_kernel<T, NTW>, smem, &opted);
  if (ready != cudaSuccess) return (int)ready;
  wkv_fwd_kernel<T, NTW><<<d.b * d.h * d.nc, kThreads, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const T*>(u), static_cast<T*>(y), static_cast<const float*>(states), d);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* r, const void* k, const void* v, const void* w, const void* u, void* y, const void* states,
        const Dims& d, cudaStream_t st) {
  switch (ntw(d)) {
    case 2: return fwd_main<T, 2>(r, k, v, w, u, y, states, d, st);
    case 4: return fwd_main<T, 4>(r, k, v, w, u, y, states, d, st);
    case 8: return fwd_main<T, 8>(r, k, v, w, u, y, states, d, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int NTW>
int bwd_main(const void* r, const void* k, const void* v, const void* w, const void* u, const void* dy,
             const void* states, const void* dws, void* dr, void* dk, void* dv, void* dw, void* du_part,
             const Dims& d, cudaStream_t st) {
  static size_t opted = 48 * 1024;
  Tiles<T> t;
  const size_t smem = t.carve(nullptr, d.L, d.n, parts<T>(), true);
  const cudaError_t ready = allow_smem(wkv_bwd_kernel<T, NTW>, smem, &opted);
  if (ready != cudaSuccess) return (int)ready;
  wkv_bwd_kernel<T, NTW><<<d.b * d.h * d.nc, kThreads, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const T*>(u), static_cast<const T*>(dy), static_cast<const float*>(states),
      static_cast<const float*>(dws), static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dw), static_cast<float*>(du_part), d);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* r, const void* k, const void* v, const void* w, const void* u, const void* dy, const void* states,
        const void* dws, void* dr, void* dk, void* dv, void* dw, void* du_part, const Dims& d, cudaStream_t st) {
  switch (ntw(d)) {
    case 2: return bwd_main<T, 2>(r, k, v, w, u, dy, states, dws, dr, dk, dv, dw, du_part, d, st);
    case 4: return bwd_main<T, 4>(r, k, v, w, u, dy, states, dws, dr, dk, dv, dw, du_part, d, st);
    case 8: return bwd_main<T, 8>(r, k, v, w, u, dy, states, dws, dr, dk, dv, dw, du_part, d, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, u, y, dy and the gradients but
// dw); w and the states are float32. r, k, v, w, y: (b, s, h, n) contiguous;
// u: (h, n). Scratch the wrapper owns: tbuf (b * h * nc * n) f32; counters
// (b * h) int32, zero on entry and left zero.

// The forward's first launch: every chunk's local state and total, then each
// row's scan: states (b * h, nc, n, n) = the state entering each chunk;
// state (b, h, n, n) = the final state.
extern "C" int wkv_fwd_local_launch(const void* k, const void* v, const void* w, void* states, void* tbuf,
                                    void* state, void* counters, int b, int s, int h, int n, int chunk, int dtype,
                                    void* stream) {
  Dims d;
  if (!make_dims(b, s, h, n, chunk, &d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd_local<float>(k, v, w, states, tbuf, state, counters, d, st);
  if (dtype == 1) return fwd_local<bf16>(k, v, w, states, tbuf, state, counters, d, st);
  return (int)cudaErrorInvalidValue;
}

// The forward's second launch: y (b, s, h, n) in r's type, from the states
// the first left.
extern "C" int wkv_fwd_launch(const void* r, const void* k, const void* v, const void* w, const void* u, void* y,
                              const void* states, int b, int s, int h, int n, int chunk, int dtype, void* stream) {
  Dims d;
  if (!make_dims(b, s, h, n, chunk, &d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(r, k, v, w, u, y, states, d, st);
  if (dtype == 1) return fwd<bf16>(r, k, v, w, u, y, states, d, st);
  return (int)cudaErrorInvalidValue;
}

// The backward's first launch: dy (b, s, h, n) in r's type and dstate (the
// final state's cotangent, (b, h, n, n) f32, null for zero) to dws (b * h,
// nc, n, n): the cotangent of the state leaving each chunk.
extern "C" int wkv_bwd_local_launch(const void* r, const void* w, const void* dy, const void* dstate, void* dws,
                                    void* tbuf, void* counters, int b, int s, int h, int n, int chunk, int dtype,
                                    void* stream) {
  Dims d;
  if (!make_dims(b, s, h, n, chunk, &d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd_local<float>(r, dy, w, dstate, dws, tbuf, counters, d, st);
  if (dtype == 1) return bwd_local<bf16>(r, dy, w, dstate, dws, tbuf, counters, d, st);
  return (int)cudaErrorInvalidValue;
}

// The backward's second launch: dr, dk, dv (b, s, h, n) in r's type; dw (b, s,
// h, n) f32; du_part (b * h, nc, n) f32, each (row, chunk)'s share of du.
extern "C" int wkv_bwd_launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                              const void* dy, const void* states, const void* dws, void* dr, void* dk, void* dv,
                              void* dw, void* du_part, int b, int s, int h, int n, int chunk, int dtype,
                              void* stream) {
  Dims d;
  if (!make_dims(b, s, h, n, chunk, &d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd<float>(r, k, v, w, u, dy, states, dws, dr, dk, dv, dw, du_part, d, st);
  if (dtype == 1) return bwd<bf16>(r, k, v, w, u, dy, states, dws, dr, dk, dv, dw, du_part, d, st);
  return (int)cudaErrorInvalidValue;
}
