// Flash attention, forward and backward (FlashAttention-2), causal / sliding
// window / GQA, for float32 and bfloat16 with head_dim 64, 80, 128 or 192
// (DeepSeek-V3's MLA: 128 no-RoPE + 64 RoPE columns, v zero-padded from 128
// by the caller, as the reference pads it for its Pallas kernel).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_bhsd (_fa_kernel). The reference has no backward kernel (it
// differentiates the chunked jnp recompute, flash_attention/ops.py:76-83);
// the backward kernels here are new: a dQ pass and a dK/dV pass, the
// deterministic FlashAttention-2 split (no float atomics).
//
// Layouts are the model's own: q, out, dout (B, Sq, H, D); k, v, dk, dv
// (B, Sk, Hkv, D); lse and delta (B, H, Sq) f32. GQA is an index map: q-head
// h reads kv-head h / (H / Hkv); K and V are never repeated. No padding of D
// or of the sequence: tiles are bounds-checked, keys at or past sk_valid are
// masked and read as zeros (so garbage past the end cannot turn 0 * x into a
// NaN). Masks as in the Pallas body: k < sk_valid, causal k <= q_pos, window
// k > q_pos - window, with q_pos = q_offset + row.
//
// The input dtype picks the route, and nothing else does.
//
// bfloat16 (every full-width main path): the Hopper tensor cores.
//   What bounds it on the H100: at S 4096 (B 1, 28 heads over 4, D 128,
//   causal) the operations, 0.12 ms forward at 989 TFLOP/s dense bf16; at
//   the LM slices (S 512) the bytes take a few microseconds and the
//   wrapper's host time and the launch set the floor.
//   Design: 256 threads, two warpgroups of 128; each warpgroup owns 64 rows
//   of every product, which wgmma.mma_async takes with f32 accumulators in
//   registers (m64nNk16: A from shared memory or, for P and dS, from
//   registers; B from shared memory). One thread streams the tiles by TMA
//   (cp.async.bulk.tensor, completion on an mbarrier a stage) into a ring,
//   the next tile in flight while the current one is multiplied (16-byte
//   cp.async copies, issued by every thread, stalled the warps that issued
//   them and left the tensor cores waiting; TMA's 128-byte rows stream
//   several times faster). Tiles are 64-column blocks of 128-byte rows in the
//   128-byte swizzle, read K-major by S = Q K^T and MN-major (transpose
//   flag) by O = P V, with no transposed copy. Head_dim 80 takes two blocks
//   whose columns 80..127 TMA fills with zeros (the shared tile is padded,
//   global memory is not); its products over D stop at column 80.
//   The TMA maps' row extent is sq for Q, dO and sk_valid for K, V, so rows
//   past them arrive as zeros.
//   forward : one CTA per (b h, 128 query rows), the q-blocks in reverse so
//             that the longest causal rows start first; key blocks of 128
//             in a three-stage ring; each warpgroup issues S_j = Q K_j^T
//             and O += P_{j-1} V_{j-1} together and runs block j's online
//             softmax while the second product runs; p rounded to bf16
//             before P V (the Pallas body's rounding point, kernel.py:69-71);
//             out divided by max(l, 1e-30), lse = m + log l (+inf if empty).
//   dQ      : one CTA per (b h, 128 query rows), reversed; delta =
//             rowsum(dO O) (written for the dK/dV pass); key blocks of 64
//             in a two-stage ring: S = Q K^T, dP = dO V^T,
//             dS = p (dP - delta), dQ += dS K.
//   dK / dV : one CTA per (b, kv-head, split of the group's q-heads, 128
//             keys); walks its q-heads, then the 64-row q-blocks that see
//             its keys, in order, through a two-stage ring (Q and dO by TMA,
//             lse and delta by 4-byte cp.async): S^T = K Q^T,
//             dP^T = V dO^T, dV += P^T dO, dK += dS^T Q. The wrapper picks
//             the split from the shape so that qwen2's 7-wide groups fill
//             the card; with more than one split each CTA writes f32
//             partials, and dkdv_sum_kernel, a second grid behind its own
//             entry point (flash_attention_dkdv_sum_launch, counted on its
//             own wrapper), adds them in split order and rounds once.
//   head_dim 192 (three column blocks): the forward walks 64-key blocks (Q
//             and three stages of 128-key K and V would need 336 KB of
//             shared memory), and the dK/dV pass is dkdv_ws_kernel: 64
//             keys a CTA, warpgroup 0 computing P and dV, warpgroup 1 dP,
//             dS (from P handed over in shared memory) and dK, so that a
//             thread holds one 64 x 192 accumulator (96 registers), not two.
//   Rounding: scores, statistics and accumulators in f32; p (forward), P
//   and dS (backward) rounded to bf16 as the tensor cores' operands; each
//   output rounded once. Every sum runs in a fixed order: a second launch
//   gives the same bits.
//
// float32: the CUDA cores, as the port's first kernels did. The tensor
//   cores would take f32 only as TF32 (10-bit mantissa), which cannot meet
//   the f32 bounds against the plain version (1e-5 of max|plain| for the
//   output, 2e-5 for the gradients). 128 threads as a 16 x 8 grid; a thread
//   owns rows ty + 16 i and columns tx + 8 j of every tile, so the 8 threads
//   of a row are 8 neighbouring lanes and row reductions are 3-step xor
//   butterflies. Tiles live in shared memory as f32 with rows padded by one
//   word. The backward recomputes p = exp(s - lse) in f32 and does not
//   round it.
//   forward  : one CTA per (b*h, 64 query rows); walks 32-key blocks from
//              the window's first to the causal diagonal with the online
//              softmax; writes out and lse = m + log(l) (+inf if empty).
//   dQ       : one CTA per (b*h, 64 query rows); computes delta =
//              rowsum(dO*O) (written for the dK/dV kernel), then walks the
//              same key blocks accumulating dS.K.
//   dK / dV  : one CTA per (b, kv-head, 32 keys); loops over the group's
//              q-heads, then the q-blocks that can see these keys, in order,
//              accumulating p^T.dO and dS^T.Q.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTY = 16;
constexpr int kTX = 8;
constexpr int kBQ = 64;  // query rows: per CTA (forward, dQ), per inner tile (dK/dV)
constexpr int kBK = 32;  // key rows: per inner tile (forward, dQ), per CTA (dK/dV)

struct Shape {
  int sq, sk, h, hkv, group;
  int causal, has_window, window, q_offset, sk_valid;
};

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

__device__ __forceinline__ bool visible(int q_pos, int k_pos, const Shape& s) {
  if (k_pos >= s.sk_valid) return false;
  if (s.causal && k_pos > q_pos) return false;
  if (s.has_window && k_pos <= q_pos - s.window) return false;
  return true;
}

// rows [row0, row0 + nrows) of one head of a (B, S, Hx, D) tensor into an
// f32 tile [nrows][D + 1]; rows at or past `limit` read as zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, long long base, long long stride,
                                          int row0, int nrows, int limit) {
  for (int idx = threadIdx.x; idx < nrows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < limit ? to_f(src[base + (long long)row * stride + c]) : 0.f;
  }
}

// The key blocks a query block [q0, q0 + kBQ) needs: [begin, end).
__device__ __forceinline__ void key_range(int q0, const Shape& s, int* begin, int* end) {
  const int q_last = min(q0 + kBQ, s.sq) - 1;
  int e = s.sk_valid;
  if (s.causal) e = min(e, s.q_offset + q_last + 1);
  int b = 0;
  if (s.has_window) b = max(0, s.q_offset + q0 - s.window + 1);
  *begin = (b / kBK) * kBK;
  *end = e;
}

template <int D>
constexpr int fwd_smem() { return (kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1)) * 4; }
template <int D>
constexpr int dq_smem() { return (2 * kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1) + 2 * kBQ) * 4; }
template <int D>
constexpr int dkdv_smem() { return (2 * kBK * (D + 1) + 2 * kBQ * (D + 1) + 2 * kBK * (kBQ + 1) + 2 * kBQ) * 4; }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ lse, Shape s) {
  constexpr int RI = kBQ / kTY, CJ = kBK / kTX, DJ = D / kTX;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * (D + 1);
  float* Vs = Ks + kBK * (D + 1);
  float* Ps = Vs + kBK * (D + 1);

  const int bh = blockIdx.x, q0 = blockIdx.y * kBQ;
  const int b = bh / s.h, h = bh % s.h, hk = h / s.group;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const long long q_stride = (long long)s.h * D, q_base = (long long)b * s.sq * q_stride + (long long)h * D;
  const long long kv_stride = (long long)s.hkv * D, kv_base = (long long)b * s.sk * kv_stride + (long long)hk * D;

  load_tile<T, D>(Qs, q, q_base, q_stride, q0, kBQ, s.sq);
  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  int kbegin, kend;
  key_range(q0, s, &kbegin, &kend);
  for (int k0 = kbegin; k0 < kend; k0 += kBK) {
    __syncthreads();
    load_tile<T, D>(Ks, k, kv_base, kv_stride, k0, kBK, s.sk_valid);
    load_tile<T, D>(Vs, v, kv_base, kv_stride, k0, kBK, s.sk_valid);
    __syncthreads();
    float sc[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + kTY * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Ks[(tx + kTX * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + kTY * i;
      const int q_pos = s.q_offset + q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        if (!visible(q_pos, k0 + tx + kTX * j, s)) sc[i][j] = -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float safe_m = m_new == -INFINITY ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(sc[i][j] - safe_m);
        rs += p;
        Ps[r * (kBK + 1) + tx + kTX * j] = round_to<T>(p);
      }
      const float corr = expf(m[i] - safe_m);
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + kTY * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * (D + 1) + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + kTY * i;
    if (row >= s.sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + q_base + (long long)row * q_stride;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[tx + kTX * j] = from_f<T>(acc[i][j] / denom);
    if (tx == 0) lse[(long long)bh * s.sq + row] = m[i] == -INFINITY ? INFINITY : m[i] + logf(l[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ out, const T* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ delta, T* __restrict__ dq, Shape s) {
  constexpr int RI = kBQ / kTY, CJ = kBK / kTX, DJ = D / kTX;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBQ * (D + 1);
  float* Ks = dOs + kBQ * (D + 1);
  float* Vs = Ks + kBK * (D + 1);
  float* dSs = Vs + kBK * (D + 1);
  float* lse_s = dSs + kBQ * (kBK + 1);
  float* delta_s = lse_s + kBQ;

  const int bh = blockIdx.x, q0 = blockIdx.y * kBQ;
  const int b = bh / s.h, h = bh % s.h, hk = h / s.group;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const long long q_stride = (long long)s.h * D, q_base = (long long)b * s.sq * q_stride + (long long)h * D;
  const long long kv_stride = (long long)s.hkv * D, kv_base = (long long)b * s.sk * kv_stride + (long long)hk * D;

  load_tile<T, D>(Qs, q, q_base, q_stride, q0, kBQ, s.sq);
  load_tile<T, D>(dOs, dout, q_base, q_stride, q0, kBQ, s.sq);
  __syncthreads();
  // delta = rowsum(dO * O), f32; rows past the end get lse = +inf (p = 0)
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + kTY * i, row = q0 + r;
    float part = 0.f;
    if (row < s.sq) {
      const T* o = out + q_base + (long long)row * q_stride;
#pragma unroll
      for (int j = 0; j < DJ; ++j) part = fmaf(dOs[r * (D + 1) + tx + kTX * j], to_f(o[tx + kTX * j]), part);
    }
    part = row_sum(part);
    if (tx == 0) {
      delta_s[r] = part;
      lse_s[r] = row < s.sq ? lse[(long long)bh * s.sq + row] : INFINITY;
      if (row < s.sq) delta[(long long)bh * s.sq + row] = part;
    }
  }
  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  int kbegin, kend;
  key_range(q0, s, &kbegin, &kend);
  for (int k0 = kbegin; k0 < kend; k0 += kBK) {
    __syncthreads();
    load_tile<T, D>(Ks, k, kv_base, kv_stride, k0, kBK, s.sk_valid);
    load_tile<T, D>(Vs, v, kv_base, kv_stride, k0, kBK, s.sk_valid);
    __syncthreads();
    float sc[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[RI], gv[RI], kv[CJ], vv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = Qs[(ty + kTY * i) * (D + 1) + d];
        gv[i] = dOs[(ty + kTY * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        kv[j] = Ks[(tx + kTX * j) * (D + 1) + d];
        vv[j] = Vs[(tx + kTX * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + kTY * i;
      const int q_pos = s.q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + kTX * j;
        const float p = visible(q_pos, k0 + c, s) ? expf(sc[i][j] - lse_s[r]) : 0.f;
        dSs[r * (kBK + 1) + c] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float dsv[RI], kv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = dSs[(ty + kTY * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[kk * (D + 1) + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + kTY * i;
    if (row >= s.sq) continue;
    T* o = dq + q_base + (long long)row * q_stride;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[tx + kTX * j] = from_f<T>(acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                   T* __restrict__ dk, T* __restrict__ dv, Shape s) {
  constexpr int RI = kBK / kTY, CJ = kBQ / kTX, DJ = D / kTX;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * (D + 1);
  float* Qs = Vs + kBK * (D + 1);
  float* dOs = Qs + kBQ * (D + 1);
  float* Pt = dOs + kBQ * (D + 1);
  float* dSt = Pt + kBK * (kBQ + 1);
  float* lse_s = dSt + kBK * (kBQ + 1);
  float* delta_s = lse_s + kBQ;

  const int bk = blockIdx.x, k0 = blockIdx.y * kBK;
  const int b = bk / s.hkv, hk = bk % s.hkv;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const long long q_stride = (long long)s.h * D;
  const long long kv_stride = (long long)s.hkv * D, kv_base = (long long)b * s.sk * kv_stride + (long long)hk * D;

  load_tile<T, D>(Ks, k, kv_base, kv_stride, k0, kBK, s.sk_valid);
  load_tile<T, D>(Vs, v, kv_base, kv_stride, k0, kBK, s.sk_valid);
  float gk[RI][DJ], gv[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) gk[i][j] = gv[i][j] = 0.f;
  // the query rows that can see a key in [k0, k_last]
  const int k_last = min(k0 + kBK, s.sk) - 1;
  int qbegin = 0, qend = s.sq;
  if (s.causal) qbegin = max(0, k0 - s.q_offset);
  if (s.has_window) qend = min(qend, k_last + s.window - s.q_offset);
  if (k0 >= s.sk_valid) qend = 0;
  qbegin = (qbegin / kBQ) * kBQ;
  for (int g = 0; g < s.group; ++g) {
    const int h = hk * s.group + g, bh = b * s.h + h;
    const long long q_base = (long long)b * s.sq * q_stride + (long long)h * D;
    for (int q0 = qbegin; q0 < qend; q0 += kBQ) {
      __syncthreads();
      load_tile<T, D>(Qs, q, q_base, q_stride, q0, kBQ, s.sq);
      load_tile<T, D>(dOs, dout, q_base, q_stride, q0, kBQ, s.sq);
      for (int r = threadIdx.x; r < kBQ; r += kThreads) {
        const int row = q0 + r;
        lse_s[r] = row < s.sq ? lse[(long long)bh * s.sq + row] : INFINITY;
        delta_s[r] = row < s.sq ? delta[(long long)bh * s.sq + row] : 0.f;
      }
      __syncthreads();
      float st[RI][CJ], dpt[RI][CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float kv[RI], vv[RI], qv[CJ], ov[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          kv[i] = Ks[(ty + kTY * i) * (D + 1) + d];
          vv[i] = Vs[(ty + kTY * i) * (D + 1) + d];
        }
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          qv[j] = Qs[(tx + kTX * j) * (D + 1) + d];
          ov[j] = dOs[(tx + kTX * j) * (D + 1) + d];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], ov[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty + kTY * i;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int c = tx + kTX * j;
          const float p = visible(s.q_offset + q0 + c, k0 + r, s) ? expf(st[i][j] - lse_s[c]) : 0.f;
          Pt[r * (kBQ + 1) + c] = p;
          dSt[r * (kBQ + 1) + c] = p * (dpt[i][j] - delta_s[c]);
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int qq = 0; qq < kBQ; ++qq) {
        float pv[RI], sv[RI], ov[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pv[i] = Pt[(ty + kTY * i) * (kBQ + 1) + qq];
          sv[i] = dSt[(ty + kTY * i) * (kBQ + 1) + qq];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          ov[j] = dOs[qq * (D + 1) + tx + kTX * j];
          qv[j] = Qs[qq * (D + 1) + tx + kTX * j];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            gv[i][j] = fmaf(pv[i], ov[j], gv[i][j]);
            gk[i][j] = fmaf(sv[i], qv[j], gk[i][j]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = k0 + ty + kTY * i;
    if (key >= s.sk) continue;
    const long long off = kv_base + (long long)key * kv_stride;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + tx + kTX * j] = from_f<T>(gk[i][j]);
      dv[off + tx + kTX * j] = from_f<T>(gv[i][j]);
    }
  }
}

Shape make_shape(int sq, int sk, int h, int hkv, int causal, int window, int q_offset, int sk_valid) {
  Shape s;
  s.sq = sq;
  s.sk = sk;
  s.h = h;
  s.hkv = hkv;
  s.group = h / hkv;
  s.causal = causal;
  s.has_window = window > 0;
  s.window = window;
  s.q_offset = q_offset;
  s.sk_valid = sk_valid < sk ? sk_valid : sk;
  return s;
}

// Shared memory above 48 KB must be opted into, once per instantiation.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse, int b, const Shape& s, cudaStream_t st) {
  static const cudaError_t ready = allow_smem(fa_fwd_kernel<T, D>, fwd_smem<D>());
  if (ready != cudaSuccess) return (int)ready;
  const dim3 grid(b * s.h, (s.sq + kBQ - 1) / kBQ);
  fa_fwd_kernel<T, D><<<grid, kThreads, fwd_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), s);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* out, const void* dout, const void* lse,
           void* delta, void* dq, int b, const Shape& s, cudaStream_t st) {
  static const cudaError_t ready = allow_smem(fa_bwd_dq_kernel<T, D>, dq_smem<D>());
  if (ready != cudaSuccess) return (int)ready;
  const dim3 grid(b * s.h, (s.sq + kBQ - 1) / kBQ);
  fa_bwd_dq_kernel<T, D><<<grid, kThreads, dq_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(out),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<T*>(dq), s);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
             void* dk, void* dv, int b, const Shape& s, cudaStream_t st) {
  static const cudaError_t ready = allow_smem(fa_bwd_dkdv_kernel<T, D>, dkdv_smem<D>());
  if (ready != cudaSuccess) return (int)ready;
  const dim3 grid(b * s.hkv, (s.sk + kBK - 1) / kBK);
  fa_bwd_dkdv_kernel<T, D><<<grid, kThreads, dkdv_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      s);
  return (int)cudaGetLastError();
}

bool shape_ok(int b, int sq, int sk, int h, int hkv) {
  return b > 0 && sq > 0 && sk > 0 && hkv > 0 && h % hkv == 0 && (long long)b * h < (1LL << 31) &&
         (sq + kBQ - 1) / kBQ <= 65535 && (sk + kBK - 1) / kBK <= 65535;
}


// ---------------------------------------------------------------------------
// bfloat16: the Hopper tensor cores
// ---------------------------------------------------------------------------
namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 256;  // two warpgroups, each owning 64 rows of every product
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared tiles: a tile of R rows x D columns is ceil(D / 64) column blocks,
// each R rows of 128 bytes (64 columns) in the 128-byte swizzle that TMA
// writes and wgmma reads (the 16-byte chunk c of row r at chunk c ^ r % 8).
// Columns past D (head_dim 80's second block) are zero-filled by TMA.
template <int D>
__host__ __device__ constexpr int nblocks() { return (D + 63) / 64; }
template <int R, int D>
__host__ __device__ constexpr int tile_elems() { return R * 64 * nblocks<D>(); }

// wgmma shared-memory matrix descriptor, 128-byte swizzle; `lbo` and `sbo`
// in bytes. The tile bases are 1024-byte aligned (base offset 0).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// Rows [r0, r0 + 64) of an R-row tile as the M or N side of a product over
// its columns (K-major); k_slice(kk) moves to columns [16 kk, 16 kk + 16):
// 32 bytes along a 128-byte row, then the next column block.
template <int R>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int r0) { return make_desc(tile + r0 * 64, 16, 1024); }
template <int R>
__device__ __forceinline__ constexpr uint32_t k_slice(int kk) { return (kk / 4) * (R * 128 / 16) + (kk % 4) * 2; }
// Rows [r0, ...) of an R-row tile as the K side of a product whose N is its
// columns (MN-major, read with the transpose flag): 8-row groups 1024 bytes
// apart, column blocks R * 128 bytes apart; the next 16 rows are +2048 bytes.
template <int R>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int r0) {
  return make_desc(tile + r0 * 64, R * 128, 1024);
}
constexpr uint32_t kMnSlice = 2048 / 16;

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// The accumulators are written by the tensor cores until wgmma_wait: keep
// the compiler from moving a read or write of them across it.
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for register A fragments, which the tensor cores read until
// wgmma_wait: their registers must not be reused before it.
template <int N>
__device__ __forceinline__ void keep(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (64 x N, f32) = (scale_d ? d : 0) + A (64 x 16, shared, K-major) * B (16 x N, shared, K-major)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);
// d (64 x N, f32) += A (64 x 16, bf16 registers) * B (16 x N, shared, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t b);

// Register layouts (per warpgroup of 128 threads; w = warp, l = lane): an
// accumulator element d[4 n + 2 i + j] is row 16 w + l / 4 + 8 i, column
// 8 n + 2 (l % 4) + j; a register A fragment for K columns [16 t, 16 t + 16)
// is the bf16 pairs of d[8 t .. 8 t + 7] of an accumulator over those
// columns, in order.
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39 "
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95 "
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// 2^x on the special-function unit (an input of -inf gives 0; results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// mbarriers: one a ring stage, completed by the bytes of its TMA copies
__device__ __forceinline__ void mbar_init(uint64_t* m) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(m)) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* m, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(m)), "r"(bytes) : "memory");
}
// Wait for the phase of `parity` to complete. Bounded: a copy that never
// lands traps (the launch then reports an error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* m, int parity) {
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(m)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == (1 << 22)) __trap();
  }
}

// One TMA box: columns [col, col + 64) of rows [row, row + R) of one head.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int col, int head, int row, int batch,
                                         uint64_t* m) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(smem_addr(dst)), "l"(map), "r"(col), "r"(head), "r"(row), "r"(batch), "r"(smem_addr(m))
      : "memory");
}
// Rows [row, row + R) of head `head` of batch `b` into an R-row tile, one box a column block.
template <int R, int D>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, int head, int row, int b, uint64_t* m) {
#pragma unroll
  for (int cb = 0; cb < nblocks<D>(); ++cb) tma_load(dst + cb * R * 64, map, cb * 64, head, row, b, m);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// n f32 statistics [row0, row0 + n) of one row of lse or delta (zeros past limit)
__device__ __forceinline__ void load_stats(float* dst, const float* __restrict__ src, int row0, int n, int limit) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int row = row0 + i;
    cp_async4(dst + i, src + (row < limit ? row : 0), row < limit);
  }
}

// The 1024-byte aligned start of the dynamic shared memory (launches ask for 1024 bytes more).
__device__ __forceinline__ bf16* tiles(unsigned char* raw) {
  return reinterpret_cast<bf16*>(raw + (1024 - smem_addr(raw) % 1024) % 1024);
}

// Every (query row, key) pair of [row0, row0 + nrows) x [k0, k0 + nk) visible?
__device__ __forceinline__ bool block_visible(int row0, int nrows, int k0, int nk, const Shape& s) {
  if (k0 + nk > s.sk_valid) return false;
  if (s.causal && k0 + nk - 1 > s.q_offset + row0) return false;
  if (s.has_window && k0 <= s.q_offset + row0 + nrows - 1 - s.window) return false;
  return true;
}

// The keys query rows [q0, q0 + nq) need, from a multiple of bk: [begin, end).
__device__ __forceinline__ void key_span(int q0, int nq, int bk, const Shape& s, int* begin, int* end) {
  const int q_last = min(q0 + nq, s.sq) - 1;
  int e = s.sk_valid;
  if (s.causal) e = min(e, s.q_offset + q_last + 1);
  int b = 0;
  if (s.has_window) b = max(0, s.q_offset + q0 - s.window + 1);
  *begin = (b / bk) * bk;
  *end = e;
}

// The forward's key block: 128 keys, or 64 at head_dim 192, where Q and a
// three-stage ring of 128-key K and V tiles (336 KB) would not fit the 227 KB
// a CTA may hold, and O (96 f32 a thread) beside 128-key scores and P
// fragments would pass the 255 registers a thread.
template <int D>
__host__ __device__ constexpr int fwd_bk() { return D > 128 ? 64 : 128; }
template <int D>
constexpr int fwd_smem() {  // Q, three stages of K and V
  return 1024 + (tile_elems<128, D>() + 6 * tile_elems<fwd_bk<D>(), D>()) * 2;
}
template <int D>
constexpr int dq_smem() {  // Q, dO, two stages of K and V (64 rows), lse, delta
  return 1024 + (2 * tile_elems<128, D>() + 4 * tile_elems<64, D>()) * 2 + 2 * 128 * 4;
}
template <int D>
constexpr int dkdv_smem() {  // K, V, two stages of Q, dO (64 rows), lse, delta
  return 1024 + (2 * tile_elems<128, D>() + 4 * tile_elems<64, D>()) * 2 + 4 * 64 * 4;
}
template <int D>
constexpr int dkdv_ws_smem() {  // K, V (64 rows), two stages of Q, dO (64 rows), lse, delta, P in f32
  return 1024 + 6 * tile_elems<64, D>() * 2 + 4 * 64 * 4 + 32 * 128 * 4;
}
// Every instance fits the 227 KB of shared memory a CTA may opt into (the
// static barriers, a few dozen bytes, come on top).
static_assert(fwd_smem<192>() + 64 <= 232448 && dq_smem<192>() + 64 <= 232448 &&
              dkdv_ws_smem<192>() + 64 <= 232448 && fwd_smem<80>() + 64 <= 232448 && fwd_smem<128>() + 64 <= 232448 &&
              dq_smem<128>() + 64 <= 232448 && dkdv_smem<128>() + 64 <= 232448, "shared memory");

// Forward: one CTA per (b h, 128 query rows), q-blocks in reverse so that the
// longest causal rows start first; warpgroup g owns rows [64 g, 64 g + 64).
// Key blocks of fwd_bk (128; 64 at head_dim 192) stream by TMA through a
// three-stage ring. Each
// warpgroup issues S_j = Q K_j^T and then O += P_{j-1} V_{j-1}, and runs the
// softmax of block j while the second product is on the tensor cores.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, float* __restrict__ lse, Shape s) {
  constexpr int BQ = 128, BK = fwd_bk<D>(), QT = tile_elems<128, D>(), TILE = tile_elems<BK, D>(), STAGE = 2 * TILE;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bar[4];  // the three K/V stages, then Q
  bf16* Qs = tiles(smem_raw);
  bf16* KV = Qs + QT;  // stage st: K at KV + st STAGE, V at KV + st STAGE + TILE

  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = bh / s.h, h = bh % s.h, hk = h / s.group;
  const long long q_stride = (long long)s.h * D, q_base = (long long)b * s.sq * q_stride + (long long)h * D;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int row0 = q0 + 64 * wg, r_lo = row0 + 16 * warp + lane / 4, col = 2 * (lane % 4);

  int kbegin, kend;
  key_span(q0, BQ, BK, s, &kbegin, &kend);
  const int nblk = kend > kbegin ? (kend - kbegin + BK - 1) / BK : 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(&bar[i]);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(&bar[3], QT * 2);
    tma_tile<BQ, D>(Qs, &tq, h, q0, b, &bar[3]);
    if (nblk > 0) {
      mbar_expect(&bar[0], STAGE * 2);
      tma_tile<BK, D>(KV, &tk, hk, kbegin, b, &bar[0]);
      tma_tile<BK, D>(KV + TILE, &tv, hk, kbegin, b, &bar[0]);
    }
  }

  float o[D / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  uint32_t pf[BK / 4];  // P of the previous block, rounded to bf16 as the Pallas body rounds it before P.V
  const uint64_t dq = desc_k<BQ>(Qs, 64 * wg);
  mbar_wait(&bar[3], 0);
  for (int j = 0; j < nblk; ++j) {
    const int k0 = kbegin + j * BK;
    mbar_wait(&bar[j % 3], (j / 3) & 1);
    __syncthreads();  // no warpgroup still reads block j - 2's stage
    if (threadIdx.x == 0 && j + 1 < nblk) {
      bf16* nxt = KV + ((j + 1) % 3) * STAGE;
      mbar_expect(&bar[(j + 1) % 3], STAGE * 2);
      tma_tile<BK, D>(nxt, &tk, hk, k0 + BK, b, &bar[(j + 1) % 3]);
      tma_tile<BK, D>(nxt + TILE, &tv, hk, k0 + BK, b, &bar[(j + 1) % 3]);
    }
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
    const uint64_t dk = desc_k<BK>(KV + (j % 3) * STAGE, 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<BK>(sc, dq + k_slice<BQ>(kk), dk + k_slice<BK>(kk), kk);
    wgmma_commit();
    if (j > 0) {
      const uint64_t dv = desc_mn<BK>(KV + ((j - 1) % 3) * STAGE + TILE, 0);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(o, pf + 4 * kk, dv + kMnSlice * kk);
      wgmma_commit();
      wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} may still run
    } else {
      wgmma_wait<0>();
    }
    keep(sc);
    if (!block_visible(row0, 64, k0, BK, s)) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(s.q_offset + r_lo + 8 * (e / 2), k0 + 8 * n + col + e % 2, s)) sc[4 * n + e] = -INFINITY;
    }
    // online softmax over rows r_lo (i = 0) and r_lo + 8 (i = 1); a row's
    // four threads are neighbouring lanes
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * i], sc[4 * n + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float ms = (mx == -INFINITY ? 0.f : mx) * kLog2e;
      corr[i] = exp2_ftz(fmaf(m[i], kLog2e, -ms));
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float p = exp2_ftz(fmaf(sc[4 * n + 2 * i + jj], kLog2e, -ms));
          sc[4 * n + 2 * i + jj] = p;
          rs += p;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[i] = l[i] * corr[i] + rs;
      m[i] = mx;
    }
    uint32_t pn[BK / 4];
#pragma unroll
    for (int t = 0; t < BK / 4; ++t) pn[t] = pack_bf16(sc[2 * t], sc[2 * t + 1]);
    wgmma_wait<0>();
    keep(o);
    keep(pf);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * n + e] *= corr[e / 2];
#pragma unroll
    for (int t = 0; t < BK / 4; ++t) pf[t] = pn[t];
  }
  if (nblk > 0) {  // the last block's P.V
    wgmma_fence();
    const uint64_t dv = desc_mn<BK>(KV + ((nblk - 1) % 3) * STAGE + TILE, 0);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(o, pf + 4 * kk, dv + kMnSlice * kk);
    wgmma_commit();
    wgmma_wait<0>();
    keep(o);
    keep(pf);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    if (row >= s.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    bf16* orow = out + q_base + (long long)row * q_stride + col;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) = pack_bf16(o[4 * n + 2 * i] / den, o[4 * n + 2 * i + 1] / den);
    if (col == 0) lse[(long long)bh * s.sq + row] = m[i] == -INFINITY ? INFINITY : m[i] + logf(l[i]);
  }
}

// dQ: one CTA per (b h, 128 query rows), q-blocks in reverse; delta =
// rowsum(dO * O) first (written for the dK/dV kernel), then key blocks of 64
// by TMA through a two-stage ring: S = Q K^T and dP = dO V^T on the tensor
// cores, dS = p (dP - delta) rounded to bf16, dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
          const bf16* __restrict__ out, const bf16* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, bf16* __restrict__ dq, Shape s) {
  constexpr int BQ = 128, BK = 64, QT = tile_elems<128, D>(), TILE = tile_elems<64, D>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bar[3];  // the two K/V stages, then Q and dO
  bf16* Qs = tiles(smem_raw);
  bf16* dOs = Qs + QT;
  bf16* KV = dOs + QT;  // stage st: K at KV + 2 st TILE, V after it
  float* lse_s = reinterpret_cast<float*>(KV + 4 * TILE);
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = bh / s.h, h = bh % s.h, hk = h / s.group;
  const long long q_stride = (long long)s.h * D, q_base = (long long)b * s.sq * q_stride + (long long)h * D;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int row0 = q0 + 64 * wg, r_lo = row0 + 16 * warp + lane / 4, col = 2 * (lane % 4);

  int kbegin, kend;
  key_span(q0, BQ, BK, s, &kbegin, &kend);
  const int nblk = kend > kbegin ? (kend - kbegin + BK - 1) / BK : 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i]);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(&bar[2], 2 * QT * 2);
    tma_tile<BQ, D>(Qs, &tq, h, q0, b, &bar[2]);
    tma_tile<BQ, D>(dOs, &tdo, h, q0, b, &bar[2]);
    if (nblk > 0) {
      mbar_expect(&bar[0], 2 * TILE * 2);
      tma_tile<BK, D>(KV, &tk, hk, kbegin, b, &bar[0]);
      tma_tile<BK, D>(KV + TILE, &tv, hk, kbegin, b, &bar[0]);
    }
  }
  {  // delta = rowsum(dO * O) in f32, two threads a row; rows past the end get lse = +inf (p = 0)
    const int r = threadIdx.x / 2, half = threadIdx.x % 2, row = q0 + r;
    float part = 0.f;
    if (row < s.sq) {
      const long long off = q_base + (long long)row * q_stride + half * (D / 2);
#pragma unroll 4
      for (int c = 0; c < D / 2; c += 2) {
        const float2 o2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(out + off + c));
        const float2 g2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + off + c));
        part = fmaf(g2.x, o2.x, part);
        part = fmaf(g2.y, o2.y, part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      delta_s[r] = part;
      lse_s[r] = row < s.sq ? lse[(long long)bh * s.sq + row] : INFINITY;
      if (row < s.sq) delta[(long long)bh * s.sq + row] = part;
    }
  }
  __syncthreads();
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = lse_s[r_lo + 8 * i - q0] * kLog2e;
    dlt[i] = delta_s[r_lo + 8 * i - q0];
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint64_t dQd = desc_k<BQ>(Qs, 64 * wg), dOd = desc_k<BQ>(dOs, 64 * wg);
  mbar_wait(&bar[2], 0);
  for (int j = 0; j < nblk; ++j) {
    const int k0 = kbegin + j * BK;
    mbar_wait(&bar[j & 1], (j >> 1) & 1);
    __syncthreads();  // no warpgroup still reads block j - 1's stage
    if (threadIdx.x == 0 && j + 1 < nblk) {
      bf16* nxt = KV + ((j + 1) & 1) * 2 * TILE;
      mbar_expect(&bar[(j + 1) & 1], 2 * TILE * 2);
      tma_tile<BK, D>(nxt, &tk, hk, k0 + BK, b, &bar[(j + 1) & 1]);
      tma_tile<BK, D>(nxt + TILE, &tv, hk, k0 + BK, b, &bar[(j + 1) & 1]);
    }
    const bf16* Ks = KV + (j & 1) * 2 * TILE;
    float sc[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
    const uint64_t dk = desc_k<BK>(Ks, 0), dv = desc_k<BK>(Ks + TILE, 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<BK>(sc, dQd + k_slice<BQ>(kk), dk + k_slice<BK>(kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<BK>(dp, dOd + k_slice<BQ>(kk), dv + k_slice<BK>(kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    keep(sc);
    keep(dp);
    const bool full = block_visible(row0, 64, k0, BK, s);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const bool vis = full || visible(s.q_offset + r_lo + 8 * i, k0 + 8 * n + col + e % 2, s);
        const float p = vis ? exp2_ftz(fmaf(sc[4 * n + e], kLog2e, -lse2[i])) : 0.f;
        dp[4 * n + e] = p * (dp[4 * n + e] - dlt[i]);
      }
    uint32_t sf[BK / 4];  // dS rounded to bf16 for the tensor cores
#pragma unroll
    for (int t = 0; t < BK / 4; ++t) sf[t] = pack_bf16(dp[2 * t], dp[2 * t + 1]);
    wgmma_fence();
    const uint64_t dkm = desc_mn<BK>(Ks, 0);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(acc, sf + 4 * kk, dkm + kMnSlice * kk);
    wgmma_commit();
    wgmma_wait<0>();
    keep(acc);
    keep(sf);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    if (row >= s.sq) continue;
    bf16* orow = dq + q_base + (long long)row * q_stride + col;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) = pack_bf16(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
  }
}

// dK / dV: one CTA per (b, kv-head, split of its q-heads, 128 keys);
// warpgroup g owns keys [64 g, 64 g + 64). The CTA walks its q-heads, then
// the 64-row q-blocks that can see its keys, in order, through a two-stage
// ring of (Q, dO by TMA; lse, delta by cp.async): S^T = K Q^T and
// dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q with P and dS rounded
// to bf16. One split writes bf16 dK / dV; several write f32 partials that
// dkdv_sum_kernel adds in split order.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
            const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
            bf16* __restrict__ dv, float* __restrict__ part, int nsplit, Shape s) {
  constexpr int BK = 128, BQ = 64, KT = tile_elems<128, D>(), TILE = tile_elems<64, D>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bar[3];  // the two Q/dO stages, then K and V
  bf16* Ks = tiles(smem_raw);
  bf16* Vs = Ks + KT;
  bf16* QO = Vs + KT;  // stage st: Q at QO + 2 st TILE, dO after it
  float* stats = reinterpret_cast<float*>(QO + 4 * TILE);  // stage st: lse at stats + 2 st BQ, delta after it

  const int sp = blockIdx.x % nsplit, bk = blockIdx.x / nsplit, k0 = blockIdx.y * BK;
  const int b = bk / s.hkv, hk = bk % s.hkv;
  const int g0 = sp * s.group / nsplit, g1 = (sp + 1) * s.group / nsplit;
  const long long kv_stride = (long long)s.hkv * D, kv_base = (long long)b * s.sk * kv_stride + (long long)hk * D;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int key0 = k0 + 64 * wg, k_lo = key0 + 16 * warp + lane / 4, col = 2 * (lane % 4);

  // the query rows that can see a key in [k0, k_last]
  const int k_last = min(k0 + BK, s.sk) - 1;
  int qbegin = 0, qend = s.sq;
  if (s.causal) qbegin = max(0, k0 - s.q_offset);
  if (s.has_window) qend = min(qend, k_last + s.window - s.q_offset);
  if (k0 >= s.sk_valid) qend = 0;
  qbegin = (qbegin / BQ) * BQ;
  const int nqb = qend > qbegin ? (qend - qbegin + BQ - 1) / BQ : 0;
  const int total = (g1 - g0) * nqb;

  // step t: q-head hk * group + g0 + t / nqb, rows from qbegin + (t % nqb) BQ, into stage st
  auto issue = [&](int t, int st) {
    const int h = hk * s.group + g0 + t / nqb, qb0 = qbegin + (t % nqb) * BQ;
    if (threadIdx.x == 0) {
      mbar_expect(&bar[st], 2 * TILE * 2);
      tma_tile<BQ, D>(QO + 2 * st * TILE, &tq, h, qb0, b, &bar[st]);
      tma_tile<BQ, D>(QO + (2 * st + 1) * TILE, &tdo, h, qb0, b, &bar[st]);
    }
    const long long row = (long long)(b * s.h + h) * s.sq;
    load_stats(stats + 2 * st * BQ, lse + row, qb0, BQ, s.sq);
    load_stats(stats + (2 * st + 1) * BQ, delta + row, qb0, BQ, s.sq);
    cp_async_commit();
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i]);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(&bar[2], 2 * KT * 2);
    tma_tile<BK, D>(Ks, &tk, hk, k0, b, &bar[2]);
    tma_tile<BK, D>(Vs, &tv, hk, k0, b, &bar[2]);
  }
  if (total > 0) issue(0, 0);

  float gk[D / 2], gv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) gk[i] = gv[i] = 0.f;
  const uint64_t dKd = desc_k<BK>(Ks, 64 * wg), dVd = desc_k<BK>(Vs, 64 * wg);
  mbar_wait(&bar[2], 0);
  for (int t = 0; t < total; ++t) {
    const int st = t & 1, qb0 = qbegin + (t % nqb) * BQ;
    mbar_wait(&bar[st], (t >> 1) & 1);
    cp_async_wait_all();
    __syncthreads();  // this step's statistics have landed; no warpgroup still reads step t - 1's stage
    if (t + 1 < total) issue(t + 1, (t + 1) & 1);
    const bf16* Qt = QO + 2 * st * TILE;
    const bf16* dOt = Qt + TILE;
    const float* lse_t = stats + 2 * st * BQ;
    const float* dl_t = lse_t + BQ;
    float sc[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
    const uint64_t dq = desc_k<BQ>(Qt, 0), ddo = desc_k<BQ>(dOt, 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<BQ>(sc, dKd + k_slice<BK>(kk), dq + k_slice<BQ>(kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<BQ>(dp, dVd + k_slice<BK>(kk), ddo + k_slice<BQ>(kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    keep(sc);
    keep(dp);
    // element (key row, query column c): rows past sq are masked too
    const bool full = qb0 + BQ <= s.sq && block_visible(qb0, BQ, key0, 64, s);
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + col + e % 2, key = k_lo + 8 * (e / 2);
        const bool vis = full || (qb0 + c < s.sq && visible(s.q_offset + qb0 + c, key, s));
        const float p = vis ? exp2_ftz(fmaf(sc[4 * n + e], kLog2e, -lse_t[c] * kLog2e)) : 0.f;
        dp[4 * n + e] = p * (dp[4 * n + e] - dl_t[c]);
        sc[4 * n + e] = p;
      }
    uint32_t pf[BQ / 4], sf[BQ / 4];  // P and dS rounded to bf16 for the tensor cores
#pragma unroll
    for (int t2 = 0; t2 < BQ / 4; ++t2) {
      pf[t2] = pack_bf16(sc[2 * t2], sc[2 * t2 + 1]);
      sf[t2] = pack_bf16(dp[2 * t2], dp[2 * t2 + 1]);
    }
    wgmma_fence();
    const uint64_t dom = desc_mn<BQ>(dOt, 0), dqm = desc_mn<BQ>(Qt, 0);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<D>(gv, pf + 4 * kk, dom + kMnSlice * kk);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<D>(gk, sf + 4 * kk, dqm + kMnSlice * kk);
    wgmma_commit();
    wgmma_wait<0>();
    keep(gv);
    keep(gk);
    keep(pf);
    keep(sf);
  }
  cp_async_wait_all();
  const long long n_el = (long long)(gridDim.x / nsplit) * s.sk * D;  // elements of dk
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k_lo + 8 * i;
    if (key >= s.sk) continue;
    const long long off = kv_base + (long long)key * kv_stride + col;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int e = 4 * n + 2 * i;
      if (nsplit == 1) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * n) = pack_bf16(gk[e], gk[e + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * n) = pack_bf16(gv[e], gv[e + 1]);
      } else {
        *reinterpret_cast<float2*>(part + sp * n_el + off + 8 * n) = make_float2(gk[e], gk[e + 1]);
        *reinterpret_cast<float2*>(part + (nsplit + sp) * n_el + off + 8 * n) = make_float2(gv[e], gv[e + 1]);
      }
    }
  }
}

// dK / dV at head_dim 192. Two 64 x 192 f32 accumulators in one warpgroup
// would take 192 registers a thread before the scores, so the warpgroups
// split the work by output instead of by keys: one CTA per (b, kv-head,
// split of its q-heads, 64 keys), both warpgroups on the same keys.
// Warpgroup 0 computes S^T = K Q^T and P, hands P over in f32 through shared
// memory, and accumulates dV += P^T dO; warpgroup 1 computes dP^T = V dO^T,
// dS = P (dP - delta) from the P it is handed, and accumulates
// dK += dS^T Q. Each element's arithmetic is that of dkdv_kernel; the ring
// of Q, dO and statistics is the same.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_ws_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
               bf16* __restrict__ dv, float* __restrict__ part, int nsplit, Shape s) {
  constexpr int BK = 64, BQ = 64, TILE = tile_elems<64, D>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bar[3];  // the two Q/dO stages, then K and V
  bf16* Ks = tiles(smem_raw);
  bf16* Vs = Ks + TILE;
  bf16* QO = Vs + TILE;  // stage st: Q at QO + 2 st TILE, dO after it
  float* stats = reinterpret_cast<float*>(QO + 4 * TILE);  // stage st: lse at stats + 2 st BQ, delta after it
  float* Pbuf = stats + 4 * BQ;  // P of the current step: element i of thread t at i * 128 + t

  const int sp = blockIdx.x % nsplit, bk = blockIdx.x / nsplit, k0 = blockIdx.y * BK;
  const int b = bk / s.hkv, hk = bk % s.hkv;
  const int g0 = sp * s.group / nsplit, g1 = (sp + 1) * s.group / nsplit;
  const long long kv_stride = (long long)s.hkv * D, kv_base = (long long)b * s.sk * kv_stride + (long long)hk * D;
  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128, warp = t128 / 32, lane = threadIdx.x % 32;
  const int k_lo = k0 + 16 * warp + lane / 4, col = 2 * (lane % 4);

  // the query rows that can see a key in [k0, k_last]
  const int k_last = min(k0 + BK, s.sk) - 1;
  int qbegin = 0, qend = s.sq;
  if (s.causal) qbegin = max(0, k0 - s.q_offset);
  if (s.has_window) qend = min(qend, k_last + s.window - s.q_offset);
  if (k0 >= s.sk_valid) qend = 0;
  qbegin = (qbegin / BQ) * BQ;
  const int nqb = qend > qbegin ? (qend - qbegin + BQ - 1) / BQ : 0;
  const int total = (g1 - g0) * nqb;

  auto issue = [&](int t, int st) {
    const int h = hk * s.group + g0 + t / nqb, qb0 = qbegin + (t % nqb) * BQ;
    if (threadIdx.x == 0) {
      mbar_expect(&bar[st], 2 * TILE * 2);
      tma_tile<BQ, D>(QO + 2 * st * TILE, &tq, h, qb0, b, &bar[st]);
      tma_tile<BQ, D>(QO + (2 * st + 1) * TILE, &tdo, h, qb0, b, &bar[st]);
    }
    const long long row = (long long)(b * s.h + h) * s.sq;
    load_stats(stats + 2 * st * BQ, lse + row, qb0, BQ, s.sq);
    load_stats(stats + (2 * st + 1) * BQ, delta + row, qb0, BQ, s.sq);
    cp_async_commit();
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i]);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(&bar[2], 2 * TILE * 2);
    tma_tile<BK, D>(Ks, &tk, hk, k0, b, &bar[2]);
    tma_tile<BK, D>(Vs, &tv, hk, k0, b, &bar[2]);
  }
  if (total > 0) issue(0, 0);

  float acc[D / 2];  // warpgroup 0: dV; warpgroup 1: dK
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint64_t dA = desc_k<BK>(wg == 0 ? Ks : Vs, 0);
  mbar_wait(&bar[2], 0);
  for (int t = 0; t < total; ++t) {
    const int st = t & 1, qb0 = qbegin + (t % nqb) * BQ;
    mbar_wait(&bar[st], (t >> 1) & 1);
    cp_async_wait_all();
    __syncthreads();  // this step's statistics have landed; nobody still reads step t - 1's stage or P
    if (t + 1 < total) issue(t + 1, (t + 1) & 1);
    const bf16* Qt = QO + 2 * st * TILE;
    const bf16* dOt = Qt + TILE;
    const float* lse_t = stats + 2 * st * BQ;
    const float* dl_t = lse_t + BQ;
    float sc[BQ / 2];  // warpgroup 0: S^T, then P; warpgroup 1: dP^T, then dS
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
    const uint64_t dB = desc_k<BQ>(wg == 0 ? Qt : dOt, 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<BQ>(sc, dA + k_slice<BK>(kk), dB + k_slice<BQ>(kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    keep(sc);
    if (wg == 0) {  // element (key row, query column c): rows past sq are masked too
      const bool full = qb0 + BQ <= s.sq && block_visible(qb0, BQ, k0, BK, s);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + col + e % 2, key = k_lo + 8 * (e / 2);
          const bool vis = full || (qb0 + c < s.sq && visible(s.q_offset + qb0 + c, key, s));
          const float p = vis ? exp2_ftz(fmaf(sc[4 * n + e], kLog2e, -lse_t[c] * kLog2e)) : 0.f;
          sc[4 * n + e] = p;
          Pbuf[(4 * n + e) * 128 + t128] = p;
        }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // P is in shared memory
    if (wg == 1) {
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + col + e % 2;
          sc[4 * n + e] = Pbuf[(4 * n + e) * 128 + t128] * (sc[4 * n + e] - dl_t[c]);
        }
    }
    uint32_t af[BQ / 4];  // P (warpgroup 0) or dS (warpgroup 1) rounded to bf16 for the tensor cores
#pragma unroll
    for (int t2 = 0; t2 < BQ / 4; ++t2) af[t2] = pack_bf16(sc[2 * t2], sc[2 * t2 + 1]);
    wgmma_fence();
    const uint64_t dm = desc_mn<BQ>(wg == 0 ? dOt : Qt, 0);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<D>(acc, af + 4 * kk, dm + kMnSlice * kk);
    wgmma_commit();
    wgmma_wait<0>();
    keep(acc);
    keep(af);
  }
  cp_async_wait_all();
  const long long n_el = (long long)(gridDim.x / nsplit) * s.sk * D;  // elements of dk
  bf16* dst = wg == 0 ? dv : dk;
  float* pdst = part + (wg == 0 ? nsplit + sp : sp) * n_el;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k_lo + 8 * i;
    if (key >= s.sk) continue;
    const long long off = kv_base + (long long)key * kv_stride + col;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int e = 4 * n + 2 * i;
      if (nsplit == 1)
        *reinterpret_cast<uint32_t*>(dst + off + 8 * n) = pack_bf16(acc[e], acc[e + 1]);
      else
        *reinterpret_cast<float2*>(pdst + off + 8 * n) = make_float2(acc[e], acc[e + 1]);
    }
  }
}

// dK, dV = the sum of the splits' f32 partials, in split order, rounded once.
__global__ void __launch_bounds__(256)
dkdv_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dk, bf16* __restrict__ dv, long long n_el,
                int nsplit) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= 2 * n_el) return;
  const bool is_v = i >= n_el;
  const long long e = is_v ? i - n_el : i;
  const float* src = part + (is_v ? nsplit * n_el : 0) + e;
  float4 a = *reinterpret_cast<const float4*>(src);
  for (int sp = 1; sp < nsplit; ++sp) {
    const float4 x = *reinterpret_cast<const float4*>(src + sp * n_el);
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  uint2 w;
  w.x = pack_bf16(a.x, a.y);
  w.y = pack_bf16(a.z, a.w);
  *reinterpret_cast<uint2*>((is_v ? dv : dk) + e) = w;
}

// cuTensorMapEncodeTiled, reached through the runtime's entry-point query (no -lcuda).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// A (b, s, h, d) bf16 tensor as a 4D TMA map {d, h, rows, b}: boxes of 64
// columns (128 bytes, 128-byte swizzle) by box_rows rows of one head. Rows at
// or past `rows` (sq, or sk_valid for K and V) and columns past d read as zeros.
bool make_map(CUtensorMap* map, const void* base, int b, int s, int rows, int h, int d, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)(rows > 0 ? rows : 1), (cuuint64_t)b};
  cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)h * d * 2, (cuuint64_t)s * h * d * 2};
  cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse, int b, const Shape& s, cudaStream_t st) {
  static const cudaError_t ready = allow_smem(fwd_kernel<D>, fwd_smem<D>());
  if (ready != cudaSuccess) return (int)ready;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, b, s.sq, s.sq, s.h, D, 128) ||
      !make_map(&tk, k, b, s.sk, s.sk_valid, s.hkv, D, fwd_bk<D>()) ||
      !make_map(&tv, v, b, s.sk, s.sk_valid, s.hkv, D, fwd_bk<D>()))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(b * s.h, (s.sq + 127) / 128);
  fwd_kernel<D><<<grid, kThreads, fwd_smem<D>(), st>>>(tq, tk, tv, static_cast<bf16*>(out),
                                                        static_cast<float*>(lse), s);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* out, const void* dout, const void* lse,
           void* delta, void* dq, int b, const Shape& s, cudaStream_t st) {
  static const cudaError_t ready = allow_smem(dq_kernel<D>, dq_smem<D>());
  if (ready != cudaSuccess) return (int)ready;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, b, s.sq, s.sq, s.h, D, 128) || !make_map(&tdo, dout, b, s.sq, s.sq, s.h, D, 128) ||
      !make_map(&tk, k, b, s.sk, s.sk_valid, s.hkv, D, 64) || !make_map(&tv, v, b, s.sk, s.sk_valid, s.hkv, D, 64))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(b * s.h, (s.sq + 127) / 128);
  dq_kernel<D><<<grid, kThreads, dq_smem<D>(), st>>>(
      tq, tk, tv, tdo, static_cast<const bf16*>(out), static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq), s);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
             void* dk, void* dv, void* part, int nsplit, int b, const Shape& s, cudaStream_t st) {
  // past D 128 the warpgroups split by output, 64 keys a CTA
  constexpr int bk = D > 128 ? 64 : 128;
  constexpr int smem = D > 128 ? dkdv_ws_smem<D>() : dkdv_smem<D>();
  const auto kernel = [] {
    if constexpr (D > 128) return &dkdv_ws_kernel<D>;
    else return &dkdv_kernel<D>;
  }();
  static const cudaError_t ready = allow_smem(kernel, smem);
  if (ready != cudaSuccess) return (int)ready;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, b, s.sq, s.sq, s.h, D, 64) || !make_map(&tdo, dout, b, s.sq, s.sq, s.h, D, 64) ||
      !make_map(&tk, k, b, s.sk, s.sk_valid, s.hkv, D, bk) || !make_map(&tv, v, b, s.sk, s.sk_valid, s.hkv, D, bk))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(b * s.hkv * nsplit, (s.sk + bk - 1) / bk);
  kernel<<<grid, kThreads, smem, st>>>(tq, tk, tv, tdo, static_cast<const float*>(lse),
                                       static_cast<const float*>(delta), static_cast<bf16*>(dk),
                                       static_cast<bf16*>(dv), static_cast<float*>(part), nsplit, s);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype 0 (float32) runs the CUDA-core kernels, dtype 1 (bfloat16) the tensor-core ones.
#define FA_HEAD_DIM(CALL)                \
  switch (d) {                           \
    case 64: return CALL(64);            \
    case 80: return CALL(80);            \
    case 128: return CALL(128);          \
    case 192: return CALL(192);          \
    default: return (int)cudaErrorInvalidValue; \
  }

// dtype: 0 = float32, 1 = bfloat16; d: 64, 80, 128 or 192; window <= 0: none.
// q, out: (b, sq, h, d); k, v: (b, sk, hkv, d); lse: (b, h, sq) f32. All contiguous, 16-byte aligned.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* out, void* lse, int b,
                                          int sq, int sk, int h, int hkv, int d, int causal, int window,
                                          int q_offset, int sk_valid, int dtype, void* stream) {
  if (!shape_ok(b, sq, sk, h, hkv) || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  const Shape s = make_shape(sq, sk, h, hkv, causal, window, q_offset, sk_valid);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define F32(D) fwd<float, D>(q, k, v, out, lse, b, s, st)
#define BF16(D) tc::fwd<D>(q, k, v, out, lse, b, s, st)
  if (dtype == 0) FA_HEAD_DIM(F32)
  FA_HEAD_DIM(BF16)
#undef F32
#undef BF16
}

// dq: (b, sq, h, d); delta: (b, h, sq) f32, written here and read by the dK/dV kernel.
extern "C" int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v, const void* out,
                                             const void* dout, const void* lse, void* delta, void* dq, int b,
                                             int sq, int sk, int h, int hkv, int d, int causal, int window,
                                             int q_offset, int sk_valid, int dtype, void* stream) {
  if (!shape_ok(b, sq, sk, h, hkv) || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  const Shape s = make_shape(sq, sk, h, hkv, causal, window, q_offset, sk_valid);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define F32(D) bwd_dq<float, D>(q, k, v, out, dout, lse, delta, dq, b, s, st)
#define BF16(D) tc::bwd_dq<D>(q, k, v, out, dout, lse, delta, dq, b, s, st)
  if (dtype == 0) FA_HEAD_DIM(F32)
  FA_HEAD_DIM(BF16)
#undef F32
#undef BF16
}

// dk, dv: (b, sk, hkv, d). Launch after the dQ kernel on the same stream (it reads delta).
// bf16 only: nsplit (1 ..= h / hkv) CTAs share each kv-head's group of q-heads; with
// nsplit > 1 they write f32 partials to part, 2 * nsplit * b * sk * hkv * d elements,
// and leave dk and dv to flash_attention_dkdv_sum_launch.
extern "C" int flash_attention_bwd_dkdv_launch(const void* q, const void* k, const void* v, const void* dout,
                                               const void* lse, const void* delta, void* dk, void* dv, int b,
                                               int sq, int sk, int h, int hkv, int d, int causal, int window,
                                               int q_offset, int sk_valid, int dtype, void* part, int nsplit,
                                               void* stream) {
  if (!shape_ok(b, sq, sk, h, hkv) || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (nsplit < 1 || nsplit > h / hkv || (nsplit > 1 && part == nullptr) ||
                     (long long)b * hkv * nsplit >= (1LL << 31)))
    return (int)cudaErrorInvalidValue;
  const Shape s = make_shape(sq, sk, h, hkv, causal, window, q_offset, sk_valid);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define F32(D) bwd_dkdv<float, D>(q, k, v, dout, lse, delta, dk, dv, b, s, st)
#define BF16(D) tc::bwd_dkdv<D>(q, k, v, dout, lse, delta, dk, dv, part, nsplit, b, s, st)
  if (dtype == 0) FA_HEAD_DIM(F32)
  FA_HEAD_DIM(BF16)
#undef F32
#undef BF16
}

// dk, dv (bf16) = the sum of the dK/dV kernel's nsplit f32 partials in split order, rounded once.
// part: (2, nsplit, n_el) f32, dK's partials then dV's; n_el = b * sk * hkv * d, a multiple of 4.
// Launch after the dK/dV kernel that wrote part, on the same stream.
extern "C" int flash_attention_dkdv_sum_launch(const void* part, void* dk, void* dv, long long n_el, int nsplit,
                                               void* stream) {
  if (n_el <= 0 || n_el % 4 || nsplit < 2 || (2 * n_el / 4 + 255) / 256 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (2 * n_el / 4 + 255) / 256;
  tc::dkdv_sum_kernel<<<(unsigned)blocks, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<tc::bf16*>(dk), static_cast<tc::bf16*>(dv), n_el, nsplit);
  return (int)cudaGetLastError();
}
