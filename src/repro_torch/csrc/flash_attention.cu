// Flash attention, forward and backward (FlashAttention-2), causal / sliding
// window / GQA, for float32 and bfloat16 with head_dim 64, 80 or 128.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_bhsd (_fa_kernel). The reference has no backward kernel (it
// differentiates the chunked jnp recompute, flash_attention/ops.py:76-83);
// the two backward kernels here are new and compute the gradient of the
// unrounded f32 attention from the saved log-sum-exp.
//
// Layouts are the model's own: q, out, dout (B, Sq, H, D); k, v, dk, dv
// (B, Sk, Hkv, D); lse and delta (B, H, Sq) f32. GQA is an index map: q-head
// h reads kv-head h / (H / Hkv); K and V are never repeated. No padding of D
// or of the sequence: tiles are bounds-checked, keys at or past sk_valid are
// masked and read as zeros (so garbage past the end cannot turn 0 * x into a
// NaN). Masks as in the Pallas body: k < sk_valid, causal k <= q_pos, window
// k > q_pos - window, with q_pos = q_offset + row.
//
// Arithmetic follows the plain version (kernels/flash_attention/ref.py):
// scores, statistics and accumulators in f32; the forward rounds p to v's
// dtype before P.V (kernel.py:69-71) and divides by max(l, 1e-30); the
// backward recomputes p = exp(s - lse) in f32 and does not round it; every
// output is rounded once, at the end. Sums are taken in a fixed order (no
// atomics): dK and dV are reduced over the group's q-heads and q-blocks
// inside one CTA, in order, so every run gives the same bits.
//
// What bounds it on the H100: operations. At the training shape (B 2,
// S 512, 28 heads, D 128, causal) the forward does ~3.8 GFLOP for ~16 MB of
// q, k, v and out. These first kernels use the CUDA cores in f32 (FMA),
// not the tensor cores, so their floor is the 67 TFLOP/s f32 rate, not the
// 989 TFLOP/s bf16 one; wgmma and TMA tiles are later work.
//
// Design: 128 threads as a 16 x 8 grid; a thread owns rows ty + 16 i and
// columns tx + 8 j of every tile, so the 8 threads of a row are 8
// neighbouring lanes and row reductions are 3-step xor butterflies (every
// lane ends with the same bits). Tiles live in shared memory as f32 with
// rows padded by one word, which makes both access patterns conflict-free.
//   forward  : one CTA per (b*h, 64 query rows); walks 32-key blocks from
//              the window's first to the causal diagonal with the online
//              softmax; writes out and lse = m + log(l) (+inf if empty).
//   dQ       : one CTA per (b*h, 64 query rows); computes delta =
//              rowsum(dO*O) (written for the dK/dV kernel), then walks the
//              same key blocks accumulating dS.K.
//   dK / dV  : one CTA per (b, kv-head, 32 keys); loops over the group's
//              q-heads, then the q-blocks that can see these keys, in order,
//              accumulating p^T.dO and dS^T.Q.
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
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }
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

}  // namespace

// head_dim 80 (h2o-danube-1.8b): a thread owns 10 of the tile's columns
// (kTX = 8 divides 80); its tiles need the >48 KB opt-in, as 128's do.
#define FA_DISPATCH(FN, ...)                                                   \
  if (dtype == 0 && d == 64) return FN<float, 64>(__VA_ARGS__);                \
  if (dtype == 0 && d == 80) return FN<float, 80>(__VA_ARGS__);                \
  if (dtype == 0 && d == 128) return FN<float, 128>(__VA_ARGS__);              \
  if (dtype == 1 && d == 64) return FN<__nv_bfloat16, 64>(__VA_ARGS__);        \
  if (dtype == 1 && d == 80) return FN<__nv_bfloat16, 80>(__VA_ARGS__);        \
  if (dtype == 1 && d == 128) return FN<__nv_bfloat16, 128>(__VA_ARGS__);      \
  return (int)cudaErrorInvalidValue;

// dtype: 0 = float32, 1 = bfloat16; d: 64, 80 or 128; window <= 0: none.
// q, out: (b, sq, h, d); k, v: (b, sk, hkv, d); lse: (b, h, sq) f32. All contiguous.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* out, void* lse, int b,
                                          int sq, int sk, int h, int hkv, int d, int causal, int window,
                                          int q_offset, int sk_valid, int dtype, void* stream) {
  if (!shape_ok(b, sq, sk, h, hkv)) return (int)cudaErrorInvalidValue;
  const Shape s = make_shape(sq, sk, h, hkv, causal, window, q_offset, sk_valid);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  FA_DISPATCH(fwd, q, k, v, out, lse, b, s, st)
}

// dq: (b, sq, h, d); delta: (b, h, sq) f32, written here and read by the dK/dV kernel.
extern "C" int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v, const void* out,
                                             const void* dout, const void* lse, void* delta, void* dq, int b,
                                             int sq, int sk, int h, int hkv, int d, int causal, int window,
                                             int q_offset, int sk_valid, int dtype, void* stream) {
  if (!shape_ok(b, sq, sk, h, hkv)) return (int)cudaErrorInvalidValue;
  const Shape s = make_shape(sq, sk, h, hkv, causal, window, q_offset, sk_valid);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  FA_DISPATCH(bwd_dq, q, k, v, out, dout, lse, delta, dq, b, s, st)
}

// dk, dv: (b, sk, hkv, d). Launch after the dQ kernel on the same stream (it reads delta).
extern "C" int flash_attention_bwd_dkdv_launch(const void* q, const void* k, const void* v, const void* dout,
                                               const void* lse, const void* delta, void* dk, void* dv, int b,
                                               int sq, int sk, int h, int hkv, int d, int causal, int window,
                                               int q_offset, int sk_valid, int dtype, void* stream) {
  if (!shape_ok(b, sq, sk, h, hkv)) return (int)cudaErrorInvalidValue;
  const Shape s = make_shape(sq, sk, h, hkv, causal, window, q_offset, sk_valid);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  FA_DISPATCH(bwd_dkdv, q, k, v, dout, lse, delta, dk, dv, b, s, st)
}
