// Mamba2 SSD chunked scan, forward and backward, for float32 and bfloat16
// x/B/C with float32 dt and A, head dims P and state dims N up to 64 and
// chunks of L up to 128 steps.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan/kernel.py::ssd_scan_bh
// (_ssd_kernel). The reference has no backward kernel (it differentiates the
// chunked jnp recompute, ssd_scan/ops.py:52-57); the backward kernel here is
// new and computes the same gradient in closed form.
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
// accurate down to the subnormals it reaches at the end of a long chunk
// (cum near -88 at zamba2's init, dt ~ 0.69, A = -1, L = 128).
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
// GEMM-shaped products (C.B^T, G.xbar, C.S^T, xbar^T.B: 3.2 GFLOP) are
// tensor-core work, so the bound is a few microseconds. This first kernel
// runs them in f32 on the CUDA cores: simple and right first.
//
// Design: one CTA of 512 threads per (b, h) row walks the chunks in order
// (the Pallas grid's sequential chunk axis becomes the CTA's loop) and keeps
// S in shared memory; per chunk the xbar, B and C tiles (L x (dim+1) f32, a
// padded row each) and the L x (L+1) score tile sit in shared memory (~180 KB
// at L 128, P = N = 64). When a gradient is wanted the forward writes the
// state entering each chunk (nc x P x N f32 a row). Thread maps put the
// fastest index on neighbouring lanes and the reused operand on a broadcast,
// so shared-memory reads are conflict-free. Every sum is one thread's loop,
// or a fixed butterfly of shuffles, in a fixed order: no atomics, the same
// bits every run.
//
// Backward (new): one CTA per row walks the chunks in reverse, carrying dS
// (P x N, f32) in shared memory and reading each chunk's starting state
// S_prev from the forward's copy. Per chunk, with dy the cotangent of y:
//   dxbar[m] = sum_{l>=m} G[l][m] dy[l] + e^(T-cum[m]) dS B[m]
//   dx = dxbar dt;   ddt (from xbar) = dxbar . x
//   dCB[l][m] = (dy[l].xbar[m]) e^(cum[l]-cum[m])             (m <= l)
//   dC[l] = sum_{m<=l} dCB[l][m] B[m] + e^cum[l] dy[l] S_prev
//   dB[m] = sum_{l>=m} dCB[l][m] C[l] + e^(T-cum[m]) xbar[m] dS
//   dcum[l] = sum_{m<l} Z[l][m] - sum_{l'>l} Z[l'][l] + e^cum[l] q[l]
//             - e^(T-cum[l]) w[l],   Z = dCB (C.B), q[l] = C[l].(dy[l] S_prev),
//             w[l] = B[l].(xbar[l] dS);  dcum[L-1] += dT,
//   dT = sum_l e^(T-cum[l]) w[l] + e^T (dS : S_prev)
//   ddA[t] = sum_{s>=t} dcum[s];  ddt += a ddA;  da = sum_t ddA[t] dt[t]
//   dS <- e^T dS + sum_l e^cum[l] dy[l]^T C[l]
// The one L x (L+1) tile holds G, then dCB, then Z (C.B recomputed), so the
// backward's tiles (xbar, B, C, dy, the score tile, dS) fit ~215 KB. da is a
// per-row partial and dB, dC per-head partials; the wrapper sums them over
// the batch rows and over the heads of a group in a fixed order.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 64;     // P and N: a lane owns at most two columns in the warp-per-row loops
constexpr int kMaxChunk = 128;  // L: the backward's tiles fill ~215 KB at L 128, P = N = 64
constexpr unsigned kFull = 0xffffffffu;

struct Dims {
  int b, s, h, g, p, n, L, nc;
};

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

// shared memory in floats: the L x (dim+1) tiles, the L x (L+1) score tile,
// the P x (N+1) state tile and the per-step vectors
size_t fwd_smem(int L, int p, int n) {
  return sizeof(float) * (L * (p + 1) + 2 * L * (n + 1) + L * (L + 1) + p * (n + 1) + 5 * L);
}
size_t bwd_smem(int L, int p, int n) {
  return sizeof(float) * (2 * L * (p + 1) + 2 * L * (n + 1) + L * (L + 1) + p * (n + 1) + 9 * L + p);
}

// One chunk's rows t0 .. t0+L-1: xbar = x dt (and dy) into f32 tiles, B and C
// of the row's group, dt and dA = dt a; rows at or past S read as zeros.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ x, const float* __restrict__ dt, float a,
                                           const T* __restrict__ B, const T* __restrict__ C,
                                           const float* __restrict__ dy, float* Xs, float* Bs, float* Cs,
                                           float* DYs, float* DTs, float* DAs, int bi, int hi, int gi, int t0,
                                           const Dims& d) {
  const int P = d.p, N = d.n, PP = P + 1, NP = N + 1;
  for (int e = threadIdx.x; e < d.L * P; e += kThreads) {
    const int l = e / P, p = e % P, t = t0 + l;
    float xv = 0.f, gv = 0.f;
    if (t < d.s) {
      const long long row = ((long long)bi * d.s + t) * d.h + hi;
      xv = to_f(x[row * P + p]) * dt[row];
      if (dy != nullptr) gv = dy[row * P + p];
    }
    Xs[l * PP + p] = xv;
    if (DYs != nullptr) DYs[l * PP + p] = gv;
  }
  for (int e = threadIdx.x; e < d.L * N; e += kThreads) {
    const int l = e / N, n = e % N, t = t0 + l;
    float bv = 0.f, cv = 0.f;
    if (t < d.s) {
      const long long off = (((long long)bi * d.s + t) * d.g + gi) * N + n;
      bv = to_f(B[off]);
      cv = to_f(C[off]);
    }
    Bs[l * NP + n] = bv;
    Cs[l * NP + n] = cv;
  }
  for (int l = threadIdx.x; l < d.L; l += kThreads) {
    const int t = t0 + l;
    const float dv = t < d.s ? dt[((long long)bi * d.s + t) * d.h + hi] : 0.f;
    DTs[l] = dv;
    DAs[l] = dv * a;
  }
}

// cum = inclusive cumsum of dA over the chunk, in order (one thread); then
// e^cum and e^(T - cum), T = cum[L-1].
__device__ __forceinline__ void cumsums(const float* DAs, float* CUM, float* ECUM, float* DEC, int L) {
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      acc += DAs[l];
      CUM[l] = acc;
    }
  }
  __syncthreads();
  const float total = CUM[L - 1];
  for (int l = threadIdx.x; l < L; l += kThreads) {
    ECUM[l] = expf(CUM[l]);
    DEC[l] = expf(total - CUM[l]);
  }
}

// G[l][m] = (sum_n C[l][n] B[m][n]) e^(cum[l] - cum[m]) for m <= l, else 0;
// (l, m) with m on neighbouring lanes.
__device__ __forceinline__ void scores(const float* Cs, const float* Bs, const float* CUM, float* Ms, int L, int N) {
  const int NP = N + 1, LP = L + 1;
  for (int e = threadIdx.x; e < L * L; e += kThreads) {
    const int l = e / L, m = e % L;
    float g = 0.f;
    if (m <= l) {
      const float* cl = Cs + l * NP;
      const float* bm = Bs + m * NP;
      for (int n = 0; n < N; ++n) g = fmaf(cl[n], bm[n], g);
      g *= expf(CUM[l] - CUM[m]);
    }
    Ms[l * LP + m] = g;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
               const T* __restrict__ B, const T* __restrict__ C, float* __restrict__ y,
               float* __restrict__ state_out, float* __restrict__ chunk_states, Dims d) {
  const int P = d.p, N = d.n, L = d.L, PP = P + 1, NP = N + 1, LP = L + 1;
  extern __shared__ float smem[];
  float* Xs = smem;           // [L][P+1] xbar
  float* Bs = Xs + L * PP;    // [L][N+1] B, then B e^(T - cum)
  float* Cs = Bs + L * NP;    // [L][N+1]
  float* Ms = Cs + L * NP;    // [L][L+1] scores G
  float* Ss = Ms + L * LP;    // [P][N+1] state
  float* CUM = Ss + P * NP;
  float* ECUM = CUM + L;
  float* DEC = ECUM + L;
  float* DTs = DEC + L;
  float* DAs = DTs + L;

  const int row = blockIdx.x, bi = row / d.h, hi = row % d.h, gi = hi / (d.h / d.g), tid = threadIdx.x;
  const float a = A[hi];
  for (int e = tid; e < P * NP; e += kThreads) Ss[e] = 0.f;

  for (int c = 0; c < d.nc; ++c) {
    const int t0 = c * L;
    __syncthreads();  // the previous chunk's readers are done with every tile
    load_chunk<T>(x, dt, a, B, C, nullptr, Xs, Bs, Cs, nullptr, DTs, DAs, bi, hi, gi, t0, d);
    if (chunk_states != nullptr) {  // the chunk's starting state, for the backward
      float* out = chunk_states + ((long long)row * d.nc + c) * P * N;
      for (int e = tid; e < P * N; e += kThreads) out[e] = Ss[(e / N) * NP + e % N];
    }
    __syncthreads();
    cumsums(DAs, CUM, ECUM, DEC, L);
    __syncthreads();
    scores(Cs, Bs, CUM, Ms, L, N);
    __syncthreads();
    for (int e = tid; e < L * P; e += kThreads) {  // y (l, p), p on neighbouring lanes
      const int l = e / P, p = e % P, t = t0 + l;
      if (t >= d.s) continue;
      float intra = 0.f, inter = 0.f;
      for (int m = 0; m <= l; ++m) intra = fmaf(Ms[l * LP + m], Xs[m * PP + p], intra);
      for (int n = 0; n < N; ++n) inter = fmaf(Cs[l * NP + n], Ss[p * NP + n], inter);
      y[(((long long)bi * d.s + t) * d.h + hi) * P + p] = fmaf(ECUM[l], inter, intra);
    }
    __syncthreads();
    for (int e = tid; e < L * N; e += kThreads) Bs[(e / N) * NP + e % N] *= DEC[e / N];
    __syncthreads();
    const float eT = expf(CUM[L - 1]);
    for (int e = tid; e < P * N; e += kThreads) {  // S <- e^T S + xbar^T (B e^(T-cum)), n on neighbouring lanes
      const int p = e / N, n = e % N;
      float acc = 0.f;
      for (int l = 0; l < L; ++l) acc = fmaf(Xs[l * PP + p], Bs[l * NP + n], acc);
      Ss[p * NP + n] = fmaf(eT, Ss[p * NP + n], acc);
    }
  }
  __syncthreads();
  float* out = state_out + (long long)row * P * N;
  for (int e = tid; e < P * N; e += kThreads) out[e] = Ss[(e / N) * NP + e % N];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
               const T* __restrict__ B, const T* __restrict__ C, const float* __restrict__ dy,
               const float* __restrict__ chunk_states, const float* __restrict__ dstate, T* __restrict__ dx,
               float* __restrict__ ddt, float* __restrict__ da_part, float* __restrict__ db_part,
               float* __restrict__ dc_part, Dims d) {
  const int P = d.p, N = d.n, L = d.L, PP = P + 1, NP = N + 1, LP = L + 1;
  extern __shared__ float smem[];
  float* Xs = smem;           // [L][P+1] xbar
  float* DYs = Xs + L * PP;   // [L][P+1] dy
  float* Bs = DYs + L * PP;   // [L][N+1]
  float* Cs = Bs + L * NP;    // [L][N+1]
  float* Ms = Cs + L * NP;    // [L][L+1] G, then dCB, then Z
  float* dS = Ms + L * LP;    // [P][N+1] cotangent of the chunk's final state
  float* CUM = dS + P * NP;
  float* ECUM = CUM + L;
  float* DEC = ECUM + L;
  float* DTs = DEC + L;
  float* DAs = DTs + L;
  float* Q = DAs + L;         // q[l] = C[l].(dy[l] S_prev)
  float* W = Q + L;           // w[m] = B[m].(xbar[m] dS)
  float* DDTX = W + L;        // dxbar[m].x[m]
  float* DCUM = DDTX + L;
  float* SSP = DCUM + L;      // [P] sum_n dS[p][n] S_prev[p][n]

  const int row = blockIdx.x, bi = row / d.h, hi = row % d.h, gi = hi / (d.h / d.g), tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const float a = A[hi];
  for (int e = tid; e < P * N; e += kThreads)
    dS[(e / N) * NP + e % N] = dstate != nullptr ? dstate[(long long)row * P * N + e] : 0.f;
  float da_acc = 0.f;  // thread 0's: this row's da, summed over the chunks in reverse order

  for (int c = d.nc - 1; c >= 0; --c) {
    const int t0 = c * L;
    const float* Sp = chunk_states + ((long long)row * d.nc + c) * P * N;
    __syncthreads();
    load_chunk<T>(x, dt, a, B, C, dy, Xs, Bs, Cs, DYs, DTs, DAs, bi, hi, gi, t0, d);
    __syncthreads();
    cumsums(DAs, CUM, ECUM, DEC, L);
    __syncthreads();
    scores(Cs, Bs, CUM, Ms, L, N);
    __syncthreads();
    // dxbar (m, p): a warp per row m, lanes over p; dx and the row's dxbar.x
    for (int m = warp; m < L; m += kWarps) {
      const int t = t0 + m;
      const long long xrow = ((long long)bi * d.s + t) * d.h + hi;
      float part = 0.f;
      for (int p = lane; p < P; p += 32) {
        float acc = 0.f, st = 0.f;
        for (int l = m; l < L; ++l) acc = fmaf(Ms[l * LP + m], DYs[l * PP + p], acc);
        for (int n = 0; n < N; ++n) st = fmaf(Bs[m * NP + n], dS[p * NP + n], st);
        const float g = fmaf(DEC[m], st, acc);
        if (t < d.s) {
          dx[xrow * P + p] = from_f<T>(g * DTs[m]);
          part = fmaf(g, to_f(x[xrow * P + p]), part);
        }
      }
      part = warp_sum(part);
      if (lane == 0) DDTX[m] = part;
    }
    __syncthreads();
    // dCB (l, m), m on neighbouring lanes
    for (int e = tid; e < L * L; e += kThreads) {
      const int l = e / L, m = e % L;
      float g = 0.f;
      if (m <= l) {
        const float* gl = DYs + l * PP;
        const float* xm = Xs + m * PP;
        for (int p = 0; p < P; ++p) g = fmaf(gl[p], xm[p], g);
        g *= expf(CUM[l] - CUM[m]);
      }
      Ms[l * LP + m] = g;
    }
    __syncthreads();
    // dC (l, n): a warp per row l, lanes over n; q[l]
    for (int l = warp; l < L; l += kWarps) {
      const int t = t0 + l;
      float part = 0.f;
      for (int n = lane; n < N; n += 32) {
        float acc = 0.f, gg = 0.f;
        for (int m = 0; m <= l; ++m) acc = fmaf(Ms[l * LP + m], Bs[m * NP + n], acc);
        for (int p = 0; p < P; ++p) gg = fmaf(DYs[l * PP + p], Sp[p * N + n], gg);
        part = fmaf(Cs[l * NP + n], gg, part);
        if (t < d.s) dc_part[(((long long)bi * d.s + t) * d.h + hi) * N + n] = fmaf(ECUM[l], gg, acc);
      }
      part = warp_sum(part);
      if (lane == 0) Q[l] = part;
    }
    // dB (m, n): a warp per row m, lanes over n; w[m]
    for (int m = warp; m < L; m += kWarps) {
      const int t = t0 + m;
      float part = 0.f;
      for (int n = lane; n < N; n += 32) {
        float acc = 0.f, hx = 0.f;
        for (int l = m; l < L; ++l) acc = fmaf(Ms[l * LP + m], Cs[l * NP + n], acc);
        for (int p = 0; p < P; ++p) hx = fmaf(Xs[m * PP + p], dS[p * NP + n], hx);
        part = fmaf(Bs[m * NP + n], hx, part);
        if (t < d.s) db_part[(((long long)bi * d.s + t) * d.h + hi) * N + n] = fmaf(DEC[m], hx, acc);
      }
      part = warp_sum(part);
      if (lane == 0) W[m] = part;
    }
    for (int p = tid; p < P; p += kThreads) {  // dS : S_prev, a row p each
      float acc = 0.f;
      for (int n = 0; n < N; ++n) acc = fmaf(dS[p * NP + n], Sp[p * N + n], acc);
      SSP[p] = acc;
    }
    __syncthreads();
    // Z = dCB (C.B) strictly below the diagonal (its diagonal adds to cum[l] and
    // takes from it again); dS <- e^T dS + sum_l e^cum[l] dy[l]^T C[l]
    for (int e = tid; e < L * L; e += kThreads) {
      const int l = e / L, m = e % L;
      float z = 0.f;
      if (m < l) {
        const float* cl = Cs + l * NP;
        const float* bm = Bs + m * NP;
        float cb = 0.f;
        for (int n = 0; n < N; ++n) cb = fmaf(cl[n], bm[n], cb);
        z = Ms[l * LP + m] * cb;
      }
      Ms[l * LP + m] = z;
    }
    const float eT = expf(CUM[L - 1]);
    for (int e = tid; e < P * N; e += kThreads) {  // (p, n), n on neighbouring lanes
      const int p = e / N, n = e % N;
      float acc = 0.f;
      for (int l = 0; l < L; ++l) acc = fmaf(ECUM[l] * DYs[l * PP + p], Cs[l * NP + n], acc);
      dS[p * NP + n] = fmaf(eT, dS[p * NP + n], acc);
    }
    __syncthreads();
    for (int l = tid; l < L; l += kThreads) {  // dcum[l], a thread each
      float rs = 0.f, cs = 0.f;
      for (int m = 0; m < l; ++m) rs += Ms[l * LP + m];
      for (int k = l + 1; k < L; ++k) cs += Ms[k * LP + l];
      DCUM[l] = fmaf(ECUM[l], Q[l], fmaf(-DEC[l], W[l], rs - cs));
    }
    __syncthreads();
    if (tid == 0) {  // dT into dcum[L-1], then ddA by a reverse cumsum: ddt and da
      float dT = 0.f, ss = 0.f;
      for (int l = 0; l < L; ++l) dT = fmaf(DEC[l], W[l], dT);
      for (int p = 0; p < P; ++p) ss += SSP[p];
      float acc = fmaf(eT, ss, dT);
      for (int l = L - 1; l >= 0; --l) {
        acc += DCUM[l];
        const int t = t0 + l;
        if (t < d.s) ddt[((long long)bi * d.s + t) * d.h + hi] = fmaf(a, acc, DDTX[l]);
        da_acc = fmaf(acc, DTs[l], da_acc);
      }
    }
  }
  if (tid == 0) da_part[row] = da_acc;
}

// Shared memory above 48 KB must be opted into; raised once per kernel to the
// largest size asked for so far.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t* opted) {
  if (bytes <= *opted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *opted = bytes;
  return err;
}

template <typename T>
int fwd(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y, void* state,
        void* chunk_states, const Dims& d, cudaStream_t st) {
  static size_t opted = 48 * 1024;
  const size_t smem = fwd_smem(d.L, d.p, d.n);
  const cudaError_t ready = allow_smem(ssd_fwd_kernel<T>, smem, &opted);
  if (ready != cudaSuccess) return (int)ready;
  ssd_fwd_kernel<T><<<d.b * d.h, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<float*>(y), static_cast<float*>(state),
      static_cast<float*>(chunk_states), d);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const void* dt, const void* A, const void* B, const void* C, const void* dy,
        const void* chunk_states, const void* dstate, void* dx, void* ddt, void* da_part, void* db_part,
        void* dc_part, const Dims& d, cudaStream_t st) {
  static size_t opted = 48 * 1024;
  const size_t smem = bwd_smem(d.L, d.p, d.n);
  const cudaError_t ready = allow_smem(ssd_bwd_kernel<T>, smem, &opted);
  if (ready != cudaSuccess) return (int)ready;
  ssd_bwd_kernel<T><<<d.b * d.h, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<const float*>(dy),
      static_cast<const float*>(chunk_states), static_cast<const float*>(dstate), static_cast<T*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(da_part), static_cast<float*>(db_part),
      static_cast<float*>(dc_part), d);
  return (int)cudaGetLastError();
}

bool make_dims(int b, int s, int h, int g, int p, int n, int chunk, Dims* d) {
  if (b < 1 || s < 1 || h < 1 || g < 1 || h % g != 0) return false;
  if (p < 1 || p > kMaxDim || n < 1 || n > kMaxDim || chunk < 1 || chunk > kMaxChunk) return false;
  if ((long long)b * h >= (1LL << 31)) return false;
  d->b = b;
  d->s = s;
  d->h = h;
  d->g = g;
  d->p = p;
  d->n = n;
  d->L = chunk;
  d->nc = (s + chunk - 1) / chunk;
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C); dt, A, y and the states are float32.
// x, y: (b, s, h, p) contiguous; dt: (b, s, h); A: (h,); B, C: (b, s, g, n);
// state: (b, h, p, n); chunk_states: (b * h, ceil(s / chunk), p, n), written
// when not null.
extern "C" int ssd_fwd_launch(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y,
                              void* state, void* chunk_states, int b, int s, int h, int g, int p, int n, int chunk,
                              int dtype, void* stream) {
  Dims d;
  if (!make_dims(b, s, h, g, p, n, chunk, &d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, dt, A, B, C, y, state, chunk_states, d, st);
  if (dtype == 1) return fwd<__nv_bfloat16>(x, dt, A, B, C, y, state, chunk_states, d, st);
  return (int)cudaErrorInvalidValue;
}

// dy: (b, s, h, p) f32; dstate (the final state's cotangent, (b, h, p, n) f32)
// may be null for zero; dx: (b, s, h, p) in x's type; ddt: (b, s, h) f32;
// da_part: (b * h,) f32, one row's da each; db_part, dc_part: (b, s, h, n)
// f32, each head's share of its group's dB and dC.
extern "C" int ssd_bwd_launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                              const void* dy, const void* chunk_states, const void* dstate, void* dx, void* ddt,
                              void* da_part, void* db_part, void* dc_part, int b, int s, int h, int g, int p, int n,
                              int chunk, int dtype, void* stream) {
  Dims d;
  if (!make_dims(b, s, h, g, p, n, chunk, &d) || chunk_states == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd<float>(x, dt, A, B, C, dy, chunk_states, dstate, dx, ddt, da_part, db_part, dc_part, d, st);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(x, dt, A, B, C, dy, chunk_states, dstate, dx, ddt, da_part, db_part, dc_part, d, st);
  return (int)cudaErrorInvalidValue;
}
