// RWKV-6 chunked WKV recurrence, forward and backward, for float32 and
// bfloat16 r/k/v/u with float32 decays w, head dims N = P in {32, 64} and
// chunks of L in {16, 32, 64} steps.
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_wkv/kernel.py::wkv_bh
// (_wkv_kernel). The reference has no backward kernel (it differentiates the
// chunked jnp recompute, rwkv6_wkv/ops.py:43-50); the backward kernel here is
// new and computes the same gradient in closed form.
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
// wkv_chunked, op for op up to the order of sums). Every exponent is <= 0
// (cum_excl[l] - cum[m] for m < l, total - cum, cum_excl), so nothing
// overflows however strong the decay: the pairwise exponential is never
// factored into r e^cum_excl times k e^-cum.
//
// Layouts are the model's own: r, k, v, w, y and the gradients (B, S, H, N),
// u (H, N); no transpose to (B*H, S, N) and no padding of S to whole
// chunks: the last chunk is bounds-checked, rows past S read as r = k = v = 0,
// w = 1 (as the reference pads) and write nothing.
//
// What bounds it on the H100: operations. Per chunk the scores take
// L(L-1)/2 * N exponentials on the SFU (16 a clock per SM) and about as many
// f32 FMAs again for A.v, the state product and the state update; the bytes
// (r, k, v, u, y in the input type, w and the state in f32) are read or
// written once. At the training shape (B 2, S 512, H 64, N 64, L 32) that is
// ~1.5 GFLOP and ~78 M exponentials against ~36 MB.
//
// Design: one CTA of 512 threads per (b, h) row walks the chunks in order
// (the Pallas grid's sequential chunk axis becomes the CTA's loop) and keeps
// S in shared memory. Per chunk the tiles (r, k, v, cum, cum_excl, each
// L x N f32 with rows padded by one word) and A sit in shared memory; the
// (L, L, N) decay tensor is never formed (256 KB in f32 at L 32, N 64, more
// than a CTA's 227 KB): each A[l][m] is one thread's loop over n. Thread
// maps put the fastest index on neighbouring lanes and the reused operand on
// a broadcast, so shared-memory reads are conflict-free. Every sum is one
// thread's loop in a fixed order: no atomics, the same bits every run.
//
// Backward (new): one CTA per row walks the chunks in reverse, carrying dS
// (N x P, f32) in shared memory; the chunks' starting states come from the
// forward, which writes them when a gradient is wanted (nc x N x P f32 per
// row). Per chunk, with dA[l][m] = dy[l].v[m] (its diagonal dD[l] the
// bonus's cotangent):
//   dv[m]  = sum_{l>=m} A[l][m] dy[l] + sum_n k[m][n] e^(total-cum[m][n]) dS[n][:]
//   Q[l][n] = sum_{m<l} dA[l][m] k[m][n] e^(cum_excl[l][n]-cum[m][n]),
//   R[m][n] = sum_{l>m} dA[l][m] r[l][n] e^(cum_excl[l][n]-cum[m][n]),
//   g[l][n] = dy[l].S_prev[n][:],  h[m][n] = dS[n][:].v[m]
//   dr = Q + dD u k + g e^cum_excl;  dk = R + dD u r + h e^(total-cum)
//   du[n] = sum_l dD[l] r[l][n] k[l][n]   (per row; the wrapper sums over b)
//   dcum_excl = r (Q + g e^cum_excl);  dcum = -k R - h k e^(total-cum)
//   dtotal[n] = sum_m h k e^(total-cum) + e^total[n] dS[n][:].S_prev[n][:]
//   dlogw[t] = sum_{s>=t} dcum[s] + sum_{s>t} dcum_excl[s] + dtotal
//   dw = dlogw / w where w > 1e-30, else 0 (jnp.maximum's gradient at a tie
//        is one half; no real input reaches 1e-30)
//   dS <- e^total dS + sum_l (r[l] e^cum_excl[l])^T dy[l]
// The pairwise exponentials are recomputed in each of the three passes that
// reduce them over a different index (A over n, Q over m, R over l), so each
// of those sums stays one thread's ordered loop.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxDim = 64;  // N = P and L at most 64: the backward's tiles fill ~217 KB at 64/64

struct Dims {
  int b, s, h, n, L, nc;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

// shared memory in floats: L x (N+1) tiles, the L x (L+1) score tiles, the
// N x (N+1) state tiles and per-column vectors
size_t fwd_smem(int L, int n) { return sizeof(float) * (5 * L * (n + 1) + L * (L + 1) + n * (n + 1) + 3 * n); }
size_t bwd_smem(int L, int n) {
  return sizeof(float) * (9 * L * (n + 1) + 2 * L * (L + 1) + 2 * n * (n + 1) + 4 * n);
}

// Loads one chunk's rows t0 .. t0+L-1 of r, k, v (and dy) into f32 tiles and
// log(max(w, 1e-30)) into LW; rows at or past S read as zeros, log w as 0.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                                           const float* __restrict__ w, const T* __restrict__ dy, float* Rs,
                                           float* Ks, float* Vs, float* DYs, float* LW, long long base,
                                           long long tstride, int t0, const Dims& d) {
  const int N = d.n, NP = N + 1;
  for (int e = threadIdx.x; e < d.L * N; e += kThreads) {
    const int l = e / N, n = e % N, t = t0 + l;
    float rv = 0.f, kv = 0.f, vv = 0.f, gv = 0.f, lw = 0.f;
    if (t < d.s) {
      const long long off = base + (long long)t * tstride + n;
      rv = to_f(r[off]);
      kv = to_f(k[off]);
      vv = to_f(v[off]);
      lw = logf(fmaxf(w[off], 1e-30f));
      if (dy != nullptr) gv = to_f(dy[off]);
    }
    Rs[l * NP + n] = rv;
    Ks[l * NP + n] = kv;
    Vs[l * NP + n] = vv;
    LW[l * NP + n] = lw;
    if (DYs != nullptr) DYs[l * NP + n] = gv;
  }
}

// Column n's inclusive cumsum over the chunk, in order: C = cum, CE (holding
// log w on entry) = cum_excl; Ts = total, eTs = e^total.
__device__ __forceinline__ void cumsums(float* Cs, float* CEs, float* Ts, float* eTs, const Dims& d) {
  const int NP = d.n + 1;
  for (int n = threadIdx.x; n < d.n; n += kThreads) {
    float acc = 0.f;
    for (int l = 0; l < d.L; ++l) {
      const float lw = CEs[l * NP + n];
      acc += lw;
      Cs[l * NP + n] = acc;
      CEs[l * NP + n] = acc - lw;
    }
    Ts[n] = acc;
    eTs[n] = expf(acc);
  }
}

// A[l][m] = sum_n r[l][n] e^(cum_excl[l][n] - cum[m][n]) k[m][n] for m < l;
// the bonus sum_n r[l][n] u[n] k[l][n] on the diagonal; 0 above it.
__device__ __forceinline__ float score(const float* Rs, const float* Ks, const float* Cs, const float* CEs,
                                       const float* Us, int l, int m, int N) {
  const int NP = N + 1;
  const float* rl = Rs + l * NP;
  float a = 0.f;
  if (m < l) {
    const float* cel = CEs + l * NP;
    const float* cm = Cs + m * NP;
    const float* km = Ks + m * NP;
    for (int n = 0; n < N; ++n) a = fmaf(rl[n] * expf(cel[n] - cm[n]), km[n], a);
  } else if (m == l) {
    const float* kl = Ks + l * NP;
    for (int n = 0; n < N; ++n) a = fmaf(rl[n] * Us[n], kl[n], a);
  }
  return a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ w, const T* __restrict__ u, T* __restrict__ y,
               float* __restrict__ state_out, float* __restrict__ chunk_states, Dims d) {
  const int N = d.n, L = d.L, NP = N + 1, LP = L + 1;
  extern __shared__ float smem[];
  float* Rs = smem;             // r, then r e^cum_excl
  float* Ks = Rs + L * NP;      // k, then k e^(total - cum)
  float* Vs = Ks + L * NP;
  float* Cs = Vs + L * NP;      // cum
  float* CEs = Cs + L * NP;     // log w, then cum_excl
  float* As = CEs + L * NP;     // [L][L+1] scores, the bonus on the diagonal
  float* Ss = As + L * LP;      // [N][N+1] state
  float* Ts = Ss + N * NP;
  float* eTs = Ts + N;
  float* Us = eTs + N;

  const int row = blockIdx.x, bi = row / d.h, hi = row % d.h, tid = threadIdx.x;
  const long long tstride = (long long)d.h * N;
  const long long base = (long long)bi * d.s * tstride + (long long)hi * N;
  for (int e = tid; e < N * NP; e += kThreads) Ss[e] = 0.f;
  for (int n = tid; n < N; n += kThreads) Us[n] = to_f(u[(long long)hi * N + n]);

  for (int c = 0; c < d.nc; ++c) {
    const int t0 = c * L;
    __syncthreads();  // the previous chunk's readers are done with every tile
    load_chunk<T>(r, k, v, w, nullptr, Rs, Ks, Vs, nullptr, CEs, base, tstride, t0, d);
    if (chunk_states != nullptr) {  // the chunk's starting state, for the backward
      float* out = chunk_states + ((long long)row * d.nc + c) * N * N;
      for (int e = tid; e < N * N; e += kThreads) out[e] = Ss[(e / N) * NP + e % N];
    }
    __syncthreads();
    cumsums(Cs, CEs, Ts, eTs, d);
    __syncthreads();
    for (int e = tid; e < L * L; e += kThreads) {  // (l, m), m on neighbouring lanes
      const int l = e / L, m = e % L;
      As[l * LP + m] = score(Rs, Ks, Cs, CEs, Us, l, m, N);
    }
    __syncthreads();
    for (int e = tid; e < L * N; e += kThreads) {
      const int l = e / N, n = e % N;
      Rs[l * NP + n] *= expf(CEs[l * NP + n]);
      Ks[l * NP + n] *= expf(Ts[n] - Cs[l * NP + n]);
    }
    __syncthreads();
    for (int e = tid; e < L * N; e += kThreads) {  // y (l, p), p on neighbouring lanes
      const int l = e / N, p = e % N, t = t0 + l;
      if (t >= d.s) continue;
      float intra = 0.f, inter = 0.f;
      for (int m = 0; m <= l; ++m) intra = fmaf(As[l * LP + m], Vs[m * NP + p], intra);
      for (int n = 0; n < N; ++n) inter = fmaf(Rs[l * NP + n], Ss[n * NP + p], inter);
      y[base + (long long)t * tstride + p] = from_f<T>(intra + inter);
    }
    __syncthreads();
    for (int e = tid; e < N * N; e += kThreads) {  // S <- e^total S + (k e^(total-cum))^T v
      const int n = e / N, p = e % N;
      float acc = 0.f;
      for (int l = 0; l < L; ++l) acc = fmaf(Ks[l * NP + n], Vs[l * NP + p], acc);
      Ss[n * NP + p] = fmaf(eTs[n], Ss[n * NP + p], acc);
    }
  }
  __syncthreads();
  float* out = state_out + (long long)row * N * N;
  for (int e = tid; e < N * N; e += kThreads) out[e] = Ss[(e / N) * NP + e % N];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ w, const T* __restrict__ u, const T* __restrict__ dy,
               const float* __restrict__ chunk_states, const float* __restrict__ dstate, T* __restrict__ dr,
               T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du_part,
               Dims d) {
  const int N = d.n, L = d.L, NP = N + 1, LP = L + 1;
  extern __shared__ float smem[];
  float* Rs = smem;             // r, then r e^cum_excl
  float* Ks = Rs + L * NP;
  float* Vs = Ks + L * NP;
  float* DYs = Vs + L * NP;
  float* Cs = DYs + L * NP;     // cum
  float* CEs = Cs + L * NP;     // log w, then cum_excl
  float* KDs = CEs + L * NP;    // k e^(total - cum), then h k e^(total - cum)
  float* DCs = KDs + L * NP;    // dcum
  float* DCEs = DCs + L * NP;   // dcum_excl
  float* As = DCEs + L * NP;    // [L][L+1] scores, the bonus on the diagonal
  float* dAs = As + L * LP;     // [L][L+1] dA, dD on the diagonal
  float* Sp = dAs + L * LP;     // [N][N+1] the chunk's starting state
  float* dS = Sp + N * NP;      // [N][N+1] cotangent of the chunk's final state
  float* Ts = dS + N * NP;
  float* eTs = Ts + N;
  float* Us = eTs + N;
  float* dUs = Us + N;          // this row's du, summed over the chunks in reverse order

  const int row = blockIdx.x, bi = row / d.h, hi = row % d.h, tid = threadIdx.x;
  const long long tstride = (long long)d.h * N;
  const long long base = (long long)bi * d.s * tstride + (long long)hi * N;
  for (int e = tid; e < N * N; e += kThreads)
    dS[(e / N) * NP + e % N] = dstate != nullptr ? dstate[(long long)row * N * N + e] : 0.f;
  for (int n = tid; n < N; n += kThreads) {
    Us[n] = to_f(u[(long long)hi * N + n]);
    dUs[n] = 0.f;
  }

  for (int c = d.nc - 1; c >= 0; --c) {
    const int t0 = c * L;
    __syncthreads();
    load_chunk<T>(r, k, v, w, dy, Rs, Ks, Vs, DYs, CEs, base, tstride, t0, d);
    const float* sp = chunk_states + ((long long)row * d.nc + c) * N * N;
    for (int e = tid; e < N * N; e += kThreads) Sp[(e / N) * NP + e % N] = sp[e];
    __syncthreads();
    cumsums(Cs, CEs, Ts, eTs, d);
    for (int n = tid; n < N; n += kThreads)  // the same thread as the column's cumsum
      for (int l = 0; l < L; ++l) KDs[l * NP + n] = Ks[l * NP + n] * expf(Ts[n] - Cs[l * NP + n]);
    __syncthreads();
    for (int e = tid; e < L * L; e += kThreads) {  // A and dA (l, m), m on neighbouring lanes
      const int l = e / L, m = e % L;
      As[l * LP + m] = score(Rs, Ks, Cs, CEs, Us, l, m, N);
      float da = 0.f;
      if (m <= l)
        for (int p = 0; p < N; ++p) da = fmaf(DYs[l * NP + p], Vs[m * NP + p], da);
      dAs[l * LP + m] = da;
    }
    __syncthreads();
    for (int e = tid; e < L * N; e += kThreads) {  // dv (m, p), p on neighbouring lanes
      const int m = e / N, p = e % N, t = t0 + m;
      if (t >= d.s) continue;
      float acc = 0.f;
      for (int l = m; l < L; ++l) acc = fmaf(As[l * LP + m], DYs[l * NP + p], acc);
      for (int n = 0; n < N; ++n) acc = fmaf(KDs[m * NP + n], dS[n * NP + p], acc);
      dv[base + (long long)t * tstride + p] = from_f<T>(acc);
    }
    for (int n = tid; n < N; n += kThreads) {  // the thread that owns dUs[n] in every chunk
      float acc = dUs[n];
      for (int l = 0; l < L; ++l) acc = fmaf(dAs[l * LP + l] * Rs[l * NP + n], Ks[l * NP + n], acc);
      dUs[n] = acc;
    }
    __syncthreads();
    for (int e = tid; e < L * N; e += kThreads) {  // dk and dcum (m, n), n on neighbouring lanes
      const int m = e / N, n = e % N, t = t0 + m;
      const float cm = Cs[m * NP + n];
      float rr = 0.f, hh = 0.f;
      for (int l = m + 1; l < L; ++l)
        rr = fmaf(dAs[l * LP + m] * Rs[l * NP + n], expf(CEs[l * NP + n] - cm), rr);
      for (int p = 0; p < N; ++p) hh = fmaf(dS[n * NP + p], Vs[m * NP + p], hh);
      const float kd = KDs[m * NP + n];
      DCs[m * NP + n] = -Ks[m * NP + n] * rr - hh * kd;
      KDs[m * NP + n] = hh * kd;
      if (t < d.s) {
        const float g = rr + dAs[m * LP + m] * Us[n] * Rs[m * NP + n] + hh * expf(Ts[n] - cm);
        dk[base + (long long)t * tstride + n] = from_f<T>(g);
      }
    }
    __syncthreads();
    for (int e = tid; e < L * N; e += kThreads) {  // dr and dcum_excl (l, n), n on neighbouring lanes
      const int l = e / N, n = e % N, t = t0 + l;
      const float cel = CEs[l * NP + n];
      float q = 0.f, g = 0.f;
      for (int m = 0; m < l; ++m) q = fmaf(dAs[l * LP + m] * Ks[m * NP + n], expf(cel - Cs[m * NP + n]), q);
      for (int p = 0; p < N; ++p) g = fmaf(DYs[l * NP + p], Sp[n * NP + p], g);
      const float ex = expf(cel), rv = Rs[l * NP + n];
      DCEs[l * NP + n] = rv * fmaf(g, ex, q);
      if (t < d.s) {
        const float grad = q + dAs[l * LP + l] * Us[n] * Ks[l * NP + n] + g * ex;
        dr[base + (long long)t * tstride + n] = from_f<T>(grad);
      }
      Rs[l * NP + n] = rv * ex;  // this thread's own element; the dS update reads r e^cum_excl
    }
    __syncthreads();
    for (int n = tid; n < N; n += kThreads) {  // dtotal, then dlog w by a reverse cumsum, then dw
      float dt = 0.f, ds = 0.f;
      for (int m = 0; m < L; ++m) dt += KDs[m * NP + n];
      for (int p = 0; p < N; ++p) ds = fmaf(dS[n * NP + p], Sp[n * NP + p], ds);
      dt = fmaf(eTs[n], ds, dt);
      float acc_c = 0.f, acc_e = 0.f;
      for (int l = L - 1; l >= 0; --l) {
        acc_c += DCs[l * NP + n];
        const int t = t0 + l;
        if (t < d.s) {
          const long long off = base + (long long)t * tstride + n;
          const float wv = w[off];
          dw[off] = wv > 1e-30f ? (acc_c + acc_e + dt) / wv : 0.f;
        }
        acc_e += DCEs[l * NP + n];
      }
    }
    __syncthreads();
    for (int e = tid; e < N * N; e += kThreads) {  // dS <- e^total dS + (r e^cum_excl)^T dy
      const int n = e / N, p = e % N;
      float acc = 0.f;
      for (int l = 0; l < L; ++l) acc = fmaf(Rs[l * NP + n], DYs[l * NP + p], acc);
      dS[n * NP + p] = fmaf(eTs[n], dS[n * NP + p], acc);
    }
  }
  for (int n = tid; n < N; n += kThreads) du_part[(long long)row * N + n] = dUs[n];
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
int fwd(const void* r, const void* k, const void* v, const void* w, const void* u, void* y, void* state,
        void* chunk_states, const Dims& d, cudaStream_t st) {
  static size_t opted = 48 * 1024;
  const size_t smem = fwd_smem(d.L, d.n);
  const cudaError_t ready = allow_smem(wkv_fwd_kernel<T>, smem, &opted);
  if (ready != cudaSuccess) return (int)ready;
  wkv_fwd_kernel<T><<<d.b * d.h, kThreads, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const T*>(u), static_cast<T*>(y), static_cast<float*>(state), static_cast<float*>(chunk_states),
      d);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* r, const void* k, const void* v, const void* w, const void* u, const void* dy,
        const void* chunk_states, const void* dstate, void* dr, void* dk, void* dv, void* dw, void* du_part,
        const Dims& d, cudaStream_t st) {
  static size_t opted = 48 * 1024;
  const size_t smem = bwd_smem(d.L, d.n);
  const cudaError_t ready = allow_smem(wkv_bwd_kernel<T>, smem, &opted);
  if (ready != cudaSuccess) return (int)ready;
  wkv_bwd_kernel<T><<<d.b * d.h, kThreads, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const T*>(u), static_cast<const T*>(dy), static_cast<const float*>(chunk_states),
      static_cast<const float*>(dstate), static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dw), static_cast<float*>(du_part), d);
  return (int)cudaGetLastError();
}

bool make_dims(int b, int s, int h, int n, int chunk, Dims* d) {
  if (b < 1 || s < 1 || h < 1 || n < 1 || n > kMaxDim || chunk < 1 || chunk > kMaxDim) return false;
  if ((long long)b * h >= (1LL << 31)) return false;
  d->b = b;
  d->s = s;
  d->h = h;
  d->n = n;
  d->L = chunk;
  d->nc = (s + chunk - 1) / chunk;
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, u, y); w and the states are float32.
// r, k, v, w, y: (b, s, h, n) contiguous; u: (h, n); state: (b, h, n, n);
// chunk_states: (b * h, ceil(s / chunk), n, n), written when not null.
extern "C" int wkv_fwd_launch(const void* r, const void* k, const void* v, const void* w, const void* u, void* y,
                              void* state, void* chunk_states, int b, int s, int h, int n, int chunk, int dtype,
                              void* stream) {
  Dims d;
  if (!make_dims(b, s, h, n, chunk, &d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(r, k, v, w, u, y, state, chunk_states, d, st);
  if (dtype == 1) return fwd<__nv_bfloat16>(r, k, v, w, u, y, state, chunk_states, d, st);
  return (int)cudaErrorInvalidValue;
}

// dy, dr, dk, dv: (b, s, h, n) in r's type; dw: (b, s, h, n) f32; dstate (the
// final state's cotangent, (b, h, n, n) f32) may be null for zero; du_part:
// (b * h, n) f32, one row's du each.
extern "C" int wkv_bwd_launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                              const void* dy, const void* chunk_states, const void* dstate, void* dr, void* dk,
                              void* dv, void* dw, void* du_part, int b, int s, int h, int n, int chunk, int dtype,
                              void* stream) {
  Dims d;
  if (!make_dims(b, s, h, n, chunk, &d) || chunk_states == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd<float>(r, k, v, w, u, dy, chunk_states, dstate, dr, dk, dv, dw, du_part, d, st);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(r, k, v, w, u, dy, chunk_states, dstate, dr, dk, dv, dw, du_part, d, st);
  return (int)cudaErrorInvalidValue;
}
