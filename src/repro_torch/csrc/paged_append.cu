// Paged KV append: scatter each slot's T new rows into its pages, in place,
// into one pool or into two pools in one grid: the K and V pools of GQA
// ((kv_heads, head_dim) rows), or MLA's latent pools (DeepSeek-V3: a
// kv_lora_rank row of ckv and a qk_rope_head_dim row of krope, 1024 and 128
// bytes in bf16), whose rows may differ in width.
//
// Replaces the Pallas TPU kernel
// repro/kernels/paged_attn/kernel.py::paged_append_decode (_append_kernel),
// which takes one token per slot (T = 1) and aliases the pool to its output.
// This kernel takes any T >= 1 with the semantics of
// repro/kernels/paged_attn/ref.py::paged_append: token t of slot s sits at
// position pos = lengths[s] + t and goes to physical page
// page_tables[s, min(pos / page, maxp - 1)] at offset pos % page. Idle slots
// (an all-zero table row, length 0) write into trash page 0.
//
// Where two tokens land on the same cell (positions clamped past the table's
// end, or idle slots sharing the trash page), the later one in (slot, token)
// order wins, as a sequential scatter does: a row is written only if no later
// row has its target. The result is deterministic and bitwise equal to the
// plain version.
//
// What bounds it on the H100: at serving sizes, launch latency. It moves
// S*T rows twice (read new, write the pool) and reads the lengths and S*T
// page-table entries; for qwen2-7b decode a row is 4 KV heads x 128 x 2 bytes
// = 1 KiB, so both pools together are 8 KiB a call; for deepseek-v3 a token's
// latent rows are 1152 bytes.
//
// Design: one launch for both pools (they share the targets). A CTA of eight
// warps owns eight consecutive rows, a warp a row. The CTA computes the
// targets of the rows after its first one into shared memory, a tile of
// kTile at a time (one tile up to S*T = kTile + 1, so a decode step or a
// chunk of prefill reads each page-table entry once a CTA), and each warp
// looks for its own target among the later ones, 32 at a time with a vote.
// A warp whose row survives copies it, and the same row of the second pool,
// in 16-byte units when sizes and alignment allow (else 4- or 2-byte units).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 1024;  // 8 KiB of targets in shared memory

// The pool cell (page * page_size + offset) row k = s * T + t goes to, or -1
// if it writes nothing (a negative position, a page id outside the pool).
__device__ __forceinline__ long long cell_of(const int* __restrict__ pt, const int* __restrict__ lengths, int k,
                                             int T, int maxp, int page, int num_pages) {
  const int s = k / T;
  const int pos = lengths[s] + (k - s * T);
  if (pos < 0) return -1;
  const int pid = pt[(size_t)s * maxp + min(pos / page, maxp - 1)];
  if (pid < 0 || pid >= num_pages) return -1;
  return (long long)pid * page + pos % page;
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
paged_append_kernel(U* __restrict__ pool_k, U* __restrict__ pool_v, const U* __restrict__ src_k,
                    const U* __restrict__ src_v, const int* __restrict__ pt, const int* __restrict__ lengths, int n,
                    int T, int maxp, int page, int num_pages, int units, int units_v) {
  __shared__ long long later[kTile];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kWarps;
  const int k = k0 + warp;
  const long long mine = k < n ? cell_of(pt, lengths, k, T, maxp, page, num_pages) : -1;
  bool hit = false;
  for (int base = k0 + 1; base < n; base += kTile) {  // the same trip count in every warp of the CTA
    const int m = min(kTile, n - base);
    for (int i = threadIdx.x; i < m; i += kThreads) later[i] = cell_of(pt, lengths, base + i, T, maxp, page, num_pages);
    __syncthreads();
    if (mine >= 0)
      for (int i = lane; i < m; i += 32) hit |= base + i > k && later[i] == mine;
    __syncthreads();
  }
  if (mine < 0 || __any_sync(0xffffffffu, hit)) return;
  // one pool: units_v is 0 and pool_v is never touched
  const size_t dst = (size_t)mine * units, src = (size_t)k * units;
  const size_t dst_v = (size_t)mine * units_v, src_v0 = (size_t)k * units_v;
  for (int i = lane; i < max(units, units_v); i += 32) {
    if (i < units) pool_k[dst + i] = src_k[src + i];
    if (i < units_v) pool_v[dst_v + i] = src_v[src_v0 + i];
  }
}

template <typename U>
int launch(void* pool_k, void* pool_v, const void* src_k, const void* src_v, const int* pt, const int* lengths, int n,
           int T, int maxp, int page, int num_pages, int row_bytes, int row_bytes_v, cudaStream_t st) {
  paged_append_kernel<U><<<(n + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      static_cast<U*>(pool_k), static_cast<U*>(pool_v), static_cast<const U*>(src_k), static_cast<const U*>(src_v),
      pt, lengths, n, T, maxp, page, num_pages, row_bytes / (int)sizeof(U), row_bytes_v / (int)sizeof(U));
  return (int)cudaGetLastError();
}

int append(void* pool_k, void* pool_v, const void* src_k, const void* src_v, const void* page_tables,
           const void* lengths, int S, int T, int maxp, int page, int num_pages, int row_bytes, int row_bytes_v,
           void* stream) {
  if (S <= 0 || T <= 0) return 0;
  if (maxp <= 0 || page <= 0 || row_bytes <= 0 || row_bytes_v < 0 || (long long)S * T > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_tables);
  const int* ln = static_cast<const int*>(lengths);
  const uintptr_t a = (uintptr_t)pool_k | (uintptr_t)pool_v | (uintptr_t)src_k | (uintptr_t)src_v;
  const int rb = row_bytes | row_bytes_v;  // both widths must be whole units
  const int n = S * T;
  if (rb % 16 == 0 && a % 16 == 0)
    return launch<uint4>(pool_k, pool_v, src_k, src_v, pt, ln, n, T, maxp, page, num_pages, row_bytes, row_bytes_v, st);
  if (rb % 4 == 0 && a % 4 == 0)
    return launch<uint32_t>(pool_k, pool_v, src_k, src_v, pt, ln, n, T, maxp, page, num_pages, row_bytes, row_bytes_v,
                            st);
  if (rb % 2 == 0 && a % 2 == 0)
    return launch<uint16_t>(pool_k, pool_v, src_k, src_v, pt, ln, n, T, maxp, page, num_pages, row_bytes, row_bytes_v,
                            st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// pool: (num_pages, page, row) contiguous, a row KV * D (GQA) or a latent
// width (MLA) elements; src: (S, T, row) contiguous, same element type;
// page_tables: (S, maxp) int32; lengths: (S,) int32. row_bytes = a row's bytes.
extern "C" int paged_append_launch(void* pool, const void* src, const void* page_tables, const void* lengths, int S,
                                   int T, int maxp, int page, int num_pages, int row_bytes, void* stream) {
  return append(pool, nullptr, src, nullptr, page_tables, lengths, S, T, maxp, page, num_pages, row_bytes, 0, stream);
}

// Two pools in one grid, sharing the page tables and the element type: pool_k
// with rows of row_bytes_k (src k), pool_v with rows of row_bytes_v (src v);
// the targets are computed once for both.
extern "C" int paged_append_kv_launch(void* pool_k, void* pool_v, const void* k, const void* v,
                                      const void* page_tables, const void* lengths, int S, int T, int maxp, int page,
                                      int num_pages, int row_bytes_k, int row_bytes_v, void* stream) {
  if (pool_v == nullptr || v == nullptr || row_bytes_v <= 0) return (int)cudaErrorInvalidValue;
  return append(pool_k, pool_v, k, v, page_tables, lengths, S, T, maxp, page, num_pages, row_bytes_k, row_bytes_v,
                stream);
}
