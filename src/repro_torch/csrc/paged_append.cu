// Paged KV append: scatter each slot's T new (kv_heads, head_dim) rows into
// its pages, in place.
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
// order wins, as a sequential scatter does: each block first looks for a
// later token with the same target and, if there is one, writes nothing. The
// result is therefore deterministic and bitwise equal to the plain version.
//
// What bounds it on the H100: bytes, and at serving sizes launch latency. It
// moves S*T*KV*D elements twice (read new, write the pool) and reads the
// lengths and S*T page-table entries; for qwen2-7b decode that is 4 slots x
// 4 KV heads x 128 x 2 bytes = 4 KiB per call.
//
// Design: one block per (slot, token), 128 threads copying the row in
// 16-byte units when size and alignment allow, else 4- or 2-byte units.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ bool target(const int* pt, const int* lengths, int s, int t, int maxp,
                                       int page, int* pid, int* off) {
  const int pos = lengths[s] + t;
  if (pos < 0) return false;
  const int idx = min(pos / page, maxp - 1);
  *pid = pt[(size_t)s * maxp + idx];
  *off = pos % page;
  return true;
}

template <typename U>
__global__ void paged_append_kernel(U* __restrict__ pool, const U* __restrict__ src,
                                    const int* __restrict__ pt, const int* __restrict__ lengths,
                                    int S, int T, int maxp, int page, int num_pages, int units) {
  const int s = blockIdx.x, t = blockIdx.y;
  int pid, off;
  if (!target(pt, lengths, s, t, maxp, page, &pid, &off)) return;
  if (pid < 0 || pid >= num_pages) return;
  // a later (slot, token) with the same target cell wins
  for (int k = s * T + t + 1; k < S * T; ++k) {
    int p2, o2;
    if (target(pt, lengths, k / T, k % T, maxp, page, &p2, &o2) && p2 == pid && o2 == off) return;
  }
  U* dst = pool + ((size_t)pid * page + off) * units;
  const U* row = src + ((size_t)s * T + t) * units;
  for (int i = threadIdx.x; i < units; i += blockDim.x) dst[i] = row[i];
}

template <typename U>
int launch(void* pool, const void* src, const int* pt, const int* lengths, int S, int T, int maxp,
           int page, int num_pages, int row_bytes, cudaStream_t st) {
  dim3 grid(S, T);
  paged_append_kernel<U><<<grid, 128, 0, st>>>(static_cast<U*>(pool), static_cast<const U*>(src),
                                                pt, lengths, S, T, maxp, page, num_pages,
                                                row_bytes / (int)sizeof(U));
  return (int)cudaGetLastError();
}

}  // namespace

// pool: (num_pages, page, KV, D) contiguous; src: (S, T, KV, D) contiguous, same
// element type; page_tables: (S, maxp) int32; lengths: (S,) int32.
// row_bytes = KV * D * element size.
extern "C" int paged_append_launch(void* pool, const void* src, const void* page_tables,
                                   const void* lengths, int S, int T, int maxp, int page,
                                   int num_pages, int row_bytes, void* stream) {
  if (S <= 0 || T <= 0) return 0;
  if (T > 65535 || maxp <= 0 || page <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_tables);
  const int* ln = static_cast<const int*>(lengths);
  const uintptr_t a = (uintptr_t)pool | (uintptr_t)src;
  if (row_bytes % 16 == 0 && a % 16 == 0)
    return launch<uint4>(pool, src, pt, ln, S, T, maxp, page, num_pages, row_bytes, st);
  if (row_bytes % 4 == 0 && a % 4 == 0)
    return launch<uint32_t>(pool, src, pt, ln, S, T, maxp, page, num_pages, row_bytes, st);
  if (row_bytes % 2 == 0 && a % 2 == 0)
    return launch<uint16_t>(pool, src, pt, ln, S, T, maxp, page, num_pages, row_bytes, st);
  return (int)cudaErrorInvalidValue;
}
