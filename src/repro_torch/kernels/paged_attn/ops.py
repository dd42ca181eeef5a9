"""Paged-KV attention wrappers: CUDA kernels for CUDA tensors, the plain
versions in ``ref`` for CPU tensors (counterpart of
``repro.kernels.paged_attn.ops``).

* :func:`paged_append_` — ``csrc/paged_append.cu`` (replaces
  ``paged_attn/kernel.py::paged_append_decode``) for every T ≥ 1, so chunked
  prefill appends go through the kernel too. Kernel and plain version apply
  the same last-writer rule and agree bitwise.
* :func:`paged_attend_gqa` — for T == 1 (joint decode) ``csrc/paged_attend.cu``
  (replaces ``paged_attn/kernel.py::paged_attend_decode``). Chunked prefill
  (T > 1) stays the plain ``ref.paged_attend_gqa`` on every device: the JAX
  package also computes it outside any Pallas kernel (``paged_attn/ops.py``),
  so it is not a port of a TPU kernel. Kernel vs plain, stated bound:
  in f32 ``|kernel − plain| ≤ 1e-5`` absolute for O(1) inputs (online vs
  two-pass softmax, other summation order); in bf16 the kernel rounds its f32
  result once, so within one bf16 ulp of the plain value plus that f32 bound.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import I, Kernel, P, dtype_code, stream_ptr
from repro_torch.kernels.paged_attn import ref

APPEND = Kernel("paged_append", {"paged_append_launch": [P, P, P, P, I, I, I, I, I, I, P]})
ATTEND = Kernel(
    "paged_attend", {"paged_attend_launch": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P]}
)


def _check_tables(page_tables: torch.Tensor, lengths: torch.Tensor, slots: int, device) -> None:
    if page_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"page_tables/lengths must be int32, got {page_tables.dtype}, {lengths.dtype}")
    if page_tables.dim() != 2 or page_tables.shape[0] != slots or lengths.shape != (slots,):
        raise ValueError(
            f"page_tables (S={slots}, maxp) and lengths (S,), got {tuple(page_tables.shape)}, {tuple(lengths.shape)}"
        )
    if page_tables.device != device or lengths.device != device:
        raise ValueError(f"page_tables/lengths must be on {device}")
    if not (page_tables.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("page_tables/lengths must be contiguous")


def _on_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"tensors on mixed or unsupported devices: {sorted(str(t.device) for t in ts)}")
    return False


def paged_append_(pool, new, page_tables, lengths):
    """(P, page, KV, D) pool ← (S, T, KV, D) new tokens, in place; returns
    ``pool``. Replaces JAX's aliased/donated pool update."""
    if pool.dim() != 4 or new.dim() != 4 or new.shape[2:] != pool.shape[2:]:
        raise ValueError(f"pool (P, page, KV, D) and new (S, T, KV, D), got {tuple(pool.shape)}, {tuple(new.shape)}")
    if _on_cpu(pool, new, page_tables, lengths):
        return ref.paged_append_(pool, new, page_tables, lengths)
    s_, t = new.shape[:2]
    _check_tables(page_tables, lengths, s_, pool.device)
    if not pool.is_contiguous():
        raise ValueError("paged_append_: pool must be contiguous (it is written in place)")
    dtype_code(pool.dtype)  # raises on an element type the kernel does not take
    new = new.to(pool.dtype).contiguous()
    APPEND.launch(
        "paged_append_launch", pool.data_ptr(), new.data_ptr(), page_tables.data_ptr(),
        lengths.data_ptr(), s_, t, page_tables.shape[1], pool.shape[1], pool.shape[0],
        pool.shape[2] * pool.shape[3] * pool.element_size(), stream_ptr(pool.device),
    )
    return pool


def paged_attend_decode(q, pool_k, pool_v, page_tables, lengths, *, window: Optional[int]):
    """q (S, KV, G, D), one token per slot → (S, KV, G, D) in q's dtype.
    Replaces ``paged_attn/kernel.py::paged_attend_decode``."""
    if q.dim() != 4 or pool_k.dim() != 4 or pool_k.shape != pool_v.shape:
        raise ValueError(f"q (S, KV, G, D), pools (P, page, KV, D); got {tuple(q.shape)}, {tuple(pool_k.shape)}")
    s_, kv, g, d = q.shape
    if pool_k.shape[2:] != (kv, d):
        raise ValueError(f"pool (…, KV={kv}, D={d}) expected, got {tuple(pool_k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if _on_cpu(q, pool_k, pool_v, page_tables, lengths):
        out = ref.paged_attend_gqa(
            q.reshape(s_, 1, kv * g, d), pool_k, pool_v, page_tables, lengths, window=window
        )
        return out.reshape(s_, kv, g, d).to(q.dtype)
    _check_tables(page_tables, lengths, s_, q.device)
    if not (q.dtype == pool_k.dtype == pool_v.dtype):
        raise TypeError(f"q/pool dtypes differ: {q.dtype}, {pool_k.dtype}, {pool_v.dtype}")
    if g > 8 or d not in (32, 64, 128, 256):
        raise ValueError(f"paged_attend kernel takes G <= 8 and D in (32, 64, 128, 256), got G={g}, D={d}")
    if not (q.is_contiguous() and pool_k.is_contiguous() and pool_v.is_contiguous()):
        raise ValueError("paged_attend_decode: q and pools must be contiguous")
    out = torch.empty_like(q)
    ATTEND.launch(
        "paged_attend_launch", q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        page_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), s_, kv, g, d,
        page_tables.shape[1], pool_k.shape[1], pool_k.shape[0], window or 0,
        dtype_code(q.dtype), stream_ptr(q.device),
    )
    return out


def paged_attend_gqa(q, pool_k, pool_v, page_tables, lengths, *, window: Optional[int] = None):
    """(S, T, H, D) pre-scaled q against the pool. T == 1 goes to the decode
    kernel (output in q's dtype); T > 1 is the plain chunked-prefill body
    (output f32, as the reference returns)."""
    if q.shape[1] != 1:
        return ref.paged_attend_gqa(q, pool_k, pool_v, page_tables, lengths, window=window)
    s_, _, h, d = q.shape
    kv = pool_k.shape[2]
    out = paged_attend_decode(
        q.reshape(s_, kv, h // kv, d), pool_k, pool_v, page_tables, lengths, window=window
    )
    return out.reshape(s_, 1, h, d)
