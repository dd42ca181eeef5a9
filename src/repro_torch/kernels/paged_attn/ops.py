"""Paged-KV attention wrappers: CUDA kernels for CUDA tensors, the plain
versions in ``ref`` for CPU tensors (counterpart of
``repro.kernels.paged_attn.ops``).

* :func:`paged_append_kv_` (both pools in one launch, as the attention layer
  calls it) and :func:`paged_append_` (one pool) — ``csrc/paged_append.cu``
  (replaces ``paged_attn/kernel.py::paged_append_decode``) for every T ≥ 1,
  so chunked prefill appends go through the kernel too. The GQA pools are
  ``(P, page, KV, D)``; MLA's latent pools are rank 3, ``(P, page, r)``,
  taken as one head of width r, and the two latent pools (ckv and krope)
  have rows of different widths, still appended in one launch. (The
  reference sends a rank-3 append to its jnp path, ``ops.py:41``.) Kernel
  and plain version apply the same last-writer rule and agree bitwise.
* :func:`paged_attend_mla` — the absorbed MLA decode over the latent pools:
  plain torch on every device (``ref.paged_attend_mla``), as the reference
  keeps it jnp on every backend; it is no Pallas kernel.
* :func:`paged_attend_gqa` — for T == 1 (joint decode) ``csrc/paged_attend.cu``
  (replaces ``paged_attn/kernel.py::paged_attend_decode``), its grid split over
  the positions by :func:`decode_splits` and merged in the same launch through
  a workspace and ticket counters that the wrapper holds per device. Chunked prefill
  (T > 1) stays the plain ``ref.paged_attend_gqa`` on every device: the JAX
  package also computes it outside any Pallas kernel (``paged_attn/ops.py``),
  so it is not a port of a TPU kernel. Kernel vs plain, stated bound:
  in f32 ``|kernel − plain| ≤ 1e-5`` absolute for O(1) inputs (online vs
  two-pass softmax, other summation order); in bf16 the kernel rounds its f32
  result once, so within one bf16 ulp of the plain value plus that f32 bound.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels._build import I, Kernel, P, dtype_code, stream_ptr
from repro_torch.kernels.paged_attn import ref

APPEND = Kernel("paged_append", {"paged_append_launch": [P, P, P, P, I, I, I, I, I, I, P],
                                 "paged_append_kv_launch": [P, P, P, P, P, P, I, I, I, I, I, I, I, P]})
ATTEND = Kernel("paged_attend", {"paged_attend_launch": [P] * 8 + [I] * 11 + [P]})
GROUP_MAX = 16  # query heads per KV head the decode kernel takes (mistral-large's 12 among them): one m16 tile
HEAD_DIMS = (32, 64, 80, 128, 256)  # multiples of 16 (the tensor cores' k step), each with its own instance
SPLIT_CTAS = 264  # the decode grid aims at two CTAs on each of the H100's 132 SMs
SPLIT_MIN = 64  # positions: a split is at least the bf16 kernel's tile (16 positions a warp)


def decode_splits(slots: int, kv: int, maxp: int, page: int):
    """(splits, span): the decode kernel's grid is (slots, KV heads, splits),
    a split covering ``span`` positions, whole pages, at least
    :data:`SPLIT_MIN`. At most :data:`SPLIT_CTAS` CTAs where the table is
    long enough (serving's 4 slots x 4 KV heads: 8 splits of 64 positions
    at max_len 512, 128 CTAs; 8 KV heads: 8 splits, 256 CTAs); from
    host-known shapes only, never from the lengths, so the result's bits
    depend on the shapes alone."""
    want = max(1, SPLIT_CTAS // (slots * kv))
    pages = max(-(-maxp // want), -(-SPLIT_MIN // page))
    return -(-maxp // pages), pages * page


def split_span(split: int, span: int, length: int, window: Optional[int], maxp: int, page: int):
    """Positions [lo, hi] of a slot of this length that ``split`` covers, as
    the kernel computes them (empty when lo > hi): the visible positions
    (at most ``length``, inside the table and the window) within
    [split·span, (split+1)·span)."""
    hi = min(length, maxp * page - 1)
    lo = max(0, length - window + 1) if window else 0
    return max(lo, split * span), min(hi, split * span + span - 1)


_PLANS: dict = {}  # (device index, slots, KV, G, D, maxp, page) -> (splits, span, workspace and counters pointers)
_WORK: dict = {}  # device index -> (f32 workspace, int32 ticket counters), grown when needed


def _plan(device, slots: int, kv: int, g: int, d: int, maxp: int, page: int):
    """The split grid of a decode call at these shapes and the pointers of
    the workspace (each split's f32 accumulator, m and l, 16-byte aligned)
    and ticket counters (zero, and left zero by every launch) it runs on:
    held per device across calls, grown when a shape needs more, and
    planned once a shape (a plan keeps the buffers it was given alive)."""
    key = (device.index, slots, kv, g, d, maxp, page)
    plan = _PLANS.get(key)
    if plan is None:
        splits, span = decode_splits(slots, kv, maxp, page)
        floats = slots * kv * splits * (-(-g * (d + 2) // 4) * 4)
        ws, cnt = _WORK.get(device.index, (None, None))
        if ws is None or ws.numel() < floats:
            ws = torch.empty(floats, dtype=torch.float32, device=device)
        if cnt is None or cnt.numel() < slots * kv:
            cnt = torch.zeros(slots * kv, dtype=torch.int32, device=device)
        _WORK[device.index] = (ws, cnt)
        plan = _PLANS[key] = (splits, span, ws.data_ptr(), cnt.data_ptr(), ws, cnt)
    return plan


def check_decode_shape(group: int, head_dim: int) -> None:
    """Raise unless the decode kernel takes this GQA group and head dim. The
    engine calls it before it allocates any pool, on every device, so the
    CPU and the card refuse the same configs: a group above 16, or a head
    dim the kernel has no instance for."""
    if not 1 <= group <= GROUP_MAX or head_dim not in HEAD_DIMS:
        raise NotImplementedError(f"the paged decode kernel takes a GQA group of 1..{GROUP_MAX} and head_dim in "
                                  f"{HEAD_DIMS}, got group {group}, head_dim {head_dim}")


def _check_tables(page_tables: torch.Tensor, lengths: torch.Tensor, slots: int) -> None:
    """The tables' dtype, shape and layout (their device: :func:`_on_cpu`)."""
    if page_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"page_tables/lengths must be int32, got {page_tables.dtype}, {lengths.dtype}")
    if page_tables.dim() != 2 or page_tables.shape[0] != slots or lengths.shape != (slots,):
        raise ValueError(
            f"page_tables (S={slots}, maxp) and lengths (S,), got {tuple(page_tables.shape)}, {tuple(lengths.shape)}"
        )
    if not (page_tables.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("page_tables/lengths must be contiguous")


def _on_cpu(*ts: torch.Tensor) -> bool:
    """True if every tensor is on the CPU, False if all are on one CUDA
    device; raises otherwise."""
    index = ts[0].get_device()
    for t in ts:
        if not t.is_cuda or t.get_device() != index:
            break
    else:
        return False
    for t in ts:
        if not t.is_cpu:
            raise ValueError(f"tensors on mixed or unsupported devices: {sorted(str(t.device) for t in ts)}")
    return True


paged_attend_mla = ref.paged_attend_mla


def _check_append(pool, new):
    """The shapes of a pool (P, page, KV, D) or (P, page, r) and its new
    rows (S, T, KV, D) or (S, T, r)."""
    pshape, nshape = pool.shape, new.shape
    if len(pshape) not in (3, 4) or len(nshape) != len(pshape) or nshape[2:] != pshape[2:]:
        raise ValueError(f"pool (P, page, KV, D) or (P, page, r) and new (S, T, KV, D) or (S, T, r), got "
                         f"{tuple(pshape)}, {tuple(nshape)}")
    return pshape, nshape


def _row_bytes(pool) -> int:
    return math.prod(pool.shape[2:]) * pool.element_size()


def _as_pool(new, dtype):
    """``new`` in the pool's dtype and contiguous; a copy only where that
    changes something."""
    if new.dtype != dtype or not new.is_contiguous():
        new = new.to(dtype).contiguous()
    return new


def paged_append_(pool, new, page_tables, lengths):
    """(P, page, KV, D) pool ← (S, T, KV, D) new tokens (or a rank-3 latent
    pool (P, page, r) ← (S, T, r)), in place; returns ``pool``. Replaces
    JAX's aliased/donated pool update."""
    pshape, nshape = _check_append(pool, new)
    (num_pages, page), (s_, t) = pshape[:2], nshape[:2]
    if _on_cpu(pool, new, page_tables, lengths):
        return ref.paged_append_(pool, new, page_tables, lengths)
    _check_tables(page_tables, lengths, s_)
    if not pool.is_contiguous():
        raise ValueError("paged_append_: pool must be contiguous (it is written in place)")
    dtype_code(pool.dtype)  # raises on an element type the kernel does not take
    new = _as_pool(new, pool.dtype)
    APPEND.launch(
        "paged_append_launch", pool.data_ptr(), new.data_ptr(), page_tables.data_ptr(), lengths.data_ptr(), s_, t,
        page_tables.shape[1], page, num_pages, _row_bytes(pool), stream_ptr(pool.device),
    )
    return pool


def paged_append_kv_(pool_k, pool_v, k, v, page_tables, lengths):
    """Two pools appended in one launch, in place; returns ``(pool_k,
    pool_v)``: GQA's K and V pools, or MLA's latent pools (``pool_ckv``
    (P, page, r) ← ckv (S, T, r) and ``pool_krope`` (P, page, dr) ← krope
    (S, T, dr)). The pools share their pages, page size and dtype, k and v
    their (S, T); their rows may differ in width. The plain version is
    :func:`ref.paged_append_` on each pool."""
    pshape, kshape = _check_append(pool_k, k)
    if (pool_v.dim() != len(pshape) or pool_v.shape[:2] != pshape[:2] or v.shape[:2] != kshape[:2]
            or v.shape[2:] != pool_v.shape[2:]):
        raise ValueError(f"pool_v {tuple(pool_v.shape)} and v {tuple(v.shape)} must match pool_k {tuple(pshape)} "
                         f"and k {tuple(kshape)} in rank, (P, page) and (S, T), and each other in their rows")
    dtype = pool_k.dtype
    if pool_v.dtype != dtype:
        raise TypeError(f"pool_k/pool_v dtypes differ: {dtype}, {pool_v.dtype}")
    if _on_cpu(pool_k, pool_v, k, v, page_tables, lengths):
        return ref.paged_append_(pool_k, k, page_tables, lengths), ref.paged_append_(pool_v, v, page_tables, lengths)
    s_, t = kshape[0], kshape[1]
    _check_tables(page_tables, lengths, s_)
    if not (pool_k.is_contiguous() and pool_v.is_contiguous()):
        raise ValueError("paged_append_kv_: pools must be contiguous (they are written in place)")
    dtype_code(dtype)  # raises on an element type the kernel does not take
    k, v = _as_pool(k, dtype), _as_pool(v, dtype)
    num_pages, page = pshape[:2]
    APPEND.launch(
        "paged_append_kv_launch", pool_k.data_ptr(), pool_v.data_ptr(), k.data_ptr(), v.data_ptr(),
        page_tables.data_ptr(), lengths.data_ptr(), s_, t, page_tables.shape[1], page, num_pages,
        _row_bytes(pool_k), _row_bytes(pool_v), stream_ptr(pool_k.device),
    )
    return pool_k, pool_v


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
    _check_tables(page_tables, lengths, s_)
    if not (q.dtype == pool_k.dtype == pool_v.dtype):
        raise TypeError(f"q/pool dtypes differ: {q.dtype}, {pool_k.dtype}, {pool_v.dtype}")
    check_decode_shape(g, d)
    if not (q.is_contiguous() and pool_k.is_contiguous() and pool_v.is_contiguous()):
        raise ValueError("paged_attend_decode: q and pools must be contiguous")
    out = torch.empty_like(q)
    dev, maxp, page = q.device, page_tables.shape[1], pool_k.shape[1]
    splits, span, ws, cnt = _plan(dev, s_, kv, g, d, maxp, page)[:4]
    ATTEND.launch(
        "paged_attend_launch", q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        page_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), ws, cnt, s_, kv, g, d,
        maxp, page, pool_k.shape[0], window or 0, splits, span, dtype_code(q.dtype), stream_ptr(dev),
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
