"""Paged-KV attention — plain PyTorch bodies, op for op the reference
``repro.kernels.paged_attn.ref`` (same layouts, einsum strings, f32 upcasts,
mask values and softmax).

A *pool* is ``(num_pages, page_size, kv_heads, head_dim)`` (GQA) or
``(num_pages, page_size, rank)`` (MLA's latent pools); a slot's page
table ``(slots, max_pages)`` maps its logical pages to physical ones, and
``lengths (slots,)`` counts the tokens already resident, which is also the
position of the first token appended this call. Physical page 0 is the trash
page: idle slots carry an all-zero table row and length 0.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def paged_gather(pool: torch.Tensor, page_tables: torch.Tensor) -> torch.Tensor:
    """(P, page, ...) × (S, maxp) → (S, maxp·page, ...): a slot's cache in
    position order."""
    g = pool[page_tables.long()]  # (S, maxp, page, ...)
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *pool.shape[2:])


def append_targets(
    page_tables: torch.Tensor, lengths: torch.Tensor, t: int, page_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Physical (page_ids, offsets), each (S, t), for the next ``t`` tokens
    of every slot; positions past the table's last page clamp to it."""
    pos = lengths[:, None] + torch.arange(t, dtype=torch.int32, device=lengths.device)[None, :]
    maxp = page_tables.shape[1]
    page_idx = torch.clamp(torch.div(pos, page_size, rounding_mode="floor"), max=maxp - 1)
    page_ids = torch.gather(page_tables, 1, page_idx.long())
    return page_ids, torch.remainder(pos, page_size)


def _last_writer(flat: torch.Tensor) -> torch.Tensor:
    """Bool mask over a 1-D index vector: True where no later entry has the
    same index — the entry a sequential scatter leaves behind."""
    n = flat.shape[0]
    same = flat[:, None] == flat[None, :]
    later = torch.triu(torch.ones(n, n, dtype=torch.bool, device=flat.device), diagonal=1)
    return ~(same & later).any(dim=1)


def paged_append_(
    pool: torch.Tensor,  # (P, page, ...)
    new: torch.Tensor,  # (S, T, ...)
    page_tables: torch.Tensor,  # (S, maxp) int32
    lengths: torch.Tensor,  # (S,) int32
) -> torch.Tensor:
    """Scatter T new tokens per slot into their pages, in place; returns
    ``pool``. Where several tokens target one cell (clamped positions, idle
    slots on the trash page) the last in (slot, token) order wins, as in the
    reference's sequential scatter — the rule the CUDA kernel implements."""
    page_ids, offsets = append_targets(page_tables, lengths, new.shape[1], pool.shape[1])
    flat = (page_ids.long() * pool.shape[1] + offsets.long()).reshape(-1)
    keep = _last_writer(flat)
    rows = new.reshape(-1, *new.shape[2:]).to(pool.dtype)
    pool.view(-1, *pool.shape[2:])[flat[keep]] = rows[keep]
    return pool


def _causal_valid(lengths: torch.Tensor, t: int, l: int, window: Optional[int]) -> torch.Tensor:
    """(S, t, l) bool: key position visible to query position."""
    k_pos = torch.arange(l, dtype=torch.int32, device=lengths.device)
    q_pos = lengths[:, None] + torch.arange(t, dtype=torch.int32, device=lengths.device)[None, :]
    valid = k_pos[None, None, :] <= q_pos[:, :, None]
    if window is not None:
        valid &= k_pos[None, None, :] > (q_pos[:, :, None] - window)
    return valid


def paged_attend_gqa(
    q: torch.Tensor,  # (S, T, H, D), pre-scaled
    pool_k: torch.Tensor,  # (P, page, KV, D)
    pool_v: torch.Tensor,
    page_tables: torch.Tensor,  # (S, maxp)
    lengths: torch.Tensor,  # (S,) — position of q[:, 0]
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Grouped-query attention against the (already appended) pool; T > 1
    adds in-chunk causality for chunked prefill. Returns f32 (S, T, H, D)."""
    b, t, h, d = q.shape
    k = paged_gather(pool_k, page_tables)  # (S, L, KV, D)
    v = paged_gather(pool_v, page_tables)
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, t, kvh, g, d)
    scores = torch.einsum("bqhgd,blhd->bhgql", qg.to(torch.float32), k.to(torch.float32))
    valid = _causal_valid(lengths, t, k.shape[1], window)  # (S, T, L)
    scores = scores.masked_fill(~valid[:, None, None, :, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgql,blhd->bqhgd", p, v.to(torch.float32))
    return out.reshape(b, t, h, d)


def paged_attend_mla(
    q_lat: torch.Tensor,  # (S, T, H, r): the W_uk-absorbed no-RoPE query
    q_rope: torch.Tensor,  # (S, T, H, dr)
    pool_ckv: torch.Tensor,  # (P, page, r)
    pool_krope: torch.Tensor,  # (P, page, dr)
    page_tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float,
) -> torch.Tensor:
    """Absorbed MLA decode over the paged latent cache (the reference's
    ``paged_attend_mla``, which has no Pallas kernel on any backend): f32
    scores over ckv and krope, ``scale`` applied in f32, the in-chunk causal
    mask, softmax, then the latent output (S, T, H, r) in f32; the caller
    applies W_uv."""
    ckv = paged_gather(pool_ckv, page_tables)  # (S, L, r)
    kr = paged_gather(pool_krope, page_tables)  # (S, L, dr)
    s_nope = torch.einsum("bshr,blr->bhsl", q_lat.to(torch.float32), ckv.to(torch.float32))
    s_rope = torch.einsum("bshk,blk->bhsl", q_rope.to(torch.float32), kr.to(torch.float32))
    scores = (s_nope + s_rope) * scale
    valid = _causal_valid(lengths, q_lat.shape[1], ckv.shape[1], None)  # (S, T, L)
    scores = scores.masked_fill(~valid[:, None, :, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhsl,blr->bshr", p, ckv.to(torch.float32))
