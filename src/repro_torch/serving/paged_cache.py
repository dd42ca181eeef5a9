"""Paged KV-cache pools and the physical page allocator (counterpart of
``repro.serving.paged_cache``).

One pool pair per attention segment, with a leading layer axis:

* GQA: ``pool_k`` / ``pool_v`` — (n, num_pages, page_size, kv_heads, head_dim);
* MLA: ``pool_ckv`` / ``pool_krope`` — (n, num_pages, page_size, rank), the
  latent of ``kv_lora_rank`` and the RoPE key of ``qk_rope_head_dim``.

The page table and lengths are host-owned scheduler state passed per step
as a :class:`PagedState`, shared by every layer. Physical page 0 is the
trash page: idle rows carry a zero table row and length 0, so their
discarded appends land there.
"""
from __future__ import annotations

import heapq
import math
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from repro_torch.config.base import ModelConfig

class PagedState(NamedTuple):
    """Per-step paged-attention operands, int32 tensors on the model's device."""

    page_tables: Any  # (S, max_pages) — physical page per logical page
    lengths: Any  # (S,) — tokens resident before this step's append


def paged_supported(cfg: ModelConfig) -> bool:
    """The reference's rule: paged serving covers attention-family text
    archs (every segment ``"attn"`` or ``"moe"``, GQA or MLA, SiLU or GELU
    MLPs; no frontend, no M-RoPE). Recurrent and hybrid archs (rwkv6,
    zamba2's mamba2 segments) keep the dense engine: their decode state is
    O(1) in the sequence length, so there is nothing to page; so do the
    modality frontends and M-RoPE's multi-axis positions."""
    from repro_torch.models.transformer import segments

    if cfg is None:
        return False
    if cfg.frontend is not None or cfg.attention is None:
        return False
    if cfg.attention.rope == "mrope":
        return False
    return all(kind in ("attn", "moe") for kind, _ in segments(cfg))


def require_paged(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is paged (:func:`paged_supported`): the other
    archs are served by dense decode (``BatchedEngine`` with
    ``paged="auto"``)."""
    from repro_torch.models.transformer import _check_supported

    if not paged_supported(cfg):
        raise ValueError(f"{getattr(cfg, 'name', cfg)}: paged serving requires an attention-only text arch; "
                         "recurrent and hybrid archs, the modality frontends and M-RoPE are served by dense decode")
    _check_supported(cfg)


def pages_for(tokens: int, page_size: int) -> int:
    return max(1, math.ceil(tokens / page_size))


def init_paged_pools(
    cfg: ModelConfig, num_pages: int, page_size: int, dtype=None, device="cpu"
) -> Dict[str, Any]:
    """Zero-initialised per-segment pools keyed ``seg{i}`` like the params."""
    from repro_torch.models.transformer import segments

    require_paged(cfg)
    dtype = dtype or cfg.param_dtype
    a = cfg.attention
    pools: Dict[str, Any] = {}
    for si, (_, n) in enumerate(segments(cfg)):
        if a.kind == "mla":
            pools[f"seg{si}"] = dict(
                pool_ckv=torch.zeros((n, num_pages, page_size, a.kv_lora_rank), dtype=dtype, device=device),
                pool_krope=torch.zeros((n, num_pages, page_size, a.qk_rope_head_dim), dtype=dtype, device=device),
            )
            continue
        shape = (n, num_pages, page_size, a.num_kv_heads, a.head_dim)
        pools[f"seg{si}"] = dict(
            pool_k=torch.zeros(shape, dtype=dtype, device=device),
            pool_v=torch.zeros(shape, dtype=dtype, device=device),
        )
    return pools


def pool_bytes(cfg: ModelConfig, num_pages: int, page_size: int, dtype=None) -> int:
    from repro_torch.models.transformer import segments

    dtype = dtype or cfg.param_dtype
    a = cfg.attention
    itemsize = torch.empty((), dtype=dtype).element_size()
    row = a.kv_lora_rank + a.qk_rope_head_dim if a.kind == "mla" else 2 * a.num_kv_heads * a.head_dim
    per_layer = num_pages * page_size * row * itemsize
    return sum(n * per_layer for _, n in segments(cfg))


class PageAllocator:
    """Deterministic physical-page allocator. Page 0 (trash) is never handed
    out; free pages are issued lowest-id-first so a replayed arrival trace
    reproduces the exact page assignment."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (one is the trash page), got {num_pages}")
        self.num_pages = num_pages
        self._free: List[int] = list(range(1, num_pages))
        heapq.heapify(self._free)

    @property
    def capacity(self) -> int:
        return self.num_pages - 1

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages (ascending ids), or None — never a partial grant."""
        if n > len(self._free):
            return None
        return [heapq.heappop(self._free) for _ in range(n)]

    def free(self, pages) -> None:
        for p in pages:
            if not (0 < p < self.num_pages):
                raise ValueError(f"freeing invalid page {p}")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
            heapq.heappush(self._free, p)
