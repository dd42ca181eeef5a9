"""Paged KV-cache pools and the physical page allocator (counterpart of
``repro.serving.paged_cache``).

One pool pair per attention segment, with a leading layer axis:
``pool_k`` / ``pool_v`` are (n, num_pages, page_size, kv_heads, head_dim).
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
    """The port pages GQA text archs whose every segment is ``"attn"``. The
    reference also pages MLA and MoE archs; those come to the port with
    their model code."""
    from repro_torch.models.transformer import _check_supported

    if cfg is None:
        return False
    try:
        _check_supported(cfg)
    except NotImplementedError:
        return False
    return True


def pages_for(tokens: int, page_size: int) -> int:
    return max(1, math.ceil(tokens / page_size))


def init_paged_pools(
    cfg: ModelConfig, num_pages: int, page_size: int, dtype=None, device="cpu"
) -> Dict[str, Any]:
    """Zero-initialised per-segment pools keyed ``seg{i}`` like the params."""
    from repro_torch.models.transformer import segments

    if not paged_supported(cfg):
        raise ValueError(f"{cfg.name}: paged pools require a GQA attention-only text arch (see paged_supported)")
    dtype = dtype or cfg.param_dtype
    a = cfg.attention
    pools: Dict[str, Any] = {}
    for si, (_, n) in enumerate(segments(cfg)):
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
    per_layer = 2 * num_pages * page_size * a.num_kv_heads * a.head_dim * itemsize
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
