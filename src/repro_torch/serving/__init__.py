from repro_torch.serving.engine import BatchedEngine, paged_step, resolve_device
from repro_torch.serving.paged_cache import (
    PageAllocator,
    PagedState,
    init_paged_pools,
    paged_supported,
    pages_for,
    pool_bytes,
)
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = [
    "BatchedEngine",
    "PageAllocator",
    "PagedState",
    "Request",
    "Scheduler",
    "init_paged_pools",
    "paged_step",
    "paged_supported",
    "pages_for",
    "pool_bytes",
    "resolve_device",
]
