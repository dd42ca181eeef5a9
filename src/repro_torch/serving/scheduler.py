"""Continuous-batching scheduler over the paged KV pool (a behavioural copy
of ``repro.serving.scheduler``: the same events for the same trace).

Pure host-side bookkeeping. The engine drives it:

* ``admit()`` fills free slots from the FIFO queue while the next request's
  prompt (plus one decode page) fits the free-page pool.
* ``ensure_pages(slot, upto)`` backs a slot's cache up to position ``upto``,
  evicting under pool exhaustion (youngest admitted first, the oldest active
  request is never evicted, so it can always run to completion — the bound
  that makes every trace drain). Evicted requests are *requeued at the front*
  with their original prompt, never dropped.
* ``complete(slot)`` frees the slot's pages immediately, so a short request
  never waits on the longest one (no head-of-line blocking).

Everything is deterministic given the submit/step sequence: FIFO admission,
slot order by index, eviction by reverse admission order, pages issued
lowest-id-first. ``events`` records (admit | evict | finish) tuples for
replay tests.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, List, Optional

import numpy as np

from repro_torch.serving.paged_cache import PageAllocator, pages_for


@dataclasses.dataclass
class Request:
    rid: Any
    prompt: np.ndarray  # (Lp,) int32
    max_new: int
    stop: Optional[int] = None  # stop token id (included in the output)


@dataclasses.dataclass
class _Active:
    req: Request
    admit_seq: int
    length: int = 0  # tokens resident in the slot's pages
    pages: List[int] = dataclasses.field(default_factory=list)
    generated: List[int] = dataclasses.field(default_factory=list)
    prefill_done: bool = False

    @property
    def finished(self) -> bool:
        if not self.prefill_done:
            return False
        if len(self.generated) >= self.req.max_new:
            return True
        return bool(self.generated) and self.req.stop is not None and self.generated[-1] == self.req.stop


class Scheduler:
    def __init__(self, slots: int, num_pages: int, page_size: int, max_pages_per_slot: int):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.slots = slots
        self.page_size = page_size
        self.max_pages_per_slot = max_pages_per_slot
        self.alloc = PageAllocator(num_pages)
        self.queue: Deque[Request] = deque()
        self.active: List[Optional[_Active]] = [None] * slots
        self.table = np.zeros((slots, max_pages_per_slot), np.int32)  # 0 = trash
        self.events: List[tuple] = []
        self._seq = 0

    # -- queue / lifecycle --------------------------------------------------

    def submit(self, req: Request) -> None:
        need = pages_for(len(req.prompt) + req.max_new - 1, self.page_size)
        if need > self.alloc.capacity or need > self.max_pages_per_slot:
            raise ValueError(
                f"request {req.rid!r} needs {need} pages; pool capacity is "
                f"{self.alloc.capacity}, per-slot table holds {self.max_pages_per_slot}"
            )
        self.queue.append(req)

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(a is not None for a in self.active)

    def lengths(self) -> np.ndarray:
        return np.asarray([a.length if a else 0 for a in self.active], np.int32)

    def admit(self) -> List[int]:
        """FIFO admission into the lowest free slots while pages allow;
        stops at the first request that does not fit (no reordering)."""
        admitted = []
        while self.queue:
            free = [i for i, a in enumerate(self.active) if a is None]
            if not free:
                break
            req = self.queue[0]
            if self.alloc.available < pages_for(len(req.prompt), self.page_size) + 1:
                break
            self.queue.popleft()
            slot = free[0]
            self.active[slot] = _Active(req=req, admit_seq=self._seq)
            self._seq += 1
            self.table[slot] = 0
            self.events.append(("admit", req.rid, slot))
            admitted.append(slot)
        return admitted

    def complete(self, slot: int) -> None:
        a = self.active[slot]
        self.alloc.free(a.pages)
        self.events.append(("finish", a.req.rid))
        self.active[slot] = None
        self.table[slot] = 0

    # -- pages / eviction ---------------------------------------------------

    def _evict(self, slot: int) -> None:
        a = self.active[slot]
        self.alloc.free(a.pages)
        self.events.append(("evict", a.req.rid, slot))
        self.active[slot] = None
        self.table[slot] = 0
        self.queue.appendleft(a.req)  # original request — requeued, not dropped

    def ensure_pages(self, slot: int, upto: int) -> bool:
        """Back slot ``slot`` through token position ``upto`` (0-based),
        evicting youngest-first under exhaustion. Returns False if the slot
        itself was evicted to make room (callers skip it this step)."""
        a = self.active[slot]
        need = pages_for(upto + 1, self.page_size) - len(a.pages)
        while need > 0:
            got = self.alloc.alloc(need)
            if got is not None:
                base = len(a.pages)
                for k, p in enumerate(got):
                    self.table[slot, base + k] = p
                a.pages.extend(got)
                return True
            victims = sorted(
                (i for i, v in enumerate(self.active) if v is not None),
                key=lambda i: self.active[i].admit_seq,
            )
            if len(victims) <= 1:  # only the oldest left; submit() proved it fits
                raise RuntimeError("page pool exhausted with a single active request")
            youngest = victims[-1]
            self._evict(youngest)
            if youngest == slot:
                return False
        return True
