"""Paged continuous-batching serving engine (counterpart of the paged path of
``repro.serving.engine``).

``paged_step`` serves both chunked prefill (tokens ``(1, C)``) and joint
decode (tokens ``(slots, 1)``) against the shared page pool. Every RMSNorm
goes through kernel K7, every K/V append through K10 and every decode
attention through K9 when the tensors are on the card; the T > 1 prefill
attention is the plain body, as in the reference.

The pools are updated **in place** on the device: the append kernel writes
the new K/V rows into their pages, which replaces JAX's donated, aliased
pool buffers. ``paged_step`` therefore returns the same pool tensors it was
given.

The dense fallback, ``generate``, ``hot_swap``, ``swap_plane`` and serving
off a packed plane come in later slices; the constructor raises on an arch
that :func:`paged_supported` rejects.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.serving.paged_cache import PagedState, init_paged_pools, pages_for, paged_supported
from repro_torch.serving.scheduler import Request, Scheduler


def resolve_device(device) -> torch.device:
    """``device`` as a concrete torch.device; raises if it names a GPU and
    there is none (nothing silently moves to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def paged_step(
    cfg: ModelConfig, params, tokens, caches, page_tables, lengths
) -> Tuple[torch.Tensor, dict]:
    """One paged-attention step: append ``tokens``' K/V into the slots' pages
    (in place) and attend. tokens (S, T) — T == 1 is joint decode across
    slots, T > 1 a prefill chunk. ``lengths`` is each slot's resident token
    count, i.e. the position of tokens[:, 0]; idle rows carry a zero (trash)
    page-table row and length 0."""
    t = tokens.shape[1]
    positions = lengths[:, None] + torch.arange(t, dtype=torch.int32, device=lengths.device)[None, :]
    inputs = dict(tokens=tokens, positions=positions)
    logits, aux = T.apply_model(
        cfg, params, inputs, mode="decode", caches=caches, paged=PagedState(page_tables, lengths)
    )
    return logits, aux["caches"]


class BatchedEngine:
    """Continuous-batching serving engine over a paged KV pool.

    Fixed-size pages in a global pool, per-slot page tables, chunked prefill
    filling pages incrementally, and one joint decode forward per step across
    every active slot. A request admits, decodes exactly its own ``max_new``
    tokens, and frees its pages the moment it finishes. Greedy sampling
    (``torch.argmax`` on the device).

    ``device`` defaults to ``"cuda"`` and raises when there is no GPU;
    ``params`` must already live on that device.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        slots: int = 4,
        max_len: int = 256,
        *,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        chunk: int = 32,
        device="cuda",
    ):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2 (one prompt token + one generated), got {max_len}")
        if page_size < 1 or chunk < 1:
            raise ValueError(f"page_size and chunk must be >= 1, got {page_size}, {chunk}")
        if not paged_supported(cfg):
            raise ValueError(f"{getattr(cfg, 'name', cfg)}: the port serves GQA attention-only text archs (paged)")
        self.device = resolve_device(device)
        leaf = params["tok_emb"]
        if leaf.device != self.device:
            raise ValueError(f"params live on {leaf.device}, engine device is {self.device}")
        self.cfg = cfg
        self.params = params
        self.slots, self.max_len = slots, max_len
        self.page_size = page_size
        self.chunk = chunk
        self.max_pages = pages_for(max_len, page_size)
        # default pool: full residency for every slot, plus the trash page
        self.num_pages = int(num_pages) if num_pages is not None else slots * self.max_pages + 1
        self.pools = init_paged_pools(cfg, self.num_pages, page_size, device=self.device)
        self.sched = Scheduler(slots, self.num_pages, page_size, self.max_pages)
        self.results: dict = {}
        self.steps = 0

    # -- request intake ------------------------------------------------------

    def _known(self, req_id) -> bool:
        if req_id in self.results:
            return True
        return any(r.rid == req_id for r in self.sched.queue) or any(
            a is not None and a.req.rid == req_id for a in self.sched.active
        )

    def submit(self, req_id, prompt: np.ndarray, max_new: int, stop: Optional[int] = None):
        prompt = np.asarray(prompt)
        if prompt.ndim != 1 or prompt.shape[0] == 0:
            raise ValueError(
                f"request {req_id!r}: prompt must be a non-empty 1-D token array, got shape {tuple(prompt.shape)}"
            )
        if max_new < 1:
            raise ValueError(f"request {req_id!r}: max_new must be >= 1, got {max_new}")
        if prompt.shape[0] + max_new > self.max_len:
            raise ValueError(
                f"request {req_id!r}: prompt ({prompt.shape[0]}) + max_new ({max_new}) exceeds "
                f"engine max_len ({self.max_len})"
            )
        if self._known(req_id):
            raise ValueError(f"duplicate request id {req_id!r}")
        self.sched.submit(Request(req_id, prompt.astype(np.int32), int(max_new), stop))

    # -- paged engine loop ---------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        # non_blocking: a pageable source is staged at once, and the copy
        # does not wait for the work already queued on the stream
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device, non_blocking=True)

    def _run_step(self, tokens, page_tables, lengths) -> torch.Tensor:
        logits, self.pools = paged_step(
            self.cfg, self.params, self._to_device(tokens), self.pools,
            self._to_device(page_tables), self._to_device(lengths),
        )
        return logits

    def step(self) -> list:
        """One scheduler tick: complete finished requests (freeing their
        pages), admit, advance every prefilling slot by one chunk, then run
        one joint decode across active slots. Returns the request ids
        completed this tick."""
        sched = self.sched
        finished = []
        for i in range(self.slots):
            a = sched.active[i]
            if a is not None and a.finished:
                self.results[a.req.rid] = np.asarray(a.generated, np.int32)
                finished.append(a.req.rid)
                sched.complete(i)
        sched.admit()
        # chunked prefill: each prefilling slot advances one chunk (B=1 call)
        for i in range(self.slots):
            a = sched.active[i]
            if a is None or a.prefill_done:
                continue
            start = a.length
            end = min(start + self.chunk, len(a.req.prompt))
            if not sched.ensure_pages(i, end - 1):
                continue  # evicted itself to make room; requeued
            toks = np.zeros((1, self.chunk), np.int32)
            toks[0, : end - start] = a.req.prompt[start:end]
            logits = self._run_step(toks, sched.table[i : i + 1], np.asarray([start], np.int32))
            a.length = end
            if end == len(a.req.prompt):
                a.prefill_done = True
                a.generated.append(int(torch.argmax(logits[0, end - start - 1])))
        # joint decode across every decode-ready slot
        dec = []
        for i in range(self.slots):
            a = sched.active[i]
            if a is None or not a.prefill_done or a.finished:
                continue
            if sched.ensure_pages(i, a.length):  # the append position
                dec.append((i, a.admit_seq))
        dec = [
            i for i, seq in dec
            if sched.active[i] is not None and sched.active[i].admit_seq == seq
        ]
        if dec:
            toks = np.zeros((self.slots, 1), np.int32)
            tables = np.zeros_like(sched.table)  # idle rows → trash page, length 0
            lens = np.zeros((self.slots,), np.int32)
            for i in dec:
                a = sched.active[i]
                toks[i, 0] = a.generated[-1]
                tables[i] = sched.table[i]
                lens[i] = a.length
            logits = self._run_step(toks, tables, lens)
            nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
            for i in dec:
                a = sched.active[i]
                a.length += 1
                a.generated.append(int(nxt[i]))
        self.steps += 1
        return finished

    def run(self) -> dict:
        while self.sched.busy:
            self.step()
        return self.results
