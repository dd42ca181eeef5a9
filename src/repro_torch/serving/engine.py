"""Serving: prefill and decode steps, ``generate``, and the continuous-batching
engine (counterpart of ``repro.serving.engine``).

``prefill`` and ``decode_step`` are the dense-cache path: the prompt's
forward (K12's, K11's and K6's forward kernels on the card, each with no
gradient) returns the per-layer caches, and each decode step appends one
token (plain torch on either device, as the reference: ``_decode_attend``,
``wkv_decode_step``, ``ssd_decode_step``; K7 for every norm). ``generate``
is greedy or sampled generation over them; the dense caches are written in
place, step by step. The modality frontends are served as the reference
serves them: qwen2-vl's text through ``generate`` (and the engine's dense
fallback), an image through ``prefill`` with ``image_embeds`` and then
``decode_step`` at the positions past it; musicgen only through
``prefill`` and ``decode_step`` on (B, K, S) codebook tokens (``generate``
and the engine raise for it, where the reference's crash).

``paged_step`` serves both chunked prefill (tokens ``(1, C)``) and joint
decode (tokens ``(slots, 1)``) against the shared page pool. Every RMSNorm
goes through kernel K7, every K/V append through K10 and every GQA decode
attention through K9 when the tensors are on the card; the T > 1 prefill
attention is the plain body, as in the reference. MLA (deepseek-v3) pages
its latent rows (``pool_ckv``, ``pool_krope``; both appended in one K10
launch a layer) and attends in the absorbed form, plain torch on every
device as the reference computes it. The pools are updated
**in place** on the device, which replaces JAX's donated, aliased pool
buffers: ``paged_step`` returns the same pool tensors it was given.

:class:`BatchedEngine` pages the attention-family archs and serves
recurrent and hybrid ones (rwkv6, zamba2) by the dense fallback, one
request at a time through ``generate``. It serves a parameter tree or a
packed plane in place (:func:`~repro_torch.parallel.packing.param_view`:
the leaves are views of the plane); ``swap_plane`` hot-swaps the plane at
the next step boundary and ``swap_params`` restores a checkpoint through
:func:`hot_swap`, which retries transient read failures.

Sampling: greedy (``temperature=0``) is ``argmax``, as the reference; a
sampled run draws from a ``torch.Generator`` seeded by ``seed``, so its
tokens differ from JAX's, whose generator differs.
"""
from __future__ import annotations

import time
import zipfile
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.paged_attn import ops as pa_ops
from repro_torch.models import transformer as T
from repro_torch.parallel.packing import Packed, param_view, tree_flatten
from repro_torch.serving.paged_cache import PagedState, init_paged_pools, pages_for, paged_supported, require_paged
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


def prefill(cfg: ModelConfig, params, inputs) -> Tuple[torch.Tensor, dict]:
    """The prompt's forward with no gradient: (logits (B, S, V), the dense caches)."""
    with torch.no_grad():
        logits, aux = T.apply_model(cfg, params, inputs, mode="prefill")
    return logits, aux["caches"]


def decode_step(cfg: ModelConfig, params, tokens, caches, pos) -> Tuple[torch.Tensor, dict]:
    """tokens (B, 1) (audio: (B, K, 1)) at absolute position ``pos`` (an int
    or a 0-dim tensor) against the dense caches, which are written in place
    and returned."""
    with torch.no_grad():
        logits, aux = T.apply_model(cfg, params, dict(tokens=tokens), mode="decode", caches=caches,
                                    decode_pos=pos)
    return logits, aux["caches"]


def _refuse_audio(cfg: ModelConfig, what: str) -> None:
    fe = getattr(cfg, "frontend", None)
    if fe is not None and fe.kind == "audio":
        raise ValueError(f"{cfg.name}: {what} serves text tokens; the audio frontend decodes ({fe.num_codebooks} "
                         "codebooks a step) through prefill and decode_step on (B, K, S) tokens")


def _grow_all(caches: dict, cfg: ModelConfig, target_len: int) -> dict:
    """Every attention cache grown to ``target_len`` slots (stacked or not);
    recurrent caches unchanged."""
    from repro_torch.models.layers.attention import grow_cache

    out = {}
    for si, (kind, _) in enumerate(T.segments(cfg)):
        key = f"seg{si}"
        if key not in caches:
            continue
        c = caches[key]
        out[key] = grow_cache(c, target_len) if kind in ("attn", "moe", "shared_attn") else c
    return out


def _sample(logits, temperature: float, generator: Optional[torch.Generator]):
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _device_of(params) -> torch.device:
    if isinstance(params, Packed):
        return params.buffers[0].device
    leaves, _ = tree_flatten(params)
    return leaves[0].device


def generate(cfg: ModelConfig, params, prompt, max_new: int, temperature: float = 0.0, seed: int = 0) -> np.ndarray:
    """Greedy or sampled generation: ``prompt`` (B, S0) int tokens (numpy or a
    tensor) -> (B, max_new) int32 numpy. Runs on the device of ``params`` (a
    tree or a plane); the tokens stay there until the end. Text only: an
    audio arch raises."""
    if prompt.ndim != 2:
        raise ValueError(f"prompt must be (batch, seq) int tokens, got shape {tuple(prompt.shape)}")
    if prompt.shape[0] == 0 or prompt.shape[1] == 0:
        raise ValueError(f"empty prompt batch: shape {tuple(prompt.shape)}")
    if max_new < 1:
        raise ValueError(f"max_new must be >= 1, got {max_new}")
    _refuse_audio(cfg, "generate")
    device = _device_of(params)
    if not isinstance(prompt, torch.Tensor):
        prompt = torch.from_numpy(np.ascontiguousarray(prompt, np.int32))
    prompt = prompt.to(device=device, dtype=torch.int32)
    if isinstance(params, Packed):  # served through its views, built once
        params = param_view(params)
    logits, caches = prefill(cfg, params, dict(tokens=prompt))
    s0 = prompt.shape[1]
    caches = _grow_all(caches, cfg, s0 + max_new)
    gen = torch.Generator(device=device).manual_seed(seed) if temperature != 0.0 else None
    next_tok = _sample(logits[:, -1], temperature, gen)[:, None].to(torch.int32)
    out = [next_tok]
    for i in range(max_new - 1):
        logits, caches = decode_step(cfg, params, next_tok, caches, s0 + i)
        next_tok = _sample(logits[:, -1], temperature, gen)[:, None].to(torch.int32)
        out.append(next_tok)
    return torch.cat(out, dim=1).cpu().numpy()


def hot_swap(path: str, template, retries: int = 3, backoff: float = 0.05,
             _sleep: Callable[[float], None] = time.sleep):
    """Restore a params checkpoint for serving, retrying transient read
    failures (a trainer mid-save, a slow network filesystem) with bounded
    exponential backoff: attempt k sleeps ``backoff * 2**k``. Structural
    mismatches (``KeyError``: wrong template) are not retried: they cannot
    heal by waiting. Raises the last transient error after ``retries``
    failed attempts."""
    from repro_torch import checkpoint

    last = None
    for attempt in range(max(int(retries), 1)):
        try:
            return checkpoint.restore(path, template)
        except (OSError, EOFError, ValueError, zipfile.BadZipFile) as e:
            last = e
            _sleep(backoff * (2**attempt))
    raise last


class BatchedEngine:
    """Continuous-batching serving engine.

    Attention-family text archs run paged: fixed-size pages in a global pool,
    per-slot page tables, chunked prefill filling pages incrementally, and
    one joint decode forward per step across every active slot. A request
    admits, decodes exactly its own ``max_new`` tokens, and frees its pages
    the moment it finishes. Recurrent and hybrid archs (``paged="auto"``
    picks by :func:`paged_supported`) fall back to per-request ``generate``
    in :meth:`run`: exact logits and exactly ``max_new`` tokens each; so
    does qwen2-vl (M-RoPE and the vision frontend; text requests). An audio
    arch raises: it has no engine.
    Greedy sampling (``torch.argmax`` on the device).

    ``params`` is a nested tree or a packed plane with no lead axis, served
    in place (see :meth:`swap_plane`). ``device`` defaults to ``"cuda"``
    and raises when there is no GPU; the weights must already live there.
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
        paged="auto",
        device="cuda",
    ):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2 (one prompt token + one generated), got {max_len}")
        if page_size < 1 or chunk < 1:
            raise ValueError(f"page_size and chunk must be >= 1, got {page_size}, {chunk}")
        _refuse_audio(cfg, "BatchedEngine")
        self.paged = paged_supported(cfg) if paged == "auto" else bool(paged)
        if self.paged:
            require_paged(cfg)
            a = cfg.attention
            if a.kind != "mla":  # MLA's absorbed decode is plain torch, not K9
                pa_ops.check_decode_shape(a.num_heads // a.num_kv_heads, a.head_dim)
        self.device = resolve_device(device)
        self._plane: Optional[Packed] = None
        self._pending_plane: Optional[Packed] = None
        if isinstance(params, Packed):
            self._plane, self.params = params, param_view(params)
        else:
            self.params = params
        leaf = self.params["tok_emb"]
        if leaf.device != self.device:
            raise ValueError(f"params live on {leaf.device}, engine device is {self.device}")
        self.cfg = cfg
        self.slots, self.max_len = slots, max_len
        self.results: dict = {}
        self.queue: list = []  # the dense fallback's queue
        self.steps = 0
        if self.paged:
            self.page_size = page_size
            self.chunk = chunk
            self.max_pages = pages_for(max_len, page_size)
            # default pool: full residency for every slot, plus the trash page
            self.num_pages = int(num_pages) if num_pages is not None else slots * self.max_pages + 1
            self.pools = init_paged_pools(cfg, self.num_pages, page_size, device=self.device)
            self.sched = Scheduler(slots, self.num_pages, page_size, self.max_pages)

    # -- request intake ------------------------------------------------------

    def _known(self, req_id) -> bool:
        if req_id in self.results or any(rid == req_id for rid, *_ in self.queue):
            return True
        if not self.paged:
            return False
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
        if self.paged:
            self.sched.submit(Request(req_id, prompt.astype(np.int32), int(max_new), stop))
        else:
            self.queue.append((req_id, prompt.astype(np.int32), int(max_new), stop))

    # -- served parameters ---------------------------------------------------

    @property
    def plane(self) -> Optional[Packed]:
        return self._plane

    def swap_plane(self, plane: Packed) -> None:
        """Queue a zero-copy hot-swap of the served plane, applied at the next
        :meth:`step` boundary: a step in flight finishes on the old plane and
        no step mixes weights. The plane's buffers are served as they are (no
        copy), so a live anchor plane of a running ``Experiment`` costs
        nothing but the swap."""
        if self._plane is None:
            raise ValueError("engine was built on a per-leaf tree; swap_plane needs a plane-resident engine")
        if not isinstance(plane, Packed):
            raise TypeError(f"swap_plane takes a Packed plane, got {type(plane).__name__}")
        if plane.lead_shape != ():
            raise ValueError(f"serving plane must have no lead axis, got {plane.lead_shape}")
        if plane.layout != self._plane.layout:
            raise ValueError("swap_plane: layout mismatch with the served plane")
        if plane.buffers[0].device != self.device:
            raise ValueError(f"swap_plane: the plane lives on {plane.buffers[0].device}, engine device is {self.device}")
        self._pending_plane = plane

    def swap_params(self, path: str, retries: int = 3, backoff: float = 0.05) -> None:
        """Hot-swap the served parameters from a checkpoint (:func:`hot_swap`).
        On a plane-resident engine the checkpoint is restored onto the served
        layout and applied at the same step boundary as :meth:`swap_plane`."""
        if self._plane is not None:
            self.swap_plane(hot_swap(path, self._plane, retries=retries, backoff=backoff))
        else:
            self.params = hot_swap(path, self.params, retries=retries, backoff=backoff)

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
        """One scheduler tick: apply a pending plane swap, complete finished
        requests (freeing their pages), admit, advance every prefilling slot
        by one chunk, then run one joint decode across active slots. Returns
        the request ids completed this tick."""
        if not self.paged:
            raise RuntimeError("step() drives the paged engine; the dense fallback runs via run()")
        if self._pending_plane is not None:  # between steps, never mid-step
            self._plane, self.params = self._pending_plane, param_view(self._pending_plane)
            self._pending_plane = None
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
        if self.paged:
            while self.sched.busy:
                self.step()
            return self.results
        # dense fallback: solo decode per request (exact per-request logits and
        # exactly max_new steps each)
        while self.queue:
            rid, prompt, max_new, stop = self.queue.pop(0)
            row = generate(self.cfg, self.params, prompt[None], max_new)[0]
            if stop is not None:
                hits = np.nonzero(row == stop)[0]
                if hits.size:
                    row = row[: hits[0] + 1]
            self.results[rid] = row
        return self.results
