"""Host offload of packed planes with double-buffered chunk streaming
(counterpart of ``repro.parallel.offload``).

The paper hides the boundary collective behind the τ local steps; the same
window hides host↔device traffic. With ``AlgoConfig.offload`` the optimizer
state planes and the anchor-shaped planes (the strategy's vars, the
in-flight collective) live in host memory between boundaries as a
:class:`HostPlane`: each dtype bucket split into fixed-size chunks stacked
along a leading axis, ``(num_chunks,) + lead + (chunk_elems,)``, zero-padded
to the grid. They come back where they are consumed:

* the optimizer state, every local step, through :func:`streamed_update`:
  per bucket, chunk i+1 of each state plane is copied into one of two
  device staging chunks while the fused optimizer kernel updates chunk i in
  the other, and the updated chunk goes back to its host stack. The kernel
  runs on a window of the plane (K1/K2's window form: the chunk's columns of
  x and g, the staged state chunk), so the update is bitwise the
  plane-resident one: it is elementwise, and the zero tail of the last
  chunk is never touched;
* the anchor-shaped planes whole, by :func:`tree_restore` before they are
  read and :func:`tree_offload` after the boundary has written them.

On a CUDA device the host stacks are pinned (page-locked with
``cudaHostRegister`` when they are made, so a stack takes its own size and
not the next power of two), every host↔device copy is ``non_blocking`` on a
copy stream of its own, one for each direction so both run at once, and
events order the copies against the compute stream: a chunk's kernel waits
for its copy in, its copy out waits for the kernel, and the copy into a
staging slot waits for the copy out of the chunk that used it before. Every
tensor a copy stream touches is recorded on that stream for the caching
allocator. A :class:`HostPlane` remembers the event of its last write, which
a later copy in waits on, and :meth:`HostPlane.host_ready` blocks on before
the host reads the stacks. On the CPU the stream is structural only, as on
the reference's single-memory backend: the same chunk grid and the same
copies, made at once. A CUDA state whose stacks are not pinned raises:
a ``non_blocking`` copy from pageable memory would block the host.

Chunk shapes are static: :class:`OffloadPlan` is the reference's table,
grid for grid, derived from the layout's bucket sizes and dtypes.

The tree walks (:func:`tree_offload`, :func:`tree_restore`, ...) go
through NamedTuples (their attributes kept: a drained gossip value's host
phase), tuples, lists and dicts, and through any node with a
``map_planes(fn, other)`` method: the rank boundaries' in-flight kinds
(:mod:`repro_torch.core.strategy`), whose anchor-shaped planes move while
the f32 wire buffer and what a pending collective reads stay on the
device. On a worker mesh each rank's optimizer state holds its rows (the
stacks' lead is r) and its plan is the same layout's. One walk maps a plane
held at two places of the tree (a rank boundary's anchor is both vars.z and
the in-flight value's base) to one host plane, and back.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.parallel.packing import LANE, Layout, Packed, _dtype, _round_up

HOST_KIND = "pinned_host"
DEFAULT_CHUNK_MB = 64.0


def host_memory_kind(device="cuda"):
    """``"pinned_host"`` where ``device`` has a host memory space of its own
    (a CUDA device: the stacks are page-locked and the copies asynchronous),
    else ``None`` (the CPU: the stream is structural)."""
    device = torch.device(device)
    return HOST_KIND if device.type == "cuda" and torch.cuda.is_available() else None


# ---------------------------------------------------------------------------
# Static chunk table


@dataclasses.dataclass(frozen=True)
class OffloadPlan:
    """Per-bucket chunk grid, aligned with ``Layout.bucket_sizes``:
    ``chunk_elems[b]`` a LANE multiple, ``num_chunks[b] · chunk_elems[b] ≥
    bucket_sizes[b]``. One plan serves the worker-stacked ``(m, n)`` state
    buckets, the flat ``(n,)`` anchor and the f32 ``with_dtype`` shadows."""

    chunk_elems: Tuple[int, ...]
    num_chunks: Tuple[int, ...]

    @classmethod
    def for_layout(cls, layout: Layout, chunk_mb: float = DEFAULT_CHUNK_MB) -> "OffloadPlan":
        chunk_elems, num_chunks = [], []
        for n, dt in zip(layout.bucket_sizes, layout.bucket_dtypes):
            c = int(chunk_mb * (1 << 20)) // _dtype(dt).itemsize
            c = max(LANE, (c // LANE) * LANE)
            c = min(c, _round_up(max(n, 1)))
            chunk_elems.append(c)
            num_chunks.append(-(-max(n, 1) // c))
        return cls(tuple(chunk_elems), tuple(num_chunks))

    def grid(self, bucket: int) -> Tuple[int, int]:
        """(num_chunks, chunk_elems) for one bucket."""
        return self.num_chunks[bucket], self.chunk_elems[bucket]


def _windows(n: int, num_chunks: int, chunk_elems: int):
    """(i, c0, w): chunk i covers the columns [c0, c0 + w) of the bucket."""
    for i in range(num_chunks):
        c0 = i * chunk_elems
        yield i, c0, max(0, min(chunk_elems, n - c0))


def chunk_buffer(buf: torch.Tensor, num_chunks: int, chunk_elems: int) -> torch.Tensor:
    """``lead + (n,)`` → ``(num_chunks,) + lead + (chunk_elems,)``: the flat
    axis zero-padded to the chunk grid and split, the chunk axis moved to
    the front. Exact inverse of :func:`unchunk_buffer`."""
    lead, n = tuple(buf.shape[:-1]), buf.shape[-1]
    out = torch.zeros((num_chunks,) + lead + (chunk_elems,), dtype=buf.dtype, device=buf.device)
    for i, c0, w in _windows(n, num_chunks, chunk_elems):
        out[i, ..., :w] = buf[..., c0 : c0 + w]
    return out


def unchunk_buffer(chunks: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`chunk_buffer`: the pad dropped, the flat axis back."""
    num_chunks, chunk_elems = chunks.shape[0], chunks.shape[-1]
    return torch.movedim(chunks, 0, -2).reshape(tuple(chunks.shape[1:-1]) + (num_chunks * chunk_elems,))[..., :n]


# ---------------------------------------------------------------------------
# Pinned host stacks and the copy streams


def _unpin(ptr: int, storage) -> None:
    # a copy may still read or write the pages: let the device finish first.
    # ``storage`` keeps the pages mapped until they are unregistered.
    torch.cuda.synchronize()
    torch.cuda.cudart().cudaHostUnregister(ptr)
    del storage


def _host_stack(shape, dtype: torch.dtype, pinned: bool) -> torch.Tensor:
    """A host tensor for a chunk stack, page-locked when ``pinned``: its
    pages are first touched by a parallel fill (registering untouched
    memory faults it in on one thread), then registered."""
    t = torch.empty(shape, dtype=dtype)
    if pinned and t.numel():
        t.zero_()
        err = int(torch.cuda.cudart().cudaHostRegister(t.data_ptr(), t.numel() * t.element_size(), 0))
        if err != 0:
            raise RuntimeError(f"cudaHostRegister of {t.numel() * t.element_size()} bytes failed: CUDA error {err}")
        weakref.finalize(t, _unpin, t.data_ptr(), t.untyped_storage()).atexit = False
    return t


class _Link:
    """The two copy streams of one CUDA device: host→device and device→host."""

    def __init__(self, device: torch.device):
        self.h2d = torch.cuda.Stream(device)
        self.d2h = torch.cuda.Stream(device)


_LINKS: Dict[int, _Link] = {}


def _link(device) -> Optional[_Link]:
    """The device's copy streams, or None on the CPU (copies run at once)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _LINKS:
        _LINKS[index] = _Link(torch.device("cuda", index))
    return _LINKS[index]


def _event(stream) -> torch.cuda.Event:
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


class Pending:
    """Copies in flight to a device: :meth:`wait` makes the device's current
    stream wait for them (the host does not block). On the CPU, nothing."""

    def __init__(self, device=None, events=()):
        self.device = device
        self.events = list(events)

    def add(self, other: "Pending") -> None:
        self.device = self.device or other.device
        self.events += other.events

    def wait(self) -> None:
        if self.events:
            stream = torch.cuda.current_stream(self.device)
            for ev in self.events:
                stream.wait_event(ev)
        self.events = []


# ---------------------------------------------------------------------------
# HostPlane: the between-boundaries form of a Packed plane


class HostPlane:
    """Chunked, host-resident form of a :class:`Packed` plane: one
    ``(num_chunks,) + lead + (chunk_elems,)`` stack per bucket (pinned when
    ``device`` is a CUDA device), its layout and plan, and the device its
    resident form lives on."""

    __slots__ = ("chunks", "layout", "plan", "device", "written")

    def __init__(self, chunks, layout: Layout, plan: OffloadPlan, device="cpu", written=None):
        self.chunks = tuple(chunks)
        self.layout = layout
        self.plan = plan
        self.device = torch.device(device)
        self.written = written  # CUDA event of the last copy into the stacks

    @property
    def nbytes(self) -> int:
        """Total chunked (padded) bytes: the host residency cost."""
        return sum(ch.numel() * ch.element_size() for ch in self.chunks)

    @property
    def lead_shape(self) -> Tuple[int, ...]:
        return tuple(self.chunks[0].shape[1:-1]) if self.chunks else ()

    def host_ready(self) -> "HostPlane":
        """Block the host until the last copy into the stacks has landed."""
        if self.written is not None:
            self.written.synchronize()
        return self

    def __repr__(self):
        grids = list(zip(self.plan.num_chunks, self.plan.chunk_elems))
        return f"HostPlane(lead={self.lead_shape}, grids={grids}, device={self.device})"


def _check_pinned(hp: HostPlane) -> None:
    if not all(ch.is_pinned() for ch in hp.chunks if ch.numel()):
        raise ValueError("a HostPlane streamed to a CUDA device must have pinned stacks (non_blocking copies "
                         "from pageable memory block the host)")


def offload_plane(px: Packed, plan: OffloadPlan, into: Optional[HostPlane] = None) -> HostPlane:
    """Chunk a resident plane into host stacks (the D2H leg): into ``into``'s
    stacks where their shapes match, else new ones (pinned on CUDA)."""
    device = px.buffers[0].device
    link = _link(device)
    chunks = []
    if link is not None:
        link.d2h.wait_event(_event(torch.cuda.current_stream(device)))
        if into is not None and into.written is not None:
            link.d2h.wait_event(into.written)
    for b, buf in enumerate(px.buffers):
        k, c = plan.grid(b)
        lead, n = tuple(buf.shape[:-1]), buf.shape[-1]
        shape = (k,) + lead + (c,)
        stack = None
        if into is not None and b < len(into.chunks):
            old = into.chunks[b]
            if tuple(old.shape) == shape and old.dtype == buf.dtype:
                stack = old
        if stack is None:
            stack = _host_stack(shape, buf.dtype, pinned=link is not None)
            last = n - (k - 1) * c
            stack[k - 1, ..., last:].zero_()
        if link is None:
            for i, c0, w in _windows(n, k, c):
                stack[i, ..., :w].copy_(buf[..., c0 : c0 + w])
        else:
            buf.record_stream(link.d2h)
            with torch.cuda.stream(link.d2h):
                for i, c0, w in _windows(n, k, c):
                    if lead:  # a strided window: made contiguous on the device, its tail zero
                        tmp = torch.zeros(lead + (c,), dtype=buf.dtype, device=device)
                        tmp[..., :w].copy_(buf[..., c0 : c0 + w])
                        stack[i].copy_(tmp, non_blocking=True)
                    else:
                        stack[i, :w].copy_(buf[c0 : c0 + w], non_blocking=True)
        chunks.append(stack)
    written = _event(link.d2h) if link is not None else None
    return HostPlane(chunks, px.layout, plan, device, written)


def restore_plane_async(hp: HostPlane) -> Tuple[Packed, Pending]:
    """Start bringing a host plane back to its device (the H2D leg); the
    plane may be read once ``pending.wait()`` has run on the reading stream."""
    link = _link(hp.device)
    buffers = []
    if link is not None:
        _check_pinned(hp)
        # the planes are allocated on the compute stream: copy into them after its earlier work
        link.h2d.wait_event(_event(torch.cuda.current_stream(hp.device)))
        if hp.written is not None:
            link.h2d.wait_event(hp.written)
    for b, stack in enumerate(hp.chunks):
        k, c = hp.plan.grid(b)
        n = hp.layout.bucket_sizes[b]
        lead = tuple(stack.shape[1:-1])
        out = torch.empty(lead + (n,), dtype=stack.dtype, device=hp.device)
        if link is None:
            for i, c0, w in _windows(n, k, c):
                out[..., c0 : c0 + w].copy_(stack[i, ..., :w])
        else:
            out.record_stream(link.h2d)
            with torch.cuda.stream(link.h2d):
                for i, c0, w in _windows(n, k, c):
                    if lead:  # a whole chunk in, then its window into place on the device
                        tmp = torch.empty(lead + (c,), dtype=stack.dtype, device=hp.device)
                        tmp.copy_(stack[i], non_blocking=True)
                        out[..., c0 : c0 + w].copy_(tmp[..., :w])
                    else:
                        out[c0 : c0 + w].copy_(stack[i, :w], non_blocking=True)
        buffers.append(out)
    pending = Pending(hp.device, [_event(link.h2d)] if link is not None else [])
    return Packed(buffers, hp.layout), pending


def restore_plane(hp: HostPlane) -> Packed:
    """Bring a host plane back device-resident (the H2D leg), ordered before
    whatever the current stream runs next."""
    px, pending = restore_plane_async(hp)
    pending.wait()
    return px


# ---------------------------------------------------------------------------
# State trees (NamedTuples, tuples, lists, dicts; tensors and None pass through)


def _map(fn: Callable, tree, other=None, memo=None):
    """Rebuild ``tree`` with ``fn(node, other_node)`` at every Packed and
    HostPlane node; ``other`` is a tree of the same structure (or None).
    With ``memo`` (a dict) a node met twice maps once."""
    if isinstance(tree, (Packed, HostPlane)):
        if memo is None:
            return fn(tree, other)
        if id(tree) not in memo:
            memo[id(tree)] = (tree, fn(tree, other))  # the node kept alive: its id stays its own
        return memo[id(tree)][1]
    if hasattr(tree, "map_planes"):  # a rank boundary's in-flight kind
        return tree.map_planes(lambda n, o: _map(fn, n, o, memo), other)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = type(tree)(*(_map(fn, v, _field(other, f), memo) for f, v in zip(tree._fields, tree)))
        if getattr(tree, "__dict__", None):
            out.__dict__.update(tree.__dict__)
        return out
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v, _item(other, i), memo) for i, v in enumerate(tree))
    if isinstance(tree, dict):
        return {k: _map(fn, v, other.get(k) if isinstance(other, dict) else None, memo) for k, v in tree.items()}
    return tree


def _field(node, name):
    return getattr(node, name, None) if isinstance(node, tuple) and hasattr(node, "_fields") else None


def _item(node, i):
    return node[i] if isinstance(node, (tuple, list)) and i < len(node) else None


def _nodes(tree) -> List:
    found: List = []
    _map(lambda n, _: found.append(n) or n, tree)
    return found


def is_offloaded(tree) -> bool:
    """True when any plane in ``tree`` is a :class:`HostPlane`."""
    return any(isinstance(n, HostPlane) for n in _nodes(tree))


def tree_offload(tree, plan: OffloadPlan, into=None):
    """Offload every ``Packed`` plane in a state tree (vars, inflight, the
    optimizer state); other leaves (scalars, masks, tensors) pass through.
    ``into``: the tree's previous host form, whose stacks are reused. A
    plane met twice becomes one host plane."""
    return _map(lambda n, o: offload_plane(n, plan, o if isinstance(o, HostPlane) else None)
                if isinstance(n, Packed) else n, tree, into, memo={})


def tree_restore_async(tree):
    """Start restoring every :class:`HostPlane` in ``tree``; returns the
    resident tree and a :class:`Pending` for all of its copies."""
    pending = Pending()

    def restore(n, _):
        if not isinstance(n, HostPlane):
            return n
        px, p = restore_plane_async(n)
        pending.add(p)
        return px

    return _map(restore, tree, memo={}), pending


def tree_restore(tree):
    """Restore every :class:`HostPlane` in a state tree to a resident
    ``Packed`` plane (ordered before the current stream's next work)."""
    out, pending = tree_restore_async(tree)
    pending.wait()
    return out


def plan_of(tree) -> Optional[OffloadPlan]:
    """The :class:`OffloadPlan` of the first HostPlane in ``tree``."""
    return next((n.plan for n in _nodes(tree) if isinstance(n, HostPlane)), None)


def host_nbytes(tree) -> int:
    """Total host-resident bytes across every HostPlane in ``tree``, each
    counted once (a rank boundary's anchor is vars.z and the in-flight
    value's base: one host plane)."""
    return sum(n.nbytes for n in {id(n): n for n in _nodes(tree) if isinstance(n, HostPlane)}.values())


# ---------------------------------------------------------------------------
# Double-buffered streamed optimizer update


def streamed_update(apply_chunk: Callable, state: Tuple[HostPlane, ...], px: Packed, pg: Packed) -> None:
    """Run ``apply_chunk(x_w, g_w, *state_w)`` over the plane chunk by chunk,
    in place: ``x_w``, ``g_w`` the chunk's columns of a bucket of x and g,
    ``state_w`` the same columns of each state plane's staged chunk. Per
    bucket, chunk i+1 of each state plane is copied into one of two device
    staging chunks while chunk i is applied in the other; the applied chunk
    goes back to its host stack. The state planes are updated in their host
    stacks; x in place."""
    if not state:
        raise ValueError("streamed_update needs at least one host state plane")
    plan = state[0].plan
    device = px.buffers[0].device
    link = _link(device)
    compute = torch.cuda.current_stream(device) if link is not None else None
    for b, (x, g) in enumerate(zip(px.buffers, pg.buffers)):
        k, c = plan.grid(b)
        n = x.shape[-1]
        stacks = [hp.chunks[b] for hp in state]
        staged = [[torch.empty(st.shape[1:], dtype=st.dtype, device=device) for _ in range(2)] for st in stacks]
        arrived: List = [None, None]  # per slot: the copy in of its current chunk
        freed: List = [None, None]  # per slot: the copy out of its last chunk
        if link is not None:
            # the staging chunks come from the compute stream's pool: fill them after its earlier work
            link.h2d.wait_event(_event(compute))
            for hp in state:
                _check_pinned(hp)
                if hp.written is not None:
                    link.h2d.wait_event(hp.written)
            for pair in staged:
                for s in pair:
                    s.record_stream(link.h2d)
                    s.record_stream(link.d2h)

        def fetch(i):
            slot = i % 2
            if link is None:
                for pair, st in zip(staged, stacks):
                    pair[slot].copy_(st[i])
                return
            with torch.cuda.stream(link.h2d):
                if freed[slot] is not None:
                    link.h2d.wait_event(freed[slot])
                for pair, st in zip(staged, stacks):
                    pair[slot].copy_(st[i], non_blocking=True)
                arrived[slot] = _event(link.h2d)

        fetch(0)
        for i, c0, w in _windows(n, k, c):
            slot = i % 2
            if i + 1 < k:
                fetch(i + 1)  # in flight while chunk i is applied
            if link is not None:
                compute.wait_event(arrived[slot])
            apply_chunk(x[..., c0 : c0 + w], g[..., c0 : c0 + w], *(pair[slot][..., :w] for pair in staged))
            if link is None:
                for pair, st in zip(staged, stacks):
                    st[i].copy_(pair[slot])
                continue
            done = _event(compute)
            with torch.cuda.stream(link.d2h):
                link.d2h.wait_event(done)
                for pair, st in zip(staged, stacks):
                    st[i].copy_(pair[slot], non_blocking=True)
                freed[slot] = _event(link.d2h)
    if link is not None:
        written = _event(link.d2h)
        for hp in state:
            hp.written = written


# ---------------------------------------------------------------------------
# Stream accounting


def stream_roundtrip_bytes(state_tree) -> int:
    """Bytes of ONE H2D + D2H round trip of every host plane in
    ``state_tree``. Optimizer-state planes make ``tau`` trips a round (one a
    local step), anchor/inflight/vars one; callers apply the multiplier."""
    return 2 * host_nbytes(state_tree)


def staging_bytes(plan: OffloadPlan, layout: Layout, state_planes: int) -> int:
    """Device bytes of the double buffer a worker row: 2 staging chunks per
    state plane per bucket."""
    return sum(2 * state_planes * plan.chunk_elems[b] * _dtype(dt).itemsize
               for b, dt in enumerate(layout.bucket_dtypes))
