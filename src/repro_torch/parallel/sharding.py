"""The logical mesh over ``torch.distributed`` ranks (counterpart of
``repro.parallel.sharding``): the worker axis and, within a worker, fsdp
(ZeRO-3 on the packed plane) with the anchor stored once over every axis.

**The rule table.** :data:`LOGICAL_RULES` maps each logical axis to mesh
axes, as the reference's does, key for key; :func:`spec_for`,
:func:`fit_spec`, :func:`anchor_axes`, :func:`sharding_for` and
:func:`tree_shardings` are its functions on plain tuples (a spec is the
tuple of the reference's ``PartitionSpec``). :func:`constrain` is a no-op:
there is no partitioner here, and the model code shards nothing inside a
worker (tensor parallelism is ROADMAP item 10c's second part). What the
table decides here is the packed plane's placement: ``flat_param`` (x and
the optimizer state) over ``fsdp``, ``anchor_flat`` (z, v, the in-flight
anchor, the avg-rebase average) over every axis (:func:`plane_split`).

**The mesh.** A mesh of W·F ranks (one process a rank, one card each under
NCCL, or CPU ranks under gloo) lays ranks out as the reference lays out its
devices (``devices.reshape(workers, fsdp, tensor)``): global rank w·F + f
is worker index w, fsdp index f. :class:`WorkerMesh` keeps ``size``,
``rank`` and ``group`` for the worker axis (W, w, and the **worker group**
of the W ranks that share column slice f: every worker reduction runs over
it) and adds ``fsdp``, ``fsdp_rank`` and ``fsdp_group`` (the F ranks that
hold one worker's columns). Rank (w, f) holds the rows ``[w·m/W,
(w+1)·m/W)`` of every ``(m, n)`` bucket and, with F > 1, their column slice
f (a :class:`Sharded` plane of axis ``flat_param``, c_b columns). The
anchor-shaped planes of the packed resident path are :class:`Sharded` of
axis ``anchor_flat``: piece w of column slice f, a_b elements a bucket
(1/(W·F) of the bucket, for every W and F, F = 1 included).

**Widths and padding.** A bucket of n_b columns splits into F slices of
c_b = ⌈n_b / F⌉ rounded up to 128 (c_b = n_b at F = 1), and a slice into W
pieces of a_b = ⌈c_b / W⌉ rounded up to 128. Slice f covers the columns
``[f·c_b, (f+1)·c_b)`` of the bucket padded with zeros to F·c_b; piece w
covers ``[w·a_b, (w+1)·a_b)`` of the slice padded to W·a_b. NCCL's
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` need equal
chunks, so the padding is real storage. It holds zeros and stays zero:
the gradient is zero there, K1/K2 with x, g and the moments at zero write
zero, a pullback toward a zero anchor and a worker sum of zeros are zero.
A gather drops it (:func:`unshard`), so it never reaches a checkpoint.

**Collectives.** Overlap-Local-SGD's worker sum (and EASGD's, CoCoD's and
delayed averaging's) is a reduce-scatter over the worker group
(:func:`reduce_scatter_async`): each rank writes the f32 partial sums of
its rows over its column slice into a wire buffer of W·a_b a bucket and
gets back the sum over all m workers of its own piece. The finished anchor
piece is all-gathered over the worker group before the next pullback
(:func:`anchor_columns`). The local step gathers the worker's rows over the
fsdp group (:func:`gather_columns`), runs forward and backward on the whole
row, and reduce-scatters the f32 gradient back over the fsdp group
(:func:`reduce_scatter_columns`). The other collectives: :func:`all_reduce_`
(an f32 plane-wide sum over the worker group, or a float64 scalar sum of the
probe's drift), :func:`all_reduce_fsdp_` (a sum over the fsdp group), and
:func:`all_gather_rows` (the rows' per-worker losses along the worker
axis). A fault plan's membership is resolved on the host alike on every
rank and stays (m,) in the state; :func:`rows_of` cuts the rank's rows out
of it for a boundary.

**Transports.** gloo runs reduce-scatter and all-gather for CPU tensors;
two ranks sharing one card run gloo on CUDA tensors, where
:func:`collective_transport` names the choice taken instead: the
reduce-scatter as an all-reduce of the wire buffer that keeps the rank's
own piece, the all-gather as a sum of zero-padded copies on their bytes
(exact). Nothing picks a transport silently on the NCCL path: there the
collectives are NCCL's own.

The gossip family's push is a neighbour exchange, not a reduction:
:func:`exchange_rows` sends the rank's launch-time rows (its column slice)
to the peers whose rows receive from them and receives the rows its own rows
receive from (:func:`repro_torch.core.topology.rank_peers`), launched at
one boundary and waited on at the next, within the worker group. NCCL and
gloo on CPU tensors run it as ``batch_isend_irecv``; gloo has point-to-point
only for CPU tensors, so on a gloo group with CUDA tensors the rows are
staged through pinned host buffers (:func:`exchange_transport` names the
choice). The checkpointer gathers row-stacked planes with
:func:`gather_rows_exact`, bit for bit (−0.0 included).

What still raises on a mesh names ROADMAP Queue 1 item 10c's second part
(:func:`unsupported_on_ranks`): tensor > 1, and with F > 1 MoE segments,
sparse_anchor, PowerSGD, the per-leaf path and offload.
"""
from __future__ import annotations

import contextlib
import functools
import math
import os
import threading
import warnings
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.config.base import ParallelPlan
from repro_torch.parallel.packing import LANE, Layout, Packed

# Logical axis -> logical mesh axes (the reference's table, key for key).
LOGICAL_RULES = {
    # parameter axes
    "worker": ("worker",),
    "embed": ("fsdp",),
    "embed_no_shard": (),
    "ff": ("tensor",),
    "heads": ("tensor",),
    "kv_heads": ("tensor",),
    "head_dim": (),
    "vocab": ("tensor",),
    "experts": ("fsdp",),
    "expert_ff": ("tensor",),
    "state": (),
    "conv": (),
    "lora": (),
    None: (),
    # activation axes
    "batch": ("fsdp",),
    "stacked_batch": ("worker", "fsdp"),
    "seq": (),
    "act_embed": (),
    "act_heads": ("tensor",),
    "act_kv_heads": ("tensor",),
    "act_ff": ("tensor",),
    "act_vocab": ("tensor",),
    "act_experts": ("fsdp",),
    "act_expert_ff": ("tensor",),
    "act_tokens": ("fsdp",),
    # the anchor is identical across workers: additionally over the worker axis
    "anchor_embed": ("worker", "fsdp"),
    "anchor_experts": ("worker", "fsdp"),
    # the packed plane: the per-worker plane over fsdp, the anchor plane over
    # every mesh axis (each rank owns a disjoint 128-multiple piece)
    "flat_param": ("fsdp",),
    "anchor_flat": ("worker", "fsdp", "tensor"),
}


def spec_for(axes: Sequence[Optional[str]], rules: Optional[dict] = None) -> tuple:
    """The mesh axes of each logical axis through the rule table: per dim
    None (replicated), one axis name, or a tuple of them — the tuple of the
    reference's ``PartitionSpec``."""
    rules = rules or LOGICAL_RULES
    parts = []
    for ax in axes:
        mapped = rules[ax]
        parts.append(None if not mapped else mapped[0] if len(mapped) == 1 else tuple(mapped))
    return tuple(parts)


def fit_spec(spec: Sequence, shape: Sequence[int], mesh) -> tuple:
    """Drop the sharding of every dim that its mesh axes do not divide
    (replicate it instead), as the reference's ``fit_spec``. ``mesh``: any
    object with a ``shape`` dict of axis sizes (a :class:`WorkerMesh`)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, part in zip(shape, parts):
        if part is None:
            out.append(None)
            continue
        prod = math.prod(mesh.shape[a] for a in (part if isinstance(part, tuple) else (part,)))
        out.append(part if dim % prod == 0 else None)
    return tuple(out)


def constrain(x, axes: Sequence[Optional[str]]):
    """The reference's sharding constraint: a no-op here (no partitioner;
    the packed plane's placement is :func:`plane_split`'s)."""
    return x


def sharding_for(axes: Sequence[Optional[str]], mesh=None) -> Optional[tuple]:
    """The spec of ``axes`` on ``mesh`` (the current one by default), or
    None with no mesh."""
    return None if (mesh or current_mesh()) is None else spec_for(axes)


def _tree_map_axes(fn, tree):
    """``fn`` over a nested dict whose leaves are axes tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map_axes(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_shardings(mesh, axes_tree, prefix: Tuple[Optional[str], ...] = (), rules: Optional[dict] = None):
    """A nested dict of axes tuples mapped to specs (``prefix`` axes
    prepended, e.g. ("worker",) for worker-stacked states)."""
    return _tree_map_axes(lambda axes: spec_for(tuple(prefix) + tuple(axes), rules), axes_tree)


def anchor_axes(axes_tree):
    """Axes for the anchor model: the params' own, with the fsdp-sharded
    dims also over the worker axis (``embed`` → ``anchor_embed``,
    ``experts`` → ``anchor_experts``)."""
    ren = {"embed": "anchor_embed", "experts": "anchor_experts"}
    return _tree_map_axes(lambda axes: tuple(ren.get(a, a) for a in axes), axes_tree)


@dataclass(frozen=True)
class WorkerMesh:
    """A (worker, fsdp) mesh of ranks. ``group`` is the worker group (the W
    ranks of this rank's fsdp index), ``rank`` this process's worker index w
    in it and ``size`` W; ``fsdp_group`` the F ranks of this worker (None at
    F = 1), ``fsdp_rank`` f; ``device`` the card (or the CPU) that holds the
    rank's share."""

    group: Any
    rank: int
    size: int
    device: torch.device
    fsdp: int = 1
    fsdp_rank: int = 0
    fsdp_group: Any = None

    @property
    def shape(self) -> dict:
        """The mesh's axis sizes by name (tensor is 1)."""
        return {"worker": self.size, "fsdp": self.fsdp, "tensor": 1}

    @property
    def first(self) -> bool:
        """Whether this is global rank 0 (worker 0, fsdp index 0): the rank
        that writes what the mesh writes once."""
        return self.rank == 0 and self.fsdp_rank == 0

    def global_rank(self, w: int) -> int:
        """The global rank of worker index ``w`` at this rank's fsdp index."""
        return w * self.fsdp + self.fsdp_rank

    def rows(self, m: int) -> Tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of m workers; m must divide by W."""
        if m < self.size or m % self.size:
            raise ValueError(f"m={m} workers do not divide over {self.size} ranks")
        per = m // self.size
        return self.rank * per, (self.rank + 1) * per


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[WorkerMesh] = None


_CTX = _Ctx()


SECOND_PART = "10c, second part"


def unsupported_on_ranks(what: str, item: str = SECOND_PART) -> NotImplementedError:
    """The error of a path not ported to a mesh of ranks (ROADMAP Queue 1)."""
    return NotImplementedError(f"{what} on a worker mesh (torch.distributed ranks): ROADMAP Queue 1 item {item}")


def _rank_device(device) -> torch.device:
    """``device`` for this rank: ``"cuda"`` is the card of ``LOCAL_RANK``
    (else of the rank) modulo the cards present; the CPU as it is."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' for CPU ranks over gloo")
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            dev = torch.device("cuda", local % torch.cuda.device_count())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def logical_mesh(plan: ParallelPlan, device="cuda", backend: Optional[str] = None) -> WorkerMesh:
    """The (worker, fsdp) mesh of ``plan`` over the initialised default
    process group (``torch.distributed.init_process_group``, W·F processes,
    every rank calls this): global rank w·F + f is worker w, fsdp index f.
    Every rank creates every worker group (one an fsdp index, in f order),
    then every fsdp group (one a worker, in w order), in the same order. The
    groups are NCCL on a card, gloo on the CPU; ``backend`` overrides that
    choice (gloo on CUDA tensors: ranks sharing one card). tensor > 1 raises
    (ROADMAP item 10c's second part)."""
    if plan.tensor != 1:
        raise unsupported_on_ranks(f"tensor parallelism (tensor={plan.tensor})")
    if plan.workers < 1 or plan.fsdp < 1:
        raise ValueError(f"a mesh needs workers and fsdp >= 1, got {plan}")
    if not dist.is_initialized():
        raise RuntimeError("logical_mesh needs an initialised process group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    W, F = plan.workers, plan.fsdp
    if W * F != world:
        raise ValueError(f"a mesh of {W} worker x {F} fsdp ranks needs as many processes, the group has {world}")
    dev = _rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    w, f = divmod(dist.get_rank(), F)
    if F == 1:
        return WorkerMesh(group=dist.new_group(ranks=list(range(world)), backend=backend), rank=w, size=W, device=dev)
    workers = [dist.new_group(ranks=[ww * F + ff for ww in range(W)], backend=backend) for ff in range(F)]
    fsdps = [dist.new_group(ranks=[ww * F + ff for ff in range(F)], backend=backend) for ww in range(W)]
    return WorkerMesh(group=workers[f], rank=w, size=W, device=dev, fsdp=F, fsdp_rank=f, fsdp_group=fsdps[w])


@contextlib.contextmanager
def mesh_context(mesh: WorkerMesh):
    """Make ``mesh`` current in this thread for the duration."""
    prev = _CTX.mesh
    _CTX.mesh = mesh
    try:
        yield mesh
    finally:
        _CTX.mesh = prev


def current_mesh() -> Optional[WorkerMesh]:
    """The mesh of the enclosing :func:`mesh_context`, or None (one process
    holds all m workers)."""
    return _CTX.mesh


def all_reduce_async(buf: torch.Tensor, mesh: Optional[WorkerMesh] = None):
    """Launch the sum of ``buf`` over the worker ranks, in place; returns the
    handle, whose ``wait()`` makes the sum visible (on a card: orders the
    current stream after it)."""
    mesh = _mesh(mesh, "all_reduce_async")
    return dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group, async_op=True)


def _mesh(mesh: Optional[WorkerMesh], what: str) -> WorkerMesh:
    mesh = mesh or current_mesh()
    if mesh is None:
        raise RuntimeError(f"{what} needs a worker mesh (mesh_context)")
    return mesh


def all_reduce_(buf: torch.Tensor, mesh: Optional[WorkerMesh] = None) -> torch.Tensor:
    """The sum of ``buf`` over the worker ranks, in place, blocking (on a
    card: the current stream ordered after it). Returns ``buf``."""
    all_reduce_async(buf, _mesh(mesh, "all_reduce_")).wait()
    return buf


def barrier(mesh: Optional[WorkerMesh] = None) -> None:
    """Every rank of the mesh waits for every other: a one-element sum over
    the worker group, then over the fsdp group."""
    mesh = _mesh(mesh, "barrier")
    t = torch.zeros(1, device=mesh.device)
    all_reduce_fsdp_(all_reduce_(t, mesh), mesh)


def all_gather_rows(t: torch.Tensor, mesh: Optional[WorkerMesh] = None) -> torch.Tensor:
    """Each rank's ``t`` (..., r), one value a row of its m/W workers on the
    last axis, gathered into (..., m) in worker order on every rank. A sum
    of zero-padded copies (x + 0 is x), so that it runs on every backend,
    gloo on CUDA tensors included."""
    mesh = _mesh(mesh, "all_gather_rows")
    r = t.shape[-1]
    out = torch.zeros(t.shape[:-1] + (r * mesh.size,), dtype=t.dtype, device=t.device)
    out[..., mesh.rank * r : (mesh.rank + 1) * r] = t
    return all_reduce_(out, mesh)


def rows_of(membership, mesh: Optional[WorkerMesh] = None):
    """The rank's rows of a membership (its (m,) mask and weights cut to
    ``[lo, hi)``, as the same NamedTuple), or None for None."""
    if membership is None:
        return None
    lo, hi = _mesh(mesh, "rows_of").rows(int(membership.mask.shape[0]))
    return membership._replace(mask=membership.mask[lo:hi], weights=membership.weights[lo:hi])


def exchange_transport(mesh: Optional[WorkerMesh] = None, device=None) -> str:
    """The transport :func:`exchange_rows` takes on ``mesh`` for tensors on
    ``device`` (the mesh's by default): ``"none"`` at W 1, ``"nccl p2p"``,
    ``"gloo p2p"`` (CPU tensors), or ``"gloo p2p staged through pinned host
    buffers"`` (CUDA tensors on a gloo group: gloo sends CPU tensors only)."""
    mesh = _mesh(mesh, "exchange_transport")
    if mesh.size == 1:
        return "none"
    backend = str(dist.get_backend(mesh.group))
    dev = torch.device(device) if device is not None else mesh.device
    if backend == "gloo" and dev.type == "cuda":
        return "gloo p2p staged through pinned host buffers"
    return f"{backend} p2p"


class Exchange:
    """A launched neighbour exchange (:func:`exchange_rows`). ``index``: the
    received rows' global worker indices, ascending; :meth:`wait` returns
    the received rows, one ``(len(index), n_b)`` tensor a sent buffer, on
    the sent buffers' device. Waiting also completes this rank's sends, so
    the sent buffers may be written again afterwards."""

    def __init__(self, works, received, staged, device, index, sent=()):
        self.works, self.received, self.staged, self.device, self.index = works, received, staged, device, index
        self.sent = sent  # the staged host rows, alive until the sends complete
        self._rows = None

    def wait(self) -> Tuple[torch.Tensor, ...]:
        if self._rows is None:
            for w in self.works:
                w.wait()
            self.works, self.sent = [], ()
            # staged: the pinned host rows to the card (a copy the host waits for)
            self._rows = tuple(r.to(self.device) for r in self.received) if self.staged else self.received
            self.received = None
        return self._rows


def exchange_rows(send: Sequence[torch.Tensor], peers, mesh: Optional[WorkerMesh] = None) -> Exchange:
    """Launch the neighbour exchange of one phase: ``send`` holds this
    rank's rows, one ``(r, n_b)`` buffer a bucket (rows ``peers.rows``);
    ``peers`` is this rank's :class:`~repro_torch.core.topology.RankPeers`.
    Each row a peer's rows receive from goes to that peer, and the rows
    ``peers.received`` come back, per bucket in ascending order. Returns
    the :class:`Exchange`; at W 1 (or with no peer) it moves nothing. On a
    gloo group with CUDA tensors the sent rows are copied to pinned host
    buffers first (the current stream synchronised) and the received rows
    copied to the card at :meth:`Exchange.wait`."""
    mesh = _mesh(mesh, "exchange_rows")
    device = send[0].device
    index = peers.received
    pos = {j: k for k, j in enumerate(index)}
    staged = exchange_transport(mesh, device).endswith("pinned host buffers")
    host = {"device": "cpu", "pin_memory": True} if staged else {"device": device}
    received = tuple(torch.empty((len(index), b.shape[-1]), dtype=b.dtype, **host) for b in send)
    if not index and not peers.send:
        return Exchange([], received, False, device, index)
    lo = peers.rows[0]
    nb = len(send)
    # staged: one copy to pinned host memory, after the kernels that wrote the rows
    src = [torch.empty(b.shape, dtype=b.dtype, pin_memory=True).copy_(b) if staged else b for b in send]
    ops = []
    for peer, rows in peers.send:
        for b in range(nb):
            for j in rows:
                ops.append(dist.P2POp(dist.isend, src[b][j - lo], mesh.global_rank(peer), mesh.group, tag=j * nb + b))
    for peer, rows in peers.recv:
        for b in range(nb):
            for j in rows:
                ops.append(dist.P2POp(dist.irecv, received[b][pos[j]], mesh.global_rank(peer), mesh.group,
                                   tag=j * nb + b))
    return Exchange(dist.batch_isend_irecv(ops), received, staged, device, index, sent=src if staged else ())


def gather_rows_exact(t: torch.Tensor, mesh: Optional[WorkerMesh] = None) -> torch.Tensor:
    """Each rank's rows ``t`` (r, ...) gathered into (m, ...) in worker
    order on every rank, bit for bit: the zero-padded copies are summed on
    their bytes (a uint8 view: 0 + b is b, where a float sum would turn
    −0.0 into +0.0), which every backend runs, gloo on CUDA tensors too."""
    mesh = _mesh(mesh, "gather_rows_exact")
    if mesh.size == 1:
        return t.clone()
    r = t.shape[0]
    out = torch.zeros((r * mesh.size,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    out[mesh.rank * r : (mesh.rank + 1) * r] = t
    all_reduce_(out.view(torch.uint8), mesh)
    return out


# -- the packed plane over the mesh ------------------------------------------------------


def _ceil_to(n: int, k: int) -> int:
    return -(-n // k) * k


def _ways(logical: str, mesh: WorkerMesh) -> int:
    """Into how many pieces the rule of ``logical`` splits a dim on ``mesh``."""
    return math.prod(mesh.shape[a] for a in LOGICAL_RULES[logical])


@dataclass(frozen=True)
class PlaneSplit:
    """How every bucket of one layout is cut on one mesh, for one rank:
    ``widths`` n_b, ``cols`` c_b (the fsdp slice; n_b at F = 1), ``pieces``
    a_b (the anchor piece: a slice cut W ways); rank (w, f) =
    (``w``, ``f``) of a ``workers`` × ``fsdp`` mesh."""

    widths: Tuple[int, ...]
    cols: Tuple[int, ...]
    pieces: Tuple[int, ...]
    workers: int
    fsdp: int
    w: int
    f: int


@functools.lru_cache(maxsize=None)
def _split(widths: Tuple[int, ...], nx: int, na: int, workers: int, fsdp: int, w: int, f: int) -> PlaneSplit:
    if na % nx:
        raise ValueError(f"anchor_flat's {na} pieces do not nest in flat_param's {nx} slices")
    cols = tuple(n if nx == 1 else _ceil_to(-(-n // nx), LANE) for n in widths)
    pieces = tuple(c if na == nx else _ceil_to(-(-c // (na // nx)), LANE) for c in cols)
    return PlaneSplit(widths, cols, pieces, workers, fsdp, w, f)


def plane_split(layout: Layout, mesh: WorkerMesh) -> PlaneSplit:
    """The cut of ``layout``'s buckets on ``mesh`` for this rank, read from
    the rule table: x over ``flat_param``'s axes, the anchor over
    ``anchor_flat``'s (see the module docstring for the widths)."""
    return _split(tuple(layout.bucket_sizes), _ways("flat_param", mesh), _ways("anchor_flat", mesh), mesh.size,
                  mesh.fsdp, mesh.rank, mesh.fsdp_rank)


class Sharded(Packed):
    """This rank's share of a plane placed by the rule of ``axis``:
    ``"flat_param"``, buffers ``lead + (c_b,)``, the rank's column slice of
    every bucket (x, the optimizer state, the rows' launch-time copies);
    ``"anchor_flat"``, buffers ``(a_b,)``, its piece of the anchor. The
    layout is the whole plane's: :func:`unshard` gives the whole plane back
    (a collective). Leaf views need the whole plane."""

    __slots__ = ("split", "axis")

    def __init__(self, buffers, layout: Layout, split: PlaneSplit, axis: str):
        super().__init__(buffers, layout)
        self.split, self.axis = split, axis

    @property
    def anchor(self) -> bool:
        return self.axis == "anchor_flat"

    def with_buffers(self, buffers, layout: Optional[Layout] = None) -> "Sharded":
        return Sharded(buffers, layout or self.layout, self.split, self.axis)

    def __repr__(self):
        shapes = ", ".join(f"{tuple(b.shape)}:{self.layout.bucket_dtypes[i]}" for i, b in enumerate(self.buffers))
        return f"Sharded[{self.axis}]([{shapes}], {self.layout.num_leaves} leaves)"


def _window(t: torch.Tensor, lo: int, width: int) -> torch.Tensor:
    """Columns ``[lo, lo + width)`` of ``t`` (last axis), zero past its end:
    a tensor of its own."""
    out = torch.zeros(t.shape[:-1] + (width,), dtype=t.dtype, device=t.device)
    hi = min(lo + width, t.shape[-1])
    if hi > lo:
        out[..., : hi - lo] = t[..., lo:hi]
    return out


def shard_columns(px: Packed, mesh: WorkerMesh) -> Packed:
    """A whole plane (``lead + (n_b,)`` a bucket) cut to this rank's column
    slices, a :class:`Sharded` of ``flat_param`` (copies); at F = 1 the
    plane as it is."""
    if mesh.fsdp == 1:
        return px
    sp = plane_split(px.layout, mesh)
    return Sharded(tuple(_window(b, sp.f * c, c) for b, c in zip(px.buffers, sp.cols)), px.layout, sp, "flat_param")


def shard_anchor(cols: Packed, mesh: WorkerMesh) -> Sharded:
    """This rank's anchor piece (a :class:`Sharded` of ``anchor_flat``) from
    an anchor-shaped plane over its column slice (buffers ``(c_b,)``, the
    whole row at F = 1): piece w of the slice (copies)."""
    sp = plane_split(cols.layout, mesh)
    return Sharded(tuple(_window(b, sp.w * a, a) for b, a in zip(cols.buffers, sp.pieces)), cols.layout, sp,
                   "anchor_flat")


def cut_to_rank(t: torch.Tensor, bucket: int, split: PlaneSplit, axis: str) -> torch.Tensor:
    """Bucket ``bucket`` of a whole plane (``lead + (n_b,)``) cut to this
    rank's share under ``axis`` (the checkpointer's restore)."""
    c = split.cols[bucket]
    cols = _window(t, split.f * c, c) if split.fsdp > 1 else t
    return _window(cols, split.w * split.pieces[bucket], split.pieces[bucket]) if axis == "anchor_flat" else cols


def collective_transport(mesh: Optional[WorkerMesh] = None, device=None) -> str:
    """The transport of :func:`reduce_scatter_async`, :func:`anchor_columns`
    and :func:`gather_columns` on ``mesh`` for tensors on ``device`` (the
    mesh's by default): ``"nccl"``, ``"gloo"`` (CPU tensors), or, for CUDA
    tensors on a gloo group, ``"gloo: reduce-scatter as an all-reduce
    keeping the rank's piece, all-gather as an exact byte sum"``."""
    mesh = _mesh(mesh, "collective_transport")
    backend = str(dist.get_backend(mesh.group))
    dev = torch.device(device) if device is not None else mesh.device
    if backend == "gloo" and dev.type == "cuda":
        return "gloo: reduce-scatter as an all-reduce keeping the rank's piece, all-gather as an exact byte sum"
    return backend


def _emulated(mesh: WorkerMesh, device) -> bool:
    return collective_transport(mesh, device).startswith("gloo:")


class _Works:
    """Handles of collectives launched together: ``wait()`` waits on each,
    then runs ``after`` (the emulated reduce-scatter's copy of the piece)."""

    def __init__(self, works, after=()):
        self.works, self.after = list(works), list(after)

    def wait(self):
        for w in self.works:
            w.wait()
        for fn in self.after:
            fn()
        self.works, self.after = [], []


def _reduce_scatter(out: torch.Tensor, src: torch.Tensor, group, size: int, pos: int, emulate: bool):
    """Launch the sum over ``group`` of ``src`` (``size`` equal chunks),
    this rank's chunk ``pos`` into ``out``; returns (work, after)."""
    if size == 1:
        if out.data_ptr() != src.data_ptr():
            out.copy_(src)
        return None, None
    if emulate:  # src takes the whole sum in place; the piece is copied out on wait
        k = out.numel()
        return dist.all_reduce(src, group=group, async_op=True), lambda: out.copy_(src[pos * k : (pos + 1) * k])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return dist.reduce_scatter_tensor(out, src, group=group, async_op=True), None


def reduce_scatter_async(srcs: Sequence[torch.Tensor], outs: Sequence[torch.Tensor],
                         mesh: Optional[WorkerMesh] = None) -> _Works:
    """Launch, per pair, the sum over the worker group of ``srcs[i]`` (W·k
    elements, f32) with this rank's piece (chunk w, k elements) into
    ``outs[i]``: the in-flight collective of the sharded anchor. Returns one
    handle; ``srcs`` must stay untouched until it is waited on."""
    mesh = _mesh(mesh, "reduce_scatter_async")
    emulate = _emulated(mesh, srcs[0].device)
    works, after = [], []
    for src, out in zip(srcs, outs):
        work, fn = _reduce_scatter(out, src, mesh.group, mesh.size, mesh.rank, emulate)
        works += [work] if work is not None else []
        after += [fn] if fn is not None else []
    return _Works(works, after)


def _all_gather(out: torch.Tensor, piece: torch.Tensor, group, size: int, pos: int, emulate: bool) -> torch.Tensor:
    """Every rank's ``piece`` of ``group`` into ``out`` (``size`` chunks in
    rank order), bit for bit; returns ``out``."""
    if size == 1:
        return out.copy_(piece)
    if emulate:  # zero-padded copies summed on their bytes (0 + b is b)
        k = piece.numel()
        out.zero_()
        out[pos * k : (pos + 1) * k] = piece.reshape(-1)
        dist.all_reduce(out.view(torch.uint8), group=group)
        return out
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, piece.contiguous().reshape(-1), group=group)
    return out


def anchor_columns(z: Sharded, mesh: Optional[WorkerMesh] = None) -> Packed:
    """The rank's column slice of an anchor plane from its pieces: one
    all-gather over the worker group a bucket (W·a_b, cut to c_b: the slice
    padding is zero; at W 1 the pieces themselves, views). A plane over the
    slice: a :class:`Sharded` of ``flat_param`` with no lead axis at F > 1,
    the whole anchor at F = 1."""
    mesh = _mesh(mesh, "anchor_columns")
    sp = z.split
    if sp.workers == 1:  # the piece is the slice: views, no copy
        out = [b[:c] for b, c in zip(z.buffers, sp.cols)]
    else:
        emulate = _emulated(mesh, z.buffers[0].device)
        out = [_all_gather(torch.empty(a * sp.workers, dtype=b.dtype, device=b.device), b, mesh.group, mesh.size,
                           mesh.rank, emulate)[:c] for b, a, c in zip(z.buffers, sp.pieces, sp.cols)]
    if sp.fsdp == 1:
        return Packed(tuple(out), z.layout)
    return Sharded(tuple(out), z.layout, sp, "flat_param")


def gather_columns(p: Sharded, mesh: Optional[WorkerMesh] = None) -> Packed:
    """The whole rows of a plane from the column slices of the worker's F
    ranks, bit for bit: one all-gather over the fsdp group a bucket, the
    padding dropped. A plane of its own (``lead + (n_b,)``)."""
    mesh = _mesh(mesh, "gather_columns")
    sp, emulate = p.split, _emulated(mesh, p.buffers[0].device)
    out = []
    for b, c, n in zip(p.buffers, sp.cols, sp.widths):
        lead = tuple(b.shape[:-1])
        full = torch.empty((sp.fsdp * b.numel(),), dtype=b.dtype, device=b.device)
        _all_gather(full, b, mesh.fsdp_group, sp.fsdp, sp.f, emulate)
        rows = full.view((sp.fsdp,) + lead + (c,)).movedim(0, -2).reshape(lead + (sp.fsdp * c,))
        out.append(rows[..., :n].contiguous())
    return Packed(tuple(out), p.layout)


def unshard(p, mesh: Optional[WorkerMesh] = None):
    """The whole plane of a :class:`Sharded` (an anchor: its column slice
    gathered over the worker group, then, as any slice, its row over the
    fsdp group), a plane of its own; anything else as it is. Every rank of
    the mesh calls it."""
    if not isinstance(p, Sharded):
        return p
    mesh = _mesh(mesh, "unshard")
    if p.anchor:
        p = anchor_columns(p, mesh)
    return gather_columns(p, mesh) if isinstance(p, Sharded) else p


_SCATTER_ELEMS = 1 << 26  # f32 elements of the gradient's reduce-scatter input at a time


def reduce_scatter_columns(pg: Packed, like: Sharded, mesh: Optional[WorkerMesh] = None) -> Sharded:
    """The worker's gradient from its F ranks' gradients of their batch
    shards: each whole-row bucket of ``pg`` (``(r, n_b)``, this rank's
    shard's mean gradient) summed in f32 over the fsdp group, this rank's
    column slice kept, divided by F (the mean of the shards' means is the
    whole batch's) and cast to the bucket's dtype: a :class:`Sharded` like
    ``like``. Blocking, over column chunks of at most ``_SCATTER_ELEMS``
    f32 elements of input."""
    mesh = _mesh(mesh, "reduce_scatter_columns")
    sp, F = like.split, like.split.fsdp
    emulate = _emulated(mesh, pg.buffers[0].device)
    ft = torch.full((), float(F), dtype=torch.float32, device=pg.buffers[0].device)
    out = []
    for g, c, n in zip(pg.buffers, sp.cols, sp.widths):
        r = g.shape[0]
        res = torch.empty((r, c), dtype=g.dtype, device=g.device)
        step = max(LANE, _SCATTER_ELEMS // max(F * r, 1))
        for j0 in range(0, c, step):
            k = min(step, c - j0)
            src = torch.zeros((F, r, k), dtype=torch.float32, device=g.device)
            for ff in range(F):
                lo = ff * c + j0
                hi = min(lo + k, n)
                if hi > lo:
                    src[ff, :, : hi - lo] = g[:, lo:hi]
            piece = torch.empty((r, k), dtype=torch.float32, device=g.device)
            work, fn = _reduce_scatter(piece.view(-1), src.view(-1), mesh.fsdp_group, F, sp.f, emulate)
            if work is not None:
                work.wait()
            if fn is not None:
                fn()
            res[:, j0 : j0 + k] = (piece / ft).to(g.dtype)
        out.append(res)
    return like.with_buffers(tuple(out))


def all_reduce_fsdp_(buf: torch.Tensor, mesh: Optional[WorkerMesh] = None) -> torch.Tensor:
    """The sum of ``buf`` over the fsdp group (this worker's F ranks), in
    place, blocking; a no-op at F = 1. Returns ``buf``."""
    mesh = _mesh(mesh, "all_reduce_fsdp_")
    if mesh.fsdp > 1:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.fsdp_group)
    return buf


def batch_shard(batch, mesh: Optional[WorkerMesh] = None, microbatch: Optional[int] = None):
    """This rank's share of a worker batch whose examples are on axis 2
    (``(τ, r, b, …)``; a tuple or dict): examples ``[f·b/F, (f+1)·b/F)``,
    as the rule ``batch → fsdp`` places them. A b, or a ``microbatch``,
    that F does not divide is a ``ValueError``."""
    mesh = _mesh(mesh, "batch_shard")
    F, f = mesh.fsdp, mesh.fsdp_rank
    if F == 1:
        return batch
    ts = batch.values() if isinstance(batch, dict) else batch
    b = next(iter(ts)).shape[2]
    if b % F or (microbatch is not None and microbatch < b and microbatch % F):
        raise ValueError(f"a worker batch of {b} (microbatch {microbatch}) does not divide over fsdp={F} ranks")
    k = b // F
    cut = lambda t: t[:, :, f * k : (f + 1) * k]  # noqa: E731
    return {key: cut(t) for key, t in batch.items()} if isinstance(batch, dict) else tuple(cut(t) for t in batch)
