"""The worker axis over ``torch.distributed`` ranks (counterpart of the
worker axis of ``repro.parallel.sharding``).

The reference lays a logical (worker, fsdp, tensor) mesh over its devices
and lets XLA's partitioner place the worker-stacked plane along the worker
axis. Here a mesh is a process group of W ranks, one card each (NCCL) or CPU
ranks (gloo). Rank r holds the rows ``[r·m/W, (r+1)·m/W)`` of every
``(m, n)`` bucket of the plane; the anchor z, its momentum v and the
optimizer's scalars are replicated, equal bit for bit on every rank. The
worker-mean "collective" of a boundary is then a real one: each rank sums
its own rows in f32 and :func:`all_reduce_async` adds the partial sums over
the ranks, launched at one boundary and waited on at the next
(:class:`repro_torch.core.strategy.RankInflight`).

A mesh is entered with :func:`mesh_context`; while one is current,
``make_train_state`` builds the rank's rows and the round engine slices its
rows of each round batch and runs the strategies' rank boundaries.

Besides the async sum, the boundaries and the experiment use blocking
collectives over the same group: :func:`all_reduce_` (an f32 plane-wide sum,
or a float64 scalar sum of the probe's drift), and :func:`all_gather_rows`
(the rows' per-worker losses gathered along the worker axis). A fault plan's
membership is resolved on the host alike on every rank and stays (m,) in the
state; :func:`rows_of` cuts the rank's rows out of it for a boundary.

The gossip family's push is a neighbour exchange, not a reduction:
:func:`exchange_rows` sends the rank's launch-time rows to the peers whose
rows receive from them and receives the rows its own rows receive from
(:func:`repro_torch.core.topology.rank_peers`), launched at one boundary and
waited on at the next. NCCL and gloo on CPU tensors run it as
``batch_isend_irecv``; gloo has point-to-point only for CPU tensors, so on a
gloo group with CUDA tensors (two ranks sharing one card) the rows are
staged through pinned host buffers (:func:`exchange_transport` names the
choice). The checkpointer gathers row-stacked planes with
:func:`gather_rows_exact`, bit for bit (−0.0 included).

Only the worker axis is here (ROADMAP Queue 1 items 10a and 10b: every
strategy, packed, per leaf and host-offloaded, and the checkpointer).
Within-worker sharding (fsdp, tensor), the logical rule table and the
ZeRO-sharded anchor are item 10c, the one path that raises on a mesh
(:func:`unsupported_on_ranks`).
"""
from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.config.base import ParallelPlan


@dataclass(frozen=True)
class WorkerMesh:
    """W ranks along the worker axis: ``group`` is their process group,
    ``rank`` this process's place in it, ``device`` the card (or the CPU)
    that holds its rows."""

    group: Any
    rank: int
    size: int
    device: torch.device

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


def unsupported_on_ranks(what: str, item: str = "10c") -> NotImplementedError:
    """The error of a path not ported to a worker mesh (ROADMAP Queue 1)."""
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
    """The worker mesh of ``plan`` over the initialised default process
    group (``torch.distributed.init_process_group``, one process a worker
    rank; every rank calls this). Its worker group is NCCL on a card, gloo
    on the CPU; ``backend`` overrides that choice (gloo on CUDA tensors: two
    ranks sharing one card). fsdp or tensor > 1 raise (item 10c)."""
    if plan.fsdp != 1 or plan.tensor != 1:
        raise unsupported_on_ranks(f"within-worker sharding (fsdp={plan.fsdp}, tensor={plan.tensor})", "10c")
    if not dist.is_initialized():
        raise RuntimeError("logical_mesh needs an initialised process group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if plan.workers != world:
        raise ValueError(f"a mesh of {plan.workers} worker ranks needs as many processes, the group has {world}")
    dev = _rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = dist.new_group(ranks=list(range(world)), backend=backend or ("nccl" if dev.type == "cuda" else "gloo"))
    return WorkerMesh(group=group, rank=dist.get_rank(), size=world, device=dev)


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
                ops.append(dist.P2POp(dist.isend, src[b][j - lo], peer, mesh.group, tag=j * nb + b))
    for peer, rows in peers.recv:
        for b in range(nb):
            for j in rows:
                ops.append(dist.P2POp(dist.irecv, received[b][pos[j]], peer, mesh.group, tag=j * nb + b))
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
