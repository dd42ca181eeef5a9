"""Two-phase communication strategies (counterpart of
``repro.core.strategy``: every strategy and alias of the reference, on the
packed plane and per leaf).

The paper's structure: the anchor collective launched at one round
boundary is consumed τ local steps later. The round engine calls one hook a
round, :meth:`CommStrategy.boundary_round`, which consumes the in-flight
collective launched at the previous boundary (eq. 4) and launches this
round's (eq. 5); the launched value rides in ``TrainState.inflight``.
Delayed averaging consumes it mid-round instead, through
:meth:`CommStrategy.local_post_update_packed` (per leaf
:meth:`CommStrategy.local_post_update`), which the engine calls after every
optimizer step; PowerSGD and sync-SGD act on the gradients through
:meth:`CommStrategy.transform_grads_packed` (per leaf
:meth:`CommStrategy.transform_grads`).

On one card the m workers are stacked in one ``(m, n)`` plane per dtype,
so the worker-mean "collective" is a reduction over the worker axis (inside
the fused boundary kernel K3/K4 where there is one) and a gossip push is an
(m, m)·(m, n) product.

Boundaries update x (and the anchor momentum v) **in place**. The reference
is pure, so it may hand the plane itself over as the in-flight value
(the gossip mix, the rebase strategies' x₀); here x is written in place, so
every in-flight plane has a buffer of its own, reused round after round.
Full-plane f32 temporaries are avoided: expressions over a whole plane run
over column chunks (:func:`~repro_torch.parallel.packing.column_chunks`) or as one mixed-dtype in-place
op, with the values of the reference's expressions.

``boundary_round(..., probe=True)`` also returns the consensus stats of the
*pre-boundary* plane for the adaptive-τ controller: fused into K3/K4 (no
extra launch) where the boundary runs them (overlap, easgd, sparse_anchor,
gossip_full), else one standalone K8 launch a bucket. ``membership`` (a
:class:`~repro_torch.fault.Membership`) masks the boundary to the live
workers: dead rows pass through, worker means are the renormalised weighted
sums; the probe still covers all m rows. ``None`` is the fully-live path.

With ``AlgoConfig.offload`` the round engine keeps vars and the in-flight
plane in host memory between boundaries (:mod:`repro_torch.parallel.offload`)
and hands the hooks resident planes; :attr:`CommStrategy.consumes_inflight_midround`
tells it to restore the in-flight plane before the window, not at the
boundary.

**On a worker mesh** (:mod:`repro_torch.parallel.sharding`: the worker
axis over ``torch.distributed`` ranks, each holding m/W rows of the plane)
every strategy runs its rank boundary from :meth:`CommStrategy.boundary_round`
(:attr:`CommStrategy.rank_capable`), with the probe and the membership as on
one process. Overlap-Local-SGD's worker sum becomes a real collective: each
rank pulls its rows back and writes their f32 (weighted) partial sum into
one flat f32 wire buffer, ``all_reduce_async`` launches the sum, and the
in-flight slot carries the handle (:class:`RankInflight`); the next boundary
waits on it, after τ local steps, and finishes the anchor (K3/K4's rank form,
:func:`~repro_torch.kernels.anchor_mix.ops.pullback_rank`). gossip_full takes
the same path with β = 0. sparse_anchor launches its worker sum the same way
(:class:`RankSparseInflight`) and, where it is waited on, finishes the mean
and takes the sparse step on the replicated n-wide f32 vectors (so its error
feedback lags one boundary until the drain). CoCoD-SGD and delayed averaging
launch their average the same way (:class:`RankRebaseInflight`, x₀ the
rank's own rows), waited at the next boundary or ``delay_steps`` local steps
into the round. The sparse gossip topologies push by a neighbour exchange
(:func:`~repro_torch.parallel.sharding.exchange_rows`): the boundary forms
each own row's mix from the rows the exchange launched a round ago brought
(K5's gossip rank form,
:func:`~repro_torch.kernels.anchor_mix.ops.gossip_rank_`), pulls the rows
toward it and launches the next exchange of their launch-time copy
(:class:`RankGossipInflight`). :func:`finish_inflight` does the wait and
finish alone (the round engine's ``drain``). Local SGD all-reduces the rows'
partial sums at its boundary, EASGD the pre-pullback ones (K4's rank form
with ``mean_pre``), sync-SGD the gradient plane at every step and PowerSGD
its two factor sums at every step (:mod:`repro_torch.core.powersgd`), all
blocking. A membership ((m,), alike on every rank) is cut to the rank's rows
(:func:`~repro_torch.parallel.sharding.rows_of`); a mean over a membership
is its weighted sum, which the finish takes with no division. The probe
(:func:`rank_probe`) needs x̄ of all m rows before the boundary moves them:
one blocking n-wide all-reduce of the unweighted row sums (Local SGD
unmasked reuses its own), then K8's rank form a bucket and a float64 sum of
the drift over the ranks. Under ``AlgoConfig.offload`` the rank in-flight
kinds keep their anchor-shaped planes (the anchor a finish reads, x₀) on the
host between boundaries, as the offloaded round engine keeps vars
(:meth:`_RankPending.map_planes`, which the offload tree walks call); the
f32 wire buffer, and the rows a pending neighbour exchange sends and
receives, stay on the card until the collective is waited on.
:func:`check_rank_path` raises only for a strategy with no rank boundary.

**The sharded anchor** (ROADMAP item 10c, first part). On the packed
resident path the anchor-shaped state of Overlap-Local-SGD, gossip_full,
EASGD, CoCoD and delayed averaging (z, v, the in-flight anchor, the
average) is the rank's piece (:class:`~repro_torch.parallel.sharding.Sharded`
of ``anchor_flat``: 1/(W·F) of each bucket), for every W and F. The worker
sum is then a reduce-scatter over the worker group
(:func:`~repro_torch.parallel.sharding.reduce_scatter_async`):
Overlap-Local-SGD's boundary waits on the one the last boundary launched,
finishes its piece (K3/K4's rank form with no rows, :class:`RankShardInflight`),
all-gathers the pieces of its column slice, pulls its rows back (K4's rank
form with no finish, writing the partial sums over the slice into a wire
buffer of W·a_b a bucket) and launches the next reduce-scatter
(:func:`_shard_anchor_boundary`); EASGD blocks on one, CoCoD and delayed
averaging launch one (:class:`RankRebaseInflight` with ``sums``). The
finish is elementwise, so the values are the replicated path's bit for
bit. The per-leaf and offloaded rank paths, sparse_anchor and PowerSGD
keep a replicated anchor (at F = 1; with fsdp > 1 they raise,
:func:`check_fsdp_path`). With fsdp > 1 x is the rank's column slice, and
every other rank boundary runs on it as on whole rows: Local SGD and
sync-SGD reduce over the worker group of their slice, the gossip family
exchanges its slice within the worker group, and the probe adds the
slices' drift and scale over the fsdp group (:func:`rank_probe`).

**The per-leaf oracle** (``AlgoConfig.packed=False``, and every legacy
``Algorithm`` through :class:`LegacyStrategy`): x is a nested dict of
worker-stacked leaves ``(m, ...)``, each with its own storage, and the
boundary runs the reference's two phases in turn, ``boundary_apply`` then
``boundary_launch`` (``probe`` by the plain
:func:`~repro_torch.kernels.consensus_probe.tree_probe`). Anchor-shaped
state (z, v, the in-flight anchor, error feedback) is unstacked per leaf.
The pullback is K5's row form, one launch a leaf (a stacked anchor, gossip's
debiased mix, takes the same-shape K5). Every expression is the packed
path's, op for op: worker means sum the rows 0 .. m−1 in float32 and divide
by m (K3/K4's order, also on the packed path's own means), so on one device
the per-leaf boundary equals the packed one bit for bit. A packed strategy
handed a per-leaf x (an optimizer without a packed step, as in the
reference) runs its boundary on x's plane and writes the result back.

On a worker mesh the per-leaf math stays per leaf and only the worker
reductions become collectives: each worker mean (:func:`_worker_mean`) is
the f32 partial sums of the rank's rows of every leaf in one flat f32 wire
buffer, one all-reduce, and round(S / m) (or round(S) when weighted) per
leaf, :func:`_finish_sum`'s values. Local SGD, EASGD, sync-SGD's gradient
mean and the legacy shims block on it; Overlap-Local-SGD, gossip_full,
sparse_anchor, CoCoD and delayed averaging launch it at one boundary and
finish it where it is waited on (:class:`RankLeafInflight`: the momentum
chain, the sparse step with its error feedback, the average). The gossip
topologies send every leaf's launch-time rows in one flat buffer a dtype
through the neighbour exchange and form each own row's mix with K5's gossip
rank form (mode 2), the stacked push's order, then debias and pull back per
leaf. PowerSGD all-reduces each step's two factor sums of every leaf, one
flat buffer a phase. The probe is :func:`rank_probe` over the leaves' rows.
"""
from __future__ import annotations

import copy
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.base import AlgoConfig
from repro_torch.core.topology import cached_rank_peers, cached_topology, compose_membership
from repro_torch.kernels.anchor_mix import ops as anchor_ops
from repro_torch.kernels.anchor_mix.ref import push, row_sum, worker_mean
from repro_torch.kernels.consensus_probe import ConsensusStats, packed_probe, probe_rows, stats_from_partials, tree_probe
from repro_torch.kernels.opt_step.ref import weak
from repro_torch.parallel import sharding
from repro_torch.parallel.packing import (
    Packed,
    column_chunks,
    leaf_segments,
    leaf_views,
    pack,
    packed_like,
    tensors_of,
    tree_flatten,
    tree_unflatten,
)
from repro_torch.utils.tree import tree_lerp, tree_map

class AlgoVars(NamedTuple):
    """Strategy-owned state slots (unused slots are None)."""

    z: Any = None  # anchor (easgd, sparse_anchor; overlap's consumed anchor with momentum)
    v: Any = None  # anchor momentum
    extra: Any = None  # gossip (w, t) / sparse error feedback / PowerState / legacy cocod's round start


def _mem_weights(membership):
    """The (m,) f32 weights of a membership, or None (fully live)."""
    return None if membership is None else membership.weights


def _local(membership):
    """A membership cut to this rank's rows on a worker mesh; as it is off one."""
    mesh = sharding.current_mesh()
    return membership if mesh is None else sharding.rows_of(membership, mesh)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """A worker-stacked tensor as its (m, n) view."""
    return t.reshape(t.shape[0], -1)


def _mean_rows(t: torch.Tensor, weights=None) -> torch.Tensor:
    """The worker mean of an (m, ...) tensor, or with ``weights`` the
    weighted sum Σ_i w_i·t_i: the rows summed 0 .. m−1 in float32 and divided
    by m (K3/K4's order), cast to t's dtype, over column chunks. Shape
    ``t.shape[1:]``."""
    rows = _rows(t)
    out = torch.empty(rows.shape[1], dtype=t.dtype, device=t.device)
    for c in column_chunks(rows):
        out[c] = worker_mean(rows[:, c], weights).to(t.dtype)
    return out.reshape(t.shape[1:])


def _packed_worker_mean(p: Packed, weights=None) -> Packed:
    """One worker mean (or weighted sum) per bucket, :func:`_mean_rows`."""
    return Packed(tuple(_mean_rows(b, weights) for b in p.buffers), p.layout)


def _worker_mean(x, weights=None):
    """The per-leaf worker mean (or weighted sum) of a worker-stacked tree.
    On a worker mesh, over all ranks: the rank's rows' f32 partial sums of
    every leaf in one flat f32 buffer (``weights``, the (m,) ones of a
    membership, cut to the rows), one blocking all-reduce, then
    :func:`_finish_sum` per leaf — :func:`_mean_rows`'s values."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return tree_map(lambda t: _mean_rows(t, weights), x)
    leaves, paths = tree_flatten(x)
    rows = [_rows(t) for t in leaves]
    lo, hi = mesh.rows(rows[0].shape[0] * mesh.size)
    buf = sharding.all_reduce_(_rank_sums(rows, None if weights is None else weights[lo:hi]), mesh)
    return _leaf_finish(buf, leaves, paths, rows[0].shape[0] * mesh.size, weights is not None)


def _leaf_finish(buf: torch.Tensor, leaves, paths, m: int, weighted: bool) -> dict:
    """The per-leaf worker means from an all-reduced flat f32 sum of the
    leaves' rows (:func:`_finish_sum` per leaf), shaped like the leaves
    without their worker axis."""
    views = _wire_views(buf, [_rows(t) for t in leaves])
    return tree_unflatten(paths, [_finish_sum(s, m, weighted, t.dtype).reshape(t.shape[1:])
                                  for s, t in zip(views, leaves)])


def _live_where_(mask, new, old):
    """Per leaf, in place on ``new``: live rows (``mask > 0``) keep their new
    value, the others take ``old``'s (they sat the boundary out)."""
    live = mask > 0

    def one(n, o):
        torch.where(live.reshape((-1,) + (1,) * (n.dim() - 1)), n, o, out=n)
        return n

    return tree_map(one, new, old)


def _clone(x):
    return tree_map(torch.clone, x)


def _first_row(x):
    """A copy of worker 0's leaves (all workers start equal)."""
    return tree_map(lambda t: t[0].clone(), x)


def _leading(x) -> int:
    """m, the worker count of a plane or a worker-stacked tree (on a worker
    mesh, over all ranks)."""
    mesh = sharding.current_mesh()
    return tensors_of(x)[0].shape[0] * (1 if mesh is None else mesh.size)


def _with_stats(out: tuple, stats) -> tuple:
    """A boundary's result, with the probe's stats appended when probed."""
    return out if stats is None else out + (stats,)


def _fused_stats(outs, m: int, probe: bool):
    """The stats K3/K4 emitted with ``probe=True`` (each output's last)."""
    return stats_from_partials([o[-1] for o in outs], m) if probe else None


def _as_plane(x) -> Packed:
    """x's plane: a ``Packed`` as it is, a per-leaf tree packed (a copy)."""
    return x if isinstance(x, Packed) else pack(x, lead=1)


def _write_back(x, px: Packed):
    """Copy a plane made by :func:`_as_plane` back into the per-leaf x."""
    if px is not x:
        for t, v in zip(tree_flatten(x)[0], leaf_views(px)):
            t.copy_(v)
    return x


def _pack_anchor(px: Packed) -> Packed:
    """A copy of worker 0's row of every bucket (all workers start equal)."""
    return Packed(tuple(b[0].clone() for b in px.buffers), px.layout)


def _copy_plane(px: Packed) -> Packed:
    return px.with_buffers(tuple(b.clone() for b in px.buffers))


def _shards_anchor(strategy, x) -> bool:
    """Whether ``strategy`` keeps its anchor-shaped state as this rank's
    piece (:class:`~repro_torch.parallel.sharding.Sharded`, ``anchor_flat``):
    on a worker mesh, the packed resident plane (not offloaded, not per
    leaf), a strategy whose anchor is elementwise."""
    return (sharding.current_mesh() is not None and isinstance(x, Packed) and strategy.shards_anchor
            and not strategy.cfg.offload)


def _init_anchor(strategy, x) -> Packed:
    """Worker 0's row as the anchor: this rank's piece of it where the
    strategy shards its anchor (:func:`_shards_anchor`), else the whole row
    (of the rank's columns)."""
    row = _pack_anchor(_as_plane(x))
    return sharding.shard_anchor(row, sharding.current_mesh()) if _shards_anchor(strategy, x) else row


def _pullback(x, z, alpha: float, membership=None):
    """Paper eq. (4) per leaf, x ← (1−α)·x + α·z, in place (K5's row form,
    or the same-shape K5 for a stacked z): the reference's ``_pullback``.
    With ``membership`` ((m,), cut to the rank's rows on a worker mesh) the
    dead rows keep their values."""
    membership = _local(membership)
    old = None if membership is None else _clone(x)
    anchor_ops.pullback_tree(x, z, alpha)
    return x if old is None else _live_where_(membership.mask, x, old)


class _RankPending:
    """What the rank boundaries' in-flight kinds share. ``done``, the
    finished value, is set once, by whichever copy finishes: the copies
    :meth:`map_planes` makes share it. ``HOST_PLANES`` names the attributes
    that may live on the host between boundaries under ``AlgoConfig.offload``
    (the anchor a finish reads, the rows' launch-time copy); the f32 wire
    buffer, the handle and whatever the pending collective reads or writes
    stay on the card until it is waited on."""

    HOST_PLANES: Tuple[str, ...] = ()

    def __init__(self):
        self._done = [None]

    @property
    def done(self):
        return self._done[0]

    @done.setter
    def done(self, value):
        self._done[0] = value

    def map_planes(self, fn, other=None):
        """A copy with ``fn(plane, other's plane)`` at each of
        :attr:`HOST_PLANES` (``other``: an earlier value of this kind, whose
        host stacks may be reused, or None), the rest shared: the offload
        tree walks' hook (:mod:`repro_torch.parallel.offload`)."""
        if not self.HOST_PLANES:
            return self
        out = copy.copy(self)
        for name in self.HOST_PLANES:
            setattr(out, name, fn(getattr(self, name), getattr(other, name, None) if type(other) is type(self) else None))
        return out


class RankInflight(_RankPending):
    """The in-flight anchor of a rank boundary: ``z`` the anchor that
    boundary pulled toward (the base of the next anchor), ``buf`` the one
    flat f32 wire buffer of every bucket's partial worker sum (the sum over
    all ranks once ``handle``, the async all-reduce, is waited), ``m`` the
    worker count over all ranks, ``beta`` the anchor momentum (None: K4),
    ``weighted`` whether the sum is a membership's weighted sum (the mean
    then takes no division; the next boundary's membership may differ).
    It is finished once, by the next boundary (inside K3/K4's rank form) or
    by :meth:`finished` (the drain: v updated in place), and keeps the
    finished anchor: a state drained twice, or drained and then consumed,
    moves v once."""

    HOST_PLANES = ("z",)

    def __init__(self, z: Packed, buf: torch.Tensor, handle, m: int, beta: Optional[float], weighted: bool = False):
        super().__init__()
        self.z, self.buf, self.handle, self.m, self.beta, self.weighted = z, buf, handle, m, beta, weighted

    def finished(self, vars: AlgoVars) -> Packed:
        if self.done is None:
            self.handle.wait()
            vs = vars.v.buffers if self.beta is not None else (None,) * len(self.z.buffers)
            fin = 2 if self.weighted else 1
            self.done = Packed(tuple(anchor_ops.pullback_rank(bz[None][:0], bz, bv, s, self.m, 0.0, self.beta, fin)
                                     for bz, bv, s in zip(self.z.buffers, vs, _wire_views(self.buf, self.z))),
                               self.z.layout)
        return self.done


class RankShardInflight(_RankPending):
    """The in-flight anchor of a sharded rank boundary: ``z`` this rank's
    piece of the anchor that boundary pulled toward (a
    :class:`~repro_torch.parallel.sharding.Sharded`), ``wire`` the flat f32
    buffer of every bucket's partial worker sums over the rank's column
    slice (W·a_b a bucket, zero past c_b), ``sums`` the flat f32 pieces
    (a_b a bucket) that ``handle``, the reduce-scatter over the worker
    group, writes: the sum over all m workers of the rank's piece once
    waited. ``m``, ``beta``, ``weighted`` as :class:`RankInflight`.
    :meth:`finished` waits once and finishes the piece (K3/K4's rank form
    with no rows; v's piece updated in place), and keeps it."""

    def __init__(self, z, wire: torch.Tensor, sums: torch.Tensor, handle, m: int, beta: Optional[float],
                 weighted: bool = False):
        super().__init__()
        self.z, self.wire, self.sums, self.handle = z, wire, sums, handle
        self.m, self.beta, self.weighted = m, beta, weighted

    def finished(self, vars: AlgoVars):
        if self.done is None:
            self.handle.wait()
            vs = vars.v.buffers if self.beta is not None else (None,) * len(self.z.buffers)
            fin = 2 if self.weighted else 1
            self.done = self.z.with_buffers(tuple(
                anchor_ops.pullback_rank(bz[None][:0], bz, bv, s, self.m, 0.0, self.beta, fin)
                for bz, bv, s in zip(self.z.buffers, vs, _piece_views(self.sums, self.z.split))))
        return self.done


def _shard_wire(split, device):
    """(wire, sums) of a sharded boundary: a zeroed flat f32 buffer of W·a_b
    a bucket (the partial sums over the column slice go in its first c_b;
    the rest, padding, stays zero) and a flat f32 buffer of a_b a bucket
    (the rank's summed pieces; at W 1 the wire itself: the sum over one
    rank is its partial sum)."""
    wire = torch.zeros(sum(split.workers * a for a in split.pieces), dtype=torch.float32, device=device)
    return wire, (wire if split.workers == 1 else torch.empty(sum(split.pieces), dtype=torch.float32, device=device))


def _wire_segments(wire: torch.Tensor, split):
    """``wire`` cut into one (W·a_b,) segment a bucket."""
    return torch.split(wire, [split.workers * a for a in split.pieces])


def _wire_cols(wire: torch.Tensor, split):
    """Each bucket's segment cut to its column slice's c_b partial sums."""
    return [seg[:c] for seg, c in zip(_wire_segments(wire, split), split.cols)]


def _piece_views(sums: torch.Tensor, split):
    """``sums`` cut into one (a_b,) piece a bucket."""
    return torch.split(sums, list(split.pieces))


class RankRebaseInflight(_RankPending):
    """The in-flight average of an avg-rebase rank boundary (CoCoD, delayed
    averaging): ``x0`` the rank's own launch-time rows (a plane of their
    own), ``buf`` the flat f32 wire buffer of the rows' (weighted) partial
    sums, summed over the ranks once ``handle`` is waited, ``m`` the worker
    count over all ranks. :meth:`finished` waits once and returns the
    one-process in-flight value, ``Inflight(avg, x0)``, which it keeps: the
    average may be consumed mid-round and the buffers reused at the
    boundary."""

    HOST_PLANES = ("x0",)

    def __init__(self, x0: Packed, buf: torch.Tensor, handle, m: int, weighted: bool, sums=None, like=None):
        super().__init__()
        self.x0, self.buf, self.handle, self.m, self.weighted = x0, buf, handle, m, weighted
        # sharded (``like``: the average's last piece): ``buf`` is the wire, the reduce-scatter writes ``sums``
        self.sums, self.like = sums, like

    def finished(self, vars: Optional[AlgoVars] = None):
        if self.done is None:
            self.handle.wait()
            if self.like is None:
                avg = Packed(tuple(_finish_sum(s, self.m, self.weighted, b.dtype)
                                   for s, b in zip(_wire_views(self.buf, self.x0), self.x0.buffers)), self.x0.layout)
            else:
                avg = self.like.with_buffers(tuple(_finish_sum(s, self.m, self.weighted, b.dtype) for s, b in
                                                   zip(_piece_views(self.sums, self.like.split), self.like.buffers)))
            self.done = _AvgRebaseStrategy.Inflight(avg=avg, x0=self.x0)
        return self.done


class RankSparseInflight(_RankPending):
    """The in-flight worker sum of a sparse_anchor rank boundary: ``z`` the
    anchor that boundary pulled toward (the base of the sparse step),
    ``buf`` the flat f32 wire buffer of the rows' (weighted) partial sums,
    summed over the ranks once ``handle`` is waited, ``m`` the worker count
    over all ranks, ``k`` the kept fraction. :meth:`finished` waits once,
    takes the mean and the sparse step s = top_k(mean − z + e), e ← Δ − s
    (e, vars.extra, in place), and returns z' = z + s, which it keeps."""

    HOST_PLANES = ("z",)

    def __init__(self, z: Packed, buf: torch.Tensor, handle, m: int, weighted: bool, k: float):
        super().__init__()
        self.z, self.buf, self.handle, self.m, self.weighted, self.k = z, buf, handle, m, weighted, k

    def finished(self, vars: AlgoVars) -> Packed:
        if self.done is None:
            self.handle.wait()
            means = [_finish_sum(s, self.m, self.weighted, bz.dtype)
                     for s, bz in zip(_wire_views(self.buf, self.z), self.z.buffers)]
            self.done = Packed(tuple(_sparse_step(means, self.z, vars.extra, self.k)), self.z.layout)
        return self.done


class RankLeafInflight(_RankPending):
    """The in-flight worker sum of a per-leaf rank boundary: ``buf`` the one
    flat f32 wire buffer of every leaf's (weighted) partial worker sum over
    the rank's rows, summed over the ranks once ``handle`` is waited, ``m``
    the worker count over all ranks, ``leaves``/``paths`` x's leaves at the
    launch (their shapes and dtypes), ``finish(means, vars)`` the launching
    strategy's tail, which turns the worker means into the one-process
    in-flight value. :meth:`finished` waits once, takes the means
    (:func:`_finish_sum` per leaf), runs ``finish`` and keeps its value."""

    def __init__(self, buf: torch.Tensor, handle, m: int, weighted: bool, leaves, paths, finish):
        super().__init__()
        self.buf, self.handle, self.m, self.weighted = buf, handle, m, weighted
        self.leaves, self.paths, self.finish = leaves, paths, finish

    def finished(self, vars: Optional[AlgoVars] = None):
        if self.done is None:
            self.handle.wait()
            self.done = self.finish(_leaf_finish(self.buf, self.leaves, self.paths, self.m, self.weighted), vars)
        return self.done


def _means(means, vars):
    """A per-leaf boundary's tail when the in-flight value is the mean."""
    return means


def _launch_leaves(x, vars: AlgoVars, membership, finish=_means):
    """A per-leaf boundary's launch. On a worker mesh: the rank's rows' f32
    (weighted) partial sums of every leaf into one flat wire buffer, its
    ``all_reduce_async``, and ``finish(means, vars)`` left for the wait;
    else ``finish`` run on the worker mean at once."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return vars, finish(_worker_mean(x, _mem_weights(membership)), vars)
    leaves, paths = tree_flatten(x)
    mem = _local(membership)
    buf = _rank_sums([_rows(t) for t in leaves], None if mem is None else mem.weights)
    return vars, RankLeafInflight(buf, sharding.all_reduce_async(buf, mesh), _leading(x), mem is not None, leaves,
                                  paths, finish)


def _arrived(inflight, vars: Optional[AlgoVars] = None):
    """The value a boundary or a mid-round rebase consumes: a rank
    boundary's pending collective waited on and finished; anything else as
    it is."""
    return inflight.finished(vars) if isinstance(inflight, _RankPending) else inflight


def _bufs(px):
    """The buffers of a plane, or a list of (r, n) row tensors as it is."""
    return px.buffers if isinstance(px, Packed) else px


def _wire_buffer(px) -> torch.Tensor:
    """One flat f32 buffer for every bucket of x's plane, or every (r, n)
    tensor of a list (f32 for a bf16 plane too: the worker sum is taken in
    f32)."""
    bufs = _bufs(px)
    return torch.empty(sum(b.shape[-1] for b in bufs), dtype=torch.float32, device=bufs[0].device)


def _wire_views(buf: torch.Tensor, px):
    """``buf`` cut into one (n,) view a bucket (a tensor of a list)."""
    return torch.split(buf, [b.shape[-1] for b in _bufs(px)])


def _finish_sum(s: torch.Tensor, m: int, weighted: bool, dtype) -> torch.Tensor:
    """The worker mean from an all-reduced f32 worker sum: round(s / m)
    (a true division, K3/K4's), or round(s) for a weighted sum; a buffer of
    its own (the wire buffer is reused), over column chunks."""
    out = torch.empty(s.shape, dtype=dtype, device=s.device)
    mt = torch.full((), float(m), dtype=torch.float32, device=s.device)
    for c in column_chunks(s[None]):
        out[c] = s[c].to(dtype) if weighted else (s[c] / mt).to(dtype)
    return out


def _rank_sums(px, weights=None, buf=None) -> torch.Tensor:
    """The f32 partial worker sums of this rank's rows, every bucket (every
    (r, n) tensor of a list: the leaves' rows) into one wire buffer
    (``buf``, or a new one), over column chunks: rows 0 .. r−1 in order,
    each term weighted with ``weights`` (the rows' slice of a membership's
    weights) — the stacked worker mean's order."""
    buf = _wire_buffer(px) if buf is None else buf
    _write_sums(px, _wire_views(buf, px), weights)
    return buf


def _write_sums(px, views, weights=None) -> None:
    """The f32 partial worker sums of the rank's rows, one bucket (one (r, n)
    tensor of a list) into each of ``views``: :func:`_rank_sums`'s values."""
    for b, s in zip(_bufs(px), views):
        rows = _rows(b)
        for c in column_chunks(rows):
            s[c] = row_sum(rows[:, c]) if weights is None else worker_mean(rows[:, c], weights)


def finish_inflight(inflight, vars: AlgoVars):
    """Wait on a rank boundary's collective and finish what it carries: the
    anchor (the tail of K3/K4: the mean, and with momentum v updated in
    place), sparse_anchor's sparse step (its error feedback updated in
    place), the avg-rebase average or the gossip mix of the rank's rows —
    the in-flight value the stacked run holds at the same step."""
    return inflight.finished(vars)


def is_rank_inflight(inflight) -> bool:
    """Whether ``inflight`` is a rank boundary's pending collective."""
    return isinstance(inflight, _RankPending)


def rank_probe(px, mesh, sums=None) -> ConsensusStats:
    """The consensus stats of the pre-boundary plane (or of a list of the
    leaves' (r, n) rows) over all ranks, as the stacked probe gives them:
    x̄ from the unweighted f32 row sums (one blocking n-wide all-reduce, or
    ``sums``, the all-reduced sums the boundary already holds), K8's rank
    form a bucket (a leaf), the drift sums added over the ranks in float64
    (one scalar all-reduce) and rounded to f32 once. With fsdp > 1 x̄ is
    the rank's column slice's, and the slices' drift and scale parts add
    over the fsdp group."""
    m = _bufs(px)[0].shape[0] * mesh.size
    own = sums is None
    if own:
        sums = sharding.all_reduce_(_rank_sums(px), mesh)
    mt = torch.full((), float(m), dtype=torch.float32, device=sums.device)
    xbar = sums.div_(mt) if own else sums / mt  # in place in a buffer of its own (a plane's f32 bytes)
    parts = torch.stack([probe_rows(_rows(b), xb) for b, xb in zip(_bufs(px), _wire_views(xbar, px))])
    drift, scale = sharding.all_reduce_(parts[:, 0].contiguous(), mesh), parts[:, 1]
    if mesh.fsdp > 1:  # every column slice's drift and scale, over the worker's F ranks
        drift, scale = sharding.all_reduce_fsdp_(torch.stack([drift, scale]), mesh)
    return stats_from_partials([torch.stack([d, sc]).float() for d, sc in zip(drift, scale)], m)


def rank_worker_mean(px, mesh):
    """The f32 worker mean of every bucket (every leaf of a per-leaf x) over
    all ranks, alike on every rank: the rows' f32 sums, one blocking
    all-reduce, divided by m. f32 buffers of the plane's layout with no lead
    axis (a column slice's means gathered over the fsdp group into whole
    rows), or a nested dict of f32 leaves without their worker axis."""
    leaves, paths = (px.buffers, None) if isinstance(px, Packed) else tree_flatten(px)
    rows = [_rows(t) for t in leaves]
    m = rows[0].shape[0] * mesh.size
    buf = sharding.all_reduce_(_rank_sums(rows), mesh)
    buf.div_(torch.full((), float(m), dtype=torch.float32, device=buf.device))
    if paths is None:  # a column slice's means: the worker's row gathered over its F ranks
        return sharding.unshard(px.with_buffers(_wire_views(buf, rows)), mesh)
    return tree_unflatten(paths, [v.reshape(t.shape[1:]) for v, t in zip(_wire_views(buf, rows), leaves)])


def _rank_average_(px: Packed, mesh, membership=None, probe: bool = False):
    """Every row (with ``membership`` only the live rows) of every bucket
    takes the (weighted) worker mean over all ranks: the rows' f32 partial
    sums, one blocking all-reduce, then round(S / m) or round(S) —
    :func:`_average_rows_`'s values. With ``probe``, the pre-average stats
    (the same sums serve the probe when unweighted). Returns the stats or
    None."""
    mem = sharding.rows_of(membership, mesh)
    stats = rank_probe(px, mesh) if probe and mem is not None else None
    buf = sharding.all_reduce_(_rank_sums(px, None if mem is None else mem.weights), mesh)
    if probe and mem is None:
        stats = rank_probe(px, mesh, sums=buf)
    m = px.lead_shape[0] * mesh.size
    for b, s in zip(px.buffers, _wire_views(buf, px)):
        rows = _rows(b)
        for c in column_chunks(rows):
            avg = _finish_sum(s[c], m, mem is not None, b.dtype)[None]
            if mem is None:
                rows[:, c].copy_(avg.expand(rows.shape[0], -1))
            else:  # dead rows keep their stale parameters (they re-sync on rejoin)
                torch.where((mem.mask > 0)[:, None], avg, rows[:, c], out=rows[:, c])
    return stats


def check_rank_path(strategy) -> None:
    """Raise ``NotImplementedError`` for a strategy of one's own (or a
    legacy ``Algorithm`` of one's own) with no rank boundary: the one thing
    the worker axis does not run."""
    if not strategy.rank_capable:
        raise NotImplementedError(f"strategy {strategy.name!r} has no rank boundary: it cannot run on a worker mesh "
                                  f"(torch.distributed ranks); set rank_capable once its boundary reduces over the "
                                  f"ranks")


def check_fsdp_path(strategy, packed_step: bool, paths=()) -> None:
    """On a mesh with fsdp > 1, raise ``NotImplementedError`` (ROADMAP item
    10c's second part) for what only runs on whole rows: the per-leaf path
    (``packed_step`` False: ``AlgoConfig.packed=False``, a legacy
    ``Algorithm``, an optimizer with no packed step), offload, a strategy
    whose anchor step is not elementwise (sparse_anchor's per-leaf top-k,
    PowerSGD's per-leaf factors) and MoE segments (a ``router`` among the
    parameter ``paths``: capacity and aux loss are functions of the whole
    token set)."""
    mesh = sharding.current_mesh()
    if mesh is None or mesh.fsdp == 1:
        return
    if not packed_step:
        raise sharding.unsupported_on_ranks("the per-leaf path (AlgoConfig.packed=False, a legacy Algorithm or an "
                                            "optimizer with no packed step) with fsdp > 1")
    if strategy.cfg.offload:
        raise sharding.unsupported_on_ranks("host offload (AlgoConfig.offload) with fsdp > 1")
    if not strategy.fsdp_capable:
        raise sharding.unsupported_on_ranks(f"strategy {strategy.name!r} with fsdp > 1 (its anchor step is per leaf)")
    if any(p and p[-1] == "router" for p in paths):
        raise sharding.unsupported_on_ranks("MoE segments with fsdp > 1")


class CommStrategy:
    """Base strategy: Local SGD without averaging (every hook a no-op).

    ``x`` is the worker-stacked plane (``Packed``) when :attr:`packed`,
    else a nested dict of worker-stacked leaves (the per-leaf oracle)."""

    name = "base"
    # under AlgoConfig.offload the in-flight plane comes back to the device
    # at the boundary, unless the strategy reads it inside the window
    consumes_inflight_midround = False
    # runs its boundary on a worker mesh (_rank_boundary)
    rank_capable = False
    # on a mesh, its packed resident anchor is stored as the rank's piece (anchor_flat)
    shards_anchor = False
    # runs on column slices (fsdp > 1): its boundary is elementwise over the columns
    fsdp_capable = True

    def __init__(self, cfg: AlgoConfig):
        self.cfg = cfg
        self.tau = cfg.tau
        # the packed boundary (the default), or the per-leaf oracle
        self.packed = bool(cfg.packed)

    def init_vars(self, x) -> AlgoVars:
        return AlgoVars()

    def init_inflight(self, x, vars: AlgoVars):
        """The carried collective round 0's boundary consumes."""
        return None

    # ---- per-local-step hooks ----
    def transform_grads(self, grads, vars: AlgoVars):
        """Gradient-space hook on the per-leaf worker-stacked gradients."""
        return grads, vars

    def transform_grads_packed(self, pg: Packed, vars: AlgoVars):
        """Gradient-space hook on the worker-stacked gradient plane."""
        return pg, vars

    def local_post_update(self, x, vars: AlgoVars, inflight, k_in_round: int):
        """Per-leaf mid-round consumption point, after the optimizer update of
        local step ``k_in_round`` (0-based)."""
        return x

    def local_post_update_packed(self, px: Packed, vars: AlgoVars, inflight, k_in_round: int) -> Packed:
        """:meth:`local_post_update` on the plane."""
        return px

    # ---- per-leaf round-boundary phases ----
    def boundary_apply(self, x, vars: AlgoVars, inflight, membership=None):
        """Phase 1: consume the collective launched last round (eq. 4); it
        starts no collective. Returns ``(x, vars)``."""
        return x, vars

    def boundary_launch(self, x, vars: AlgoVars, membership=None):
        """Phase 2: launch this round's collective (eq. 5). Returns
        ``(vars, inflight)``."""
        return vars, None

    def boundary_round(self, x, vars: AlgoVars, inflight, probe: bool = False, membership=None):
        """One round boundary: consume ``inflight`` (eq. 4), launch the next
        collective (eq. 5). Returns ``(x, vars, inflight)``, with ``probe``
        also the pre-boundary plane's
        :class:`~repro_torch.kernels.consensus_probe.ConsensusStats`.
        ``membership`` masks the boundary. Per leaf, the two phases in turn;
        packed, one fused pass (:meth:`_packed_boundary`); on a worker mesh
        the rank boundary (:meth:`_rank_boundary`)."""
        mesh = sharding.current_mesh()
        if mesh is not None:
            check_rank_path(self)
            if not self.packed:
                return self._boundary_phases(x, vars, inflight, probe=probe, membership=membership)
            px = _as_plane(x)
            out = self._rank_boundary(px, vars, inflight, mesh, probe=probe, membership=membership)
            return (_write_back(x, px),) + tuple(out[1:])
        if not self.packed:
            return self._boundary_phases(x, vars, inflight, probe=probe, membership=membership)
        px = _as_plane(x)
        out = self._packed_boundary(px, vars, inflight, probe=probe, membership=membership)
        return (_write_back(x, px),) + tuple(out[1:])

    def _boundary_phases(self, x, vars: AlgoVars, inflight, probe: bool = False, membership=None):
        """The per-leaf composition: apply, then launch (on a worker mesh the
        probe over all ranks, :func:`rank_probe` on the leaves' rows)."""
        mesh = sharding.current_mesh()
        if probe and mesh is not None:
            stats = rank_probe([_rows(t) for t in tensors_of(x)], mesh)
        else:
            stats = tree_probe(x) if probe else None
        x, vars = self.boundary_apply(x, vars, inflight, membership=membership)
        vars, inflight = self.boundary_launch(x, vars, membership=membership)
        return _with_stats((x, vars, inflight), stats)

    def _packed_boundary(self, px: Packed, vars: AlgoVars, inflight, probe: bool = False, membership=None):
        """The packed boundary; with no boundary math (base, sync_sgd,
        powersgd) the plane passes through."""
        return _with_stats((px, vars, None), packed_probe(px) if probe else None)

    def _rank_boundary(self, px: Packed, vars: AlgoVars, inflight, mesh, probe: bool = False, membership=None):
        """The boundary of this rank's rows on a worker mesh; returns
        ``(x, vars, inflight)``, with ``probe`` also the stats of the
        pre-boundary plane over all ranks. ``membership`` is the round's
        (m,) one, alike on every rank. Only the strategies with
        :attr:`rank_capable` define it."""
        raise sharding.unsupported_on_ranks(f"strategy {self.name!r}")

    # ---- diagnostics ----
    def metrics(self, x, vars: AlgoVars) -> dict:
        """``consensus_dist``: Σ_i ‖x_i − x̄‖² / m over the leaves (0-dim f32)."""
        leaves = leaf_views(x) if isinstance(x, Packed) else tree_flatten(x)[0]
        total = 0.0
        for t in leaves:
            mean = _mean_rows(t)
            total = total + torch.sum(torch.square(t.float() - mean[None].float()))
        return {"consensus_dist": total / max(tensors_of(x)[0].shape[0], 1)}


class SyncSGDStrategy(CommStrategy):
    """Fully synchronous SGD: the gradient mean every local step (τ = 1)."""

    name = "sync_sgd"
    rank_capable = True

    def __init__(self, cfg: AlgoConfig):
        super().__init__(cfg)
        self.tau = 1

    def transform_grads(self, grads, vars):
        """Per leaf, the worker mean written back to every worker's row (on a
        worker mesh over all ranks: one blocking all-reduce a step)."""
        for g, avg in zip(tree_flatten(grads)[0], tree_flatten(_worker_mean(grads))[0]):
            g.copy_(avg.expand_as(g))
        return grads, vars

    def transform_grads_packed(self, pg: Packed, vars):
        """One worker mean per bucket, written back to every worker's row; on
        a worker mesh over all ranks (a blocking all-reduce a step)."""
        mesh = sharding.current_mesh()
        if mesh is not None:
            _rank_average_(pg, mesh)
            return pg, vars
        for b, g in zip(pg.buffers, _packed_worker_mean(pg).buffers):
            b.copy_(g.expand_as(b))
        return pg, vars

    def _rank_boundary(self, px: Packed, vars, inflight, mesh, probe: bool = False, membership=None):
        # no boundary math and no membership, as on one process
        return _with_stats((px, vars, None), rank_probe(px, mesh) if probe else None)


def _average_rows_(t: torch.Tensor, weights=None, mask=None, avg=None) -> None:
    """Local SGD's average of one (m, ...) buffer in place: every row (with
    ``mask`` only the live rows) takes the (weighted) worker mean, or
    ``avg`` where it is given."""
    avg = _mean_rows(t, weights) if avg is None else avg
    if mask is None:
        t.copy_(avg.expand_as(t))
    else:  # dead rows keep their stale parameters (they re-sync on rejoin)
        torch.where((mask > 0).reshape((-1,) + (1,) * (t.dim() - 1)), avg[None], t, out=t)


class LocalSGDStrategy(CommStrategy):
    """Periodic model averaging, eq. (2); blocking: nothing is launched."""

    name = "local_sgd"
    rank_capable = True

    def _rank_boundary(self, px: Packed, vars, inflight, mesh, probe: bool = False, membership=None):
        """The (masked) worker mean over all ranks, blocking; unmasked, its
        one all-reduce also gives the probe its mean."""
        stats = _rank_average_(px, mesh, membership, probe=probe)
        return _with_stats((px, vars, None), stats)

    def boundary_apply(self, x, vars, inflight, membership=None):
        mem = _local(membership)
        mask = None if mem is None else mem.mask
        means = tree_flatten(_worker_mean(x, _mem_weights(membership)))[0]  # blocking over the ranks
        for t, avg in zip(tree_flatten(x)[0], means):
            _average_rows_(t, mask=mask, avg=avg)
        return x, vars

    def _packed_boundary(self, px: Packed, vars, inflight, probe: bool = False, membership=None):
        # the probe reads the pre-average plane: after the average the drift is 0
        stats = packed_probe(px) if probe else None
        mask = None if membership is None else membership.mask
        for b in px.buffers:
            _average_rows_(b, _mem_weights(membership), mask)
        return _with_stats((px, vars, None), stats)


def _momentum_(v: torch.Tensor, mean: torch.Tensor, z: torch.Tensor, beta: float) -> torch.Tensor:
    """Eqs. (10)–(11), K3's chain: v ← β·v + (mean − z) in place; returns
    z' = z + v. Over chunks of the flattened anchor."""
    z_next = torch.empty_like(z)
    vf, mf, zf, of = (t.reshape(1, -1) for t in (v, mean, z, z_next))
    for c in column_chunks(vf):
        zc = zf[:, c].float()
        vf[:, c] = (beta * vf[:, c].float() + (mf[:, c].float() - zc)).to(v.dtype)
        of[:, c] = (zc + vf[:, c].float()).to(z.dtype)
    return z_next


class OverlapLocalSGDStrategy(CommStrategy):
    """The paper's algorithm (+ anchor momentum when ``anchor_beta`` > 0).

    Per bucket one fused kernel: the pullback toward the anchor launched a
    round ago (eq. 4), the worker mean of the pulled-back plane (eq. 5) and,
    with momentum, v ← β·v + (mean − z), z ← z + v (eqs. 10–11). Per leaf:
    K5's row form, then the worker mean and the momentum chain."""

    name = "overlap_local_sgd"
    rank_capable = True
    shards_anchor = True

    def __init__(self, cfg: AlgoConfig):
        super().__init__(cfg)
        self.momentum = cfg.anchor_beta > 0

    def init_vars(self, x) -> AlgoVars:
        if not self.momentum:
            return AlgoVars()
        if self.packed:
            z = _init_anchor(self, x)
            return AlgoVars(z=z, v=packed_like(z, 0.0))
        z = _first_row(x)
        return AlgoVars(z=z, v=tree_map(torch.zeros_like, z))

    def init_inflight(self, x, vars):
        return _init_anchor(self, x) if self.packed else _first_row(x)

    def boundary_apply(self, x, vars: AlgoVars, inflight, membership=None):
        inflight = _arrived(inflight, vars)  # on a worker mesh: the sum waited on, the momentum chain run
        _pullback(x, inflight, self.cfg.alpha, membership)
        if self.momentum:  # the consumed anchor: launch needs it for eq. (10)
            vars = AlgoVars(z=inflight, v=vars.v, extra=vars.extra)
        return x, vars

    def boundary_launch(self, x, vars: AlgoVars, membership=None):
        if not self.momentum:
            return _launch_leaves(x, vars, membership)
        z, beta = vars.z, self.cfg.anchor_beta

        def finish(mean_x, vars):  # eqs. (10)-(11) from the launch's anchor (on a mesh, at the next boundary)
            return tree_map(lambda v, mn, zz: _momentum_(v, mn, zz, beta), vars.v, mean_x, z)

        return _launch_leaves(x, vars, membership, finish)

    def _packed_boundary(self, px: Packed, vars: AlgoVars, inflight, probe: bool = False, membership=None):
        alpha, weights = self.cfg.alpha, _mem_weights(membership)
        if self.momentum:
            beta = self.cfg.anchor_beta
            outs = [
                anchor_ops.pullback_mean_momentum(bx, bz, bv, alpha, beta, probe=probe, weights=weights)
                for bx, bz, bv in zip(px.buffers, inflight.buffers, vars.v.buffers)
            ]
            # the consumed anchor becomes vars.z; v was updated in place
            vars = AlgoVars(z=inflight, v=vars.v, extra=vars.extra)
        else:
            outs = _pullback_mean(px, inflight, alpha, probe=probe, weights=weights)
        z_next = Packed(tuple(o[1] for o in outs), inflight.layout)
        return _with_stats((px, vars, z_next), _fused_stats(outs, px.lead_shape[0], probe))

    def _rank_boundary(self, px: Packed, vars: AlgoVars, inflight, mesh, probe: bool = False, membership=None):
        """:func:`_rank_anchor_boundary` with this strategy's α and β; the
        consumed anchor becomes vars.z under momentum, as on one device."""
        beta = self.cfg.anchor_beta if self.momentum else None
        z, out, stats = _rank_anchor_boundary(px, inflight, mesh, self.cfg.alpha, beta,
                                              vars.v if self.momentum else None, probe, membership)
        if self.momentum:
            vars = AlgoVars(z=z, v=vars.v, extra=vars.extra)
        return _with_stats((px, vars, out), stats)


def _rank_anchor_boundary(px: Packed, inflight, mesh, alpha: float, beta, v, probe: bool, membership):
    """Overlap-Local-SGD's rank boundary: wait on the all-reduce the last
    boundary launched (τ local steps ran under it) and finish its anchor (a
    mean, or the weighted sum of its membership; with ``beta`` the momentum
    v updated in place); pull this rank's rows back toward it (dead rows
    pass through) and launch the sum of their (weighted) partial sums (K3/K4's
    rank form, one launch a bucket, then one ``all_reduce_async``). The
    first boundary (and the first after a drain) finds the final anchor in
    ``inflight`` and starts at the pullback. With ``probe`` the pre-pullback
    stats come first, from a blocking all-reduce of the rows' sums and K8's
    rank form. Returns (the anchor pulled toward, the :class:`RankInflight`,
    the stats or None). A sharded anchor takes :func:`_shard_anchor_boundary`."""
    if isinstance(inflight, (RankShardInflight, sharding.Sharded)):
        return _shard_anchor_boundary(px, inflight, mesh, alpha, beta, v, probe, membership)
    stats = rank_probe(px, mesh) if probe else None
    mem = sharding.rows_of(membership, mesh)
    weights = None if mem is None else mem.weights
    if isinstance(inflight, RankInflight) and inflight.done is None:  # finished inside the launch
        inflight.handle.wait()
        base, buf, fin = inflight.z, inflight.buf, 2 if inflight.weighted else 1
    elif isinstance(inflight, RankInflight):  # finished by a drain
        base, buf, fin = inflight.done, inflight.buf, 0
    else:
        base, buf, fin = inflight, _wire_buffer(px), 0
    m = px.lead_shape[0] * mesh.size
    vs = v.buffers if v is not None else (None,) * len(px.buffers)
    z = Packed(tuple(anchor_ops.pullback_rank(bx, bz, bv, s, m, alpha, beta, fin, weights=weights)
                     for bx, bz, bv, s in zip(px.buffers, base.buffers, vs, _wire_views(buf, px))), base.layout)
    if isinstance(inflight, RankInflight):
        inflight.done = z
    handle = sharding.all_reduce_async(buf, mesh)
    return z, RankInflight(z=z, buf=buf, handle=handle, m=m, beta=beta, weighted=weights is not None), stats


def _shard_anchor_boundary(px: Packed, inflight, mesh, alpha: float, beta, v, probe: bool, membership):
    """Overlap-Local-SGD's rank boundary with the anchor stored as the
    rank's piece: wait on the reduce-scatter the last boundary launched and
    finish the piece (:meth:`RankShardInflight.finished`: K3/K4's rank form
    with no rows, v's piece in place); all-gather the pieces of the rank's
    column slice over the worker group; pull the rows back toward it and
    write their (weighted) partial sums over the slice (K4's rank form with
    no finish, one launch a bucket); launch the reduce-scatter of those sums
    over the worker group. The first boundary (and the first after a drain)
    finds the finished piece in ``inflight``. The values are the replicated
    path's: the finish is elementwise. Returns (the piece pulled toward, the
    :class:`RankShardInflight`, the stats or None)."""
    stats = rank_probe(px, mesh) if probe else None
    mem = sharding.rows_of(membership, mesh)
    weights = None if mem is None else mem.weights
    if isinstance(inflight, RankShardInflight):
        z = inflight.finished(AlgoVars(v=v))
        wire, sums = inflight.wire, inflight.sums
    else:
        z = inflight
        wire, sums = _shard_wire(z.split, z.buffers[0].device)
    m = px.lead_shape[0] * mesh.size
    cols = sharding.anchor_columns(z, mesh)
    for bx, bz, s in zip(px.buffers, cols.buffers, _wire_cols(wire, z.split)):
        anchor_ops.pullback_rank(bx, bz, None, s, m, alpha, None, 0, weights=weights)
    handle = sharding.reduce_scatter_async(_wire_segments(wire, z.split), _piece_views(sums, z.split), mesh)
    return z, RankShardInflight(z, wire, sums, handle, m, beta, weights is not None), stats


def _pullback_mean(px: Packed, z: Packed, alpha: float, mean_pre: bool = False, probe: bool = False, weights=None):
    """K4 per bucket: x pulled back in place; returns each bucket's outputs
    (x, mean[, stats])."""
    return [anchor_ops.pullback_mean(bx, bz, alpha, mean_pre=mean_pre, probe=probe, weights=weights)
            for bx, bz in zip(px.buffers, z.buffers)]


def _easgd_rate(alpha: float, m: int, membership):
    """z's mixing rate min(α·m_live, 1): a Python float when fully live, a
    device tensor when masked (the reference's traced rate)."""
    if membership is None:
        return min(alpha * m, 1.0)
    return torch.clamp(alpha * membership.live_count(), max=1.0)


class EASGDStrategy(CommStrategy):
    """Elastic-averaging SGD [19], blocking: per bucket K4 pulls x toward z
    and takes the mean of the *pre*-pullback plane (``mean_pre``, the
    symmetric mix), then z ← (1 − r)·z + r·mean with r = min(α·m, 1), in
    the plane's dtype (the reference's ``tree_lerp`` at native dtype). Masked,
    r = min(α·m_live, 1) is a device tensor and the lerp runs in f32, as the
    reference's traced rate makes it. Per leaf: the mean of x first, then
    K5's row form and :func:`~repro_torch.utils.tree.tree_lerp`."""

    name = "easgd"
    rank_capable = True
    shards_anchor = True

    def init_vars(self, x) -> AlgoVars:
        return AlgoVars(z=_init_anchor(self, x) if self.packed else _first_row(x))

    def boundary_apply(self, x, vars: AlgoVars, inflight, membership=None):
        rate = _easgd_rate(self.cfg.alpha, _leading(x), membership)
        mean_x = _worker_mean(x, _mem_weights(membership))  # pre-pullback models (symmetric W)
        _pullback(x, vars.z, self.cfg.alpha, membership)
        return x, AlgoVars(z=tree_lerp(vars.z, mean_x, rate), v=vars.v, extra=vars.extra)

    def _packed_boundary(self, px: Packed, vars: AlgoVars, inflight, probe: bool = False, membership=None):
        alpha = self.cfg.alpha
        outs = _pullback_mean(px, vars.z, alpha, mean_pre=True, probe=probe, weights=_mem_weights(membership))
        self._lerp_anchor_(vars.z, [o[1] for o in outs], _easgd_rate(alpha, px.lead_shape[0], membership))
        return _with_stats((px, vars, None), _fused_stats(outs, px.lead_shape[0], probe))

    @staticmethod
    def _lerp_anchor_(z: Packed, means, rate) -> None:
        """z ← (1 − r)·z + r·mean per bucket, in place (``means`` scaled in
        place too): fully live each product and the sum rounded to z's dtype,
        the constants rounded to it first (JAX weak types); masked (a device
        rate) in f32."""
        for bz, mean in zip(z.buffers, means):
            if isinstance(rate, torch.Tensor):
                bz.copy_(((1.0 - rate) * bz.float() + rate * mean.float()).to(bz.dtype))
            else:
                bz.mul_(weak(1.0 - rate, bz.dtype)).add_(mean.mul_(weak(rate, bz.dtype)))

    def _rank_boundary(self, px: Packed, vars: AlgoVars, inflight, mesh, probe: bool = False, membership=None):
        """Blocking: K4's rank form pulls the rows toward z and writes the
        (weighted) partial sums of the pre-pullback rows; one all-reduce;
        z lerps toward their mean at min(α·m_live, 1) over all m workers."""
        stats = rank_probe(px, mesh) if probe else None
        alpha, m = self.cfg.alpha, px.lead_shape[0] * mesh.size
        mem = sharding.rows_of(membership, mesh)
        weights = None if mem is None else mem.weights
        if isinstance(vars.z, sharding.Sharded):  # z's piece: gathered over the slice, the sums reduce-scattered
            sp = vars.z.split
            buf, sums = _shard_wire(sp, vars.z.buffers[0].device)
            z_cols, views, pieces = sharding.anchor_columns(vars.z, mesh), _wire_cols(buf, sp), _piece_views(sums, sp)
        else:
            buf = _wire_buffer(px)
            z_cols, views = vars.z, _wire_views(buf, px)
        for bx, bz, s in zip(px.buffers, z_cols.buffers, views):
            anchor_ops.pullback_rank(bx, bz, None, s, m, alpha, None, 0, weights=weights, mean_pre=True)
        if isinstance(vars.z, sharding.Sharded):
            sharding.reduce_scatter_async(_wire_segments(buf, sp), pieces, mesh).wait()
        else:
            pieces = _wire_views(sharding.all_reduce_(buf, mesh), px)
        means = [_finish_sum(s, m, weights is not None, bz.dtype) for s, bz in zip(pieces, vars.z.buffers)]
        self._lerp_anchor_(vars.z, means, _easgd_rate(alpha, m, membership))
        return _with_stats((px, vars, None), stats)


def _rebase_rows_(bx: torch.Tensor, b0: torch.Tensor, av: torch.Tensor, membership=None) -> None:
    """x_i ← (avg + x_i) − x₀ᵢ in f32, cast to x's dtype, in place on the
    (m, ...) buffer ``bx`` over column chunks; with ``membership`` only the
    live rows."""
    bx, b0, av = _rows(bx), _rows(b0), av.reshape(-1)
    for c in column_chunks(bx):
        new = (av[None, c].float() + bx[:, c].float() - b0[:, c].float()).to(bx.dtype)
        if membership is not None:
            new = torch.where((membership.mask > 0)[:, None], new, bx[:, c])
        bx[:, c] = new


class _AvgRebaseStrategy(CommStrategy):
    """Strategies whose launched collective is the worker mean of the
    round's models plus each worker's launch-time copy, and whose
    consumption re-bases x_i ← avg(x₀) + (x_i − x₀ᵢ)."""

    class Inflight(NamedTuple):
        avg: Any  # mean of the launch-time models (the overlapped collective)
        x0: Any  # the launch-time models, a copy of their own

        ROWS = ("x0",)  # worker-stacked per leaf (on a worker mesh the rank's rows)

    rank_capable = True
    shards_anchor = True

    def init_inflight(self, x, vars):
        if self.packed:
            px = _as_plane(x)
            mesh = sharding.current_mesh()
            if mesh is None:
                return self.Inflight(avg=_packed_worker_mean(px), x0=_copy_plane(px))
            # every row starts equal: the mean of m copies of this rank's first
            # row is the stacked run's mean, bit for bit, with no collective
            m = px.lead_shape[0] * mesh.size
            avg = Packed(tuple(_mean_rows(b[:1].expand(m, -1)) for b in px.buffers), px.layout)
            if _shards_anchor(self, x):
                avg = sharding.shard_anchor(avg, mesh)
            return self.Inflight(avg=avg, x0=_copy_plane(px))
        if sharding.current_mesh() is None:
            return self.Inflight(avg=_worker_mean(x), x0=_clone(x))
        m = _leading(x)  # every row starts equal: the mean of m copies of a row, with no collective
        return self.Inflight(avg=tree_map(lambda t: _mean_rows(t[:1].expand(m, *t.shape[1:])), x), x0=_clone(x))

    @staticmethod
    def _rebase(x, inflight, membership=None):
        """The rebase per leaf, in place (``inflight`` a rank boundary's
        pending average: waited on and finished first)."""
        inflight, mem = _arrived(inflight), _local(membership)
        tree_map(lambda t, t0, av: _rebase_rows_(t, t0, av, mem), x, inflight.x0, inflight.avg)
        return x

    @staticmethod
    def _rebase_packed(px: Packed, inflight, membership=None) -> Packed:
        """The rebase over the plane, in place (a sharded average's pieces
        all-gathered over the rank's column slice first)."""
        avg = inflight.avg
        if isinstance(avg, sharding.Sharded) and avg.anchor:
            avg = sharding.anchor_columns(avg)
        for bx, b0, av in zip(px.buffers, inflight.x0.buffers, avg.buffers):
            _rebase_rows_(bx, b0, av, membership)
        return px

    def boundary_launch(self, x, vars, membership=None):
        x0 = _clone(x)  # on a worker mesh finished where it is consumed
        return _launch_leaves(x, vars, membership, lambda avg, _: self.Inflight(avg=avg, x0=x0))

    def _packed_launch(self, px: Packed, inflight, weights=None):
        """The next collective from the plane: the (weighted) worker mean, and
        x₀ copied into the consumed in-flight plane's buffer."""
        for b0, bx in zip(inflight.x0.buffers, px.buffers):
            b0.copy_(bx)
        return self.Inflight(avg=_packed_worker_mean(px, weights), x0=inflight.x0)

    def _consumes_at_boundary(self) -> bool:
        return True

    def _rank_boundary(self, px: Packed, vars, inflight, mesh, probe: bool = False, membership=None):
        """Rebase the rank's live rows onto the average launched a round ago
        (waited on here, unless consumed mid-round), then launch the next:
        x₀ ← the rows, and an async all-reduce of their (weighted) f32
        partial sums into the consumed in-flight's wire buffer. With
        ``probe`` the pre-rebase stats come first (a blocking all-reduce of
        the rows' sums and K8's rank form)."""
        stats = rank_probe(px, mesh) if probe else None
        mem = sharding.rows_of(membership, mesh)
        pending = isinstance(inflight, RankRebaseInflight)
        done = inflight.finished() if pending else inflight  # waits, also when not consumed here
        if self._consumes_at_boundary():
            self._rebase_packed(px, done, mem)
        for b0, bx in zip(done.x0.buffers, px.buffers):
            b0.copy_(bx)
        weights = None if mem is None else mem.weights
        m = px.lead_shape[0] * mesh.size
        if isinstance(done.avg, sharding.Sharded):  # the average's pieces: a reduce-scatter of the slice's sums
            sp = done.avg.split
            buf, sums = (inflight.buf, inflight.sums) if pending else _shard_wire(sp, done.avg.buffers[0].device)
            _write_sums(px, _wire_cols(buf, sp), weights)
            handle = sharding.reduce_scatter_async(_wire_segments(buf, sp), _piece_views(sums, sp), mesh)
            out = RankRebaseInflight(done.x0, buf, handle, m, weights is not None, sums=sums, like=done.avg)
            return _with_stats((px, vars, out), stats)
        buf = _rank_sums(px, weights, inflight.buf if pending else None)
        handle = sharding.all_reduce_async(buf, mesh)
        out = RankRebaseInflight(done.x0, buf, handle, m, weights is not None)
        return _with_stats((px, vars, out), stats)


class CoCoDStrategy(_AvgRebaseStrategy):
    """CoCoD-SGD [20]: the boundary re-bases every worker onto the average
    launched a round ago plus its local delta, then launches the average of
    the re-based models. :class:`DelayedAveragingStrategy` with the delay
    pinned to τ."""

    name = "cocod"

    def boundary_apply(self, x, vars, inflight, membership=None):
        return self._rebase(x, inflight, membership), vars

    def _packed_boundary(self, px: Packed, vars, inflight, probe: bool = False, membership=None):
        # the rebase reads no pullback kernel: the standalone probe of the pre-rebase plane
        stats = packed_probe(px) if probe else None
        self._rebase_packed(px, inflight, membership)
        return _with_stats((px, vars, self._packed_launch(px, inflight, _mem_weights(membership))), stats)


class PowerSGDStrategy(CommStrategy):
    """PowerSGD [5]: rank-r gradient compression, synchronous (τ = 1); the
    compressed collectives live in the gradient hook
    (:mod:`repro_torch.core.powersgd`, which this strategy delegates to), the
    boundary is empty."""

    name = "powersgd"
    rank_capable = True
    fsdp_capable = False

    def __init__(self, cfg: AlgoConfig):
        super().__init__(cfg)
        self.tau = 1
        from repro_torch.core.powersgd import PowerSGD  # deferred: powersgd imports the legacy shim

        self._impl = PowerSGD(cfg)
        self.rank = self._impl.rank

    def init_vars(self, x) -> AlgoVars:
        if self.packed:
            return self._impl.init_vars_packed(_as_plane(x))
        return self._impl.init_vars(x)

    def transform_grads(self, grads, vars: AlgoVars):
        if isinstance(vars.extra.err, Packed):
            # a packed state but per-leaf gradients (an optimizer without a
            # packed step): the transform runs on their plane
            pg = pack(grads, lead=1)
            pg, vars = self._impl.transform_grads_packed(pg, vars)
            return _write_back(grads, pg), vars
        return self._impl.transform_grads(grads, vars)

    def transform_grads_packed(self, pg: Packed, vars: AlgoVars):
        """On a worker mesh the factor sums are all-reduced over the ranks."""
        return self._impl.transform_grads_packed(pg, vars)

    def _rank_boundary(self, px: Packed, vars, inflight, mesh, probe: bool = False, membership=None):
        # no boundary math and no membership, as on one process
        return _with_stats((px, vars, None), rank_probe(px, mesh) if probe else None)


class DelayedAveragingStrategy(_AvgRebaseStrategy):
    """DaSGD-style delayed averaging (arXiv:2006.00441): the average launched
    at a boundary is applied ``delay_steps`` local steps into the next round,
    x_i ← avg(x₀) + (x_i − x₀ᵢ) after local step k = delay − 1; delay = τ
    consumes at the boundary (CoCoD)."""

    name = "delayed_avg"

    def __init__(self, cfg: AlgoConfig):
        super().__init__(cfg)
        if not 1 <= cfg.delay_steps <= cfg.tau:
            raise ValueError(f"delay_steps must be in [1, tau={cfg.tau}], got {cfg.delay_steps}")
        self.delay = cfg.delay_steps

    @property
    def consumes_inflight_midround(self) -> bool:
        # delay < τ: the average is applied inside the window
        return self.delay < self.tau

    def _arrives(self, k_in_round: int) -> bool:
        return self.delay < self.tau and k_in_round == self.delay - 1

    def local_post_update(self, x, vars, inflight, k_in_round: int):
        if not self._arrives(k_in_round):
            return x
        if self.packed:  # a packed in-flight plane, per-leaf x
            px = pack(x, lead=1)
            return _write_back(x, self._rebase_packed(px, _arrived(inflight)))
        return self._rebase(x, inflight)

    def local_post_update_packed(self, px: Packed, vars, inflight, k_in_round: int) -> Packed:
        if self._arrives(k_in_round):  # on a worker mesh: the average's all-reduce is waited here
            self._rebase_packed(px, _arrived(inflight))
        return px

    def _consumes_at_boundary(self) -> bool:
        return self.delay >= self.tau

    def boundary_apply(self, x, vars, inflight, membership=None):
        # the mask covers the boundary's consumption only: the mid-round rebase
        # consumes a collective launched under the last round's membership
        if self.delay >= self.tau:
            self._rebase(x, inflight, membership)
        return x, vars

    def _packed_boundary(self, px: Packed, vars, inflight, probe: bool = False, membership=None):
        stats = packed_probe(px) if probe else None
        if self.delay >= self.tau:
            self._rebase_packed(px, inflight, membership)
        return _with_stats((px, vars, self._packed_launch(px, inflight, _mem_weights(membership))), stats)


_SORT_MAX = 1 << 24  # past this many elements a quantile's order statistics are searched for, not sorted


def _order_statistic(a: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th smallest (0-based) element of a 1-D float32 tensor of
    non-negative finite values, exactly, without a sort: a binary search
    over the float bit patterns (ordered as the values are) counting the
    elements at or below the midpoint, 31 counting passes. A sort of a
    full-width LM's embedding leaf would take 6 GiB of values and indices.
    Returns a 0-dim float32 tensor on ``a``'s device."""
    bits = a.view(torch.int32)
    lo, hi = 0, 0x7F800000  # +0.0 .. +inf
    while lo < hi:
        mid = (lo + hi) // 2
        if int(torch.count_nonzero(bits <= mid)) > k:
            hi = mid
        else:
            lo = mid + 1
    return torch.tensor(lo, dtype=torch.int32, device=a.device).view(torch.float32)


def _quantile_linear(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(a, q, method="linear")`` of a 1-D float32 tensor, in
    float32 as JAX computes it: position q·(n − 1) with q and n rounded to
    float32, the two neighbouring order statistics from a sort, and
    lo·(1 − h) + hi·h. (``torch.quantile`` refuses more than 2^24 elements.)
    Past ``_SORT_MAX`` elements of non-negative values (the magnitudes the
    sparse step ranks) the order statistics come from
    :func:`_order_statistic`: the same values, no sort."""
    n = a.numel()
    pos = np.float32(q) * (np.float32(n) - np.float32(1))
    low, high = np.floor(pos), np.ceil(pos)
    hw = pos - low
    lw = np.float32(1) - hw
    last = np.float32(n) - np.float32(1)
    low, high = int(min(max(low, 0), last)), int(min(max(high, 0), last))
    if n > _SORT_MAX:
        lo_v = _order_statistic(a, low)
        hi_v = lo_v if high == low else _order_statistic(a, high)
        return lo_v * float(lw) + hi_v * float(hw)
    srt = torch.sort(a).values
    return srt[low] * float(lw) + srt[high] * float(hw)


def sparsify_topk(delta, k: float):
    """Per leaf of a nested dict, the top-``k`` fraction of ``delta`` by
    magnitude: an element is kept where |d| ≥ the (1 − k) linear quantile
    of the leaf's |d| (ties at the threshold are kept), else zeroed; leaves
    of ≤ 1 element are kept whole; k ≥ 1 is the identity. The reference's
    per-leaf oracle, a new tree."""
    if k >= 1.0:
        return delta

    def one(d):
        if d.numel() <= 1:
            return d
        thresh = _quantile_linear(d.float().abs().reshape(-1), 1.0 - k)
        return torch.where(d.abs() >= thresh.to(d.dtype), d, torch.zeros_like(d))

    return tree_map(one, delta)


def sparsify_topk_(delta: torch.Tensor, layout, bucket: int, k: float) -> torch.Tensor:
    """:func:`sparsify_topk` over the leaves of ``bucket`` of an f32 anchor
    delta plane, in place. Padding lanes hold zeros and stay zero. Returns
    ``delta`` (now the sparse payload s)."""
    for slot in leaf_segments(layout, bucket):
        if slot.size <= 1:
            continue
        seg = delta[slot.offset : slot.offset + slot.size]
        mag = seg.abs()
        seg.masked_fill_(mag < _quantile_linear(mag, 1.0 - k), 0.0)
    return delta


def _sparse_step(means, z: Packed, e: Packed, k: float) -> list:
    """The sparse anchor step per bucket from the worker means: Δ = mean − z
    + e in f32, s = the top-k of Δ leaf by leaf, e ← Δ − s in place, z' =
    round(z + s); at k = 1 z' is the mean. Returns the buckets of z'. One
    f32 plane of its own (Δ, made s in place; e takes Δ first), the rest over
    column chunks: a full-width LM's plane holds no second f32 copy."""
    if k >= 1.0:  # dense: z' = mean(x), nothing truncated
        return list(means)
    z_next = []
    for bi, (bm, bz, be) in enumerate(zip(means, z.buffers, e.buffers)):
        delta = torch.empty(bz.shape, dtype=torch.float32, device=bz.device)
        for c in column_chunks(delta[None]):
            delta[c] = bm[c].float() - bz[c].float() + be[c]
        be.copy_(delta)
        s = sparsify_topk_(delta, z.layout, bi, k)
        be.sub_(s)
        zn = torch.empty_like(bz)
        for c in column_chunks(s[None]):
            zn[c] = (bz[c].float() + s[c]).to(bz.dtype)
        z_next.append(zn)
    return z_next


def _leaf_sparse_step(mean_x, z, e, k: float):
    """The per-leaf sparse anchor step from the worker means: Δ = mean − z +
    e in f32, s = the top-k of Δ leaf by leaf, e ← Δ − s in place; returns
    z' = round(z + s) (the means at k = 1)."""
    if k >= 1.0:  # dense: z' = mean(x), nothing truncated
        return mean_x
    delta = tree_map(lambda m, zl, el: m.float() - zl.float() + el, mean_x, z, e)
    s = sparsify_topk(delta, k)
    tree_map(lambda el, d, si: el.copy_(d - si), e, delta, s)
    return tree_map(lambda zl, si: (zl.float() + si).to(zl.dtype), z, s)


class SparseAnchorStrategy(CommStrategy):
    """LOSCAR-style top-k sparse anchor averaging with error feedback:
    Overlap-Local-SGD (β = 0, K4 per bucket) whose launched anchor moves
    only by the top-``sparse_k`` part of Δ + e, Δ = mean(x) − z:

        s = top_k(Δ + e),  e' = (Δ + e) − s,  z' = z + s

    At ``sparse_k = 1`` it is exactly Overlap-Local-SGD with β = 0."""

    name = "sparse_anchor"
    rank_capable = True
    fsdp_capable = False

    def __init__(self, cfg: AlgoConfig):
        super().__init__(cfg)
        if not 0.0 < cfg.sparse_k <= 1.0:
            raise ValueError(f"sparse_k must be in (0, 1], got {cfg.sparse_k}")
        self.k = cfg.sparse_k

    def init_vars(self, x) -> AlgoVars:
        if self.packed:
            z = _pack_anchor(_as_plane(x))
            # f32 shadow of the anchor plane: the error feedback, element-aligned with z
            return AlgoVars(z=z, extra=packed_like(z, 0.0, dtype=torch.float32))
        z = _first_row(x)
        return AlgoVars(z=z, extra=tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device), z))

    def init_inflight(self, x, vars):
        return _pack_anchor(_as_plane(x)) if self.packed else _first_row(x)

    def boundary_apply(self, x, vars: AlgoVars, inflight, membership=None):
        inflight = _arrived(inflight, vars)  # on a worker mesh: the sum waited on, the sparse step taken
        _pullback(x, inflight, self.cfg.alpha, membership)
        # the consumed anchor is the base of this round's launched delta
        return x, AlgoVars(z=inflight, v=vars.v, extra=vars.extra)

    def boundary_launch(self, x, vars: AlgoVars, membership=None):
        z, k = vars.z, self.k  # on a worker mesh the sparse step is taken where the sum is waited on
        return _launch_leaves(x, vars, membership, lambda mean_x, vars: _leaf_sparse_step(mean_x, z, vars.extra, k))

    def _packed_boundary(self, px: Packed, vars: AlgoVars, inflight, probe: bool = False, membership=None):
        outs = _pullback_mean(px, inflight, self.cfg.alpha, probe=probe, weights=_mem_weights(membership))
        z_next = _sparse_step([o[1] for o in outs], inflight, vars.extra, self.k)
        # the consumed anchor is the base of this round's launched delta
        out = (px, AlgoVars(z=inflight, v=vars.v, extra=vars.extra), Packed(tuple(z_next), inflight.layout))
        return _with_stats(out, _fused_stats(outs, px.lead_shape[0], probe))

    def _rank_boundary(self, px: Packed, vars: AlgoVars, inflight, mesh, probe: bool = False, membership=None):
        """Wait on the worker sum the last boundary launched and take the
        sparse step (:meth:`RankSparseInflight.finished`: z_k from z_{k−1}
        and the mean, e updated); pull the rows toward z_k (dead rows pass
        through) and launch the sum of their (weighted) partial sums (K4's
        rank form, one launch a bucket, then one ``all_reduce_async`` into
        the consumed wire buffer). The first boundary (and the first after a
        drain) pulls toward the anchor in ``inflight``. With ``probe`` the
        pre-pullback stats come first."""
        stats = rank_probe(px, mesh) if probe else None
        pending = isinstance(inflight, RankSparseInflight)
        z = inflight.finished(vars) if pending else inflight
        mem = sharding.rows_of(membership, mesh)
        weights = None if mem is None else mem.weights
        buf = inflight.buf if pending else _wire_buffer(px)
        m = px.lead_shape[0] * mesh.size
        for bx, bz, s in zip(px.buffers, z.buffers, _wire_views(buf, px)):
            anchor_ops.pullback_rank(bx, bz, None, s, m, self.cfg.alpha, None, 0, weights=weights)
        handle = sharding.all_reduce_async(buf, mesh)
        out = RankSparseInflight(z, buf, handle, m, weights is not None, self.k)
        # the consumed anchor is the base of this round's launched delta
        return _with_stats((px, AlgoVars(z=z, v=vars.v, extra=vars.extra), out), stats)


class GossipInflight(NamedTuple):
    """A launched gossip push: the received neighbour-weighted sums (a
    worker-stacked plane or tree of its own) and the (m,) f32 received push
    weights that debias them at the next boundary (z_i = mix_i / w_i)."""

    mix: Any
    w: Any

    ROWS = ("mix",)  # worker-stacked per leaf (on a worker mesh the rank's rows)


class DrainedGossipInflight(GossipInflight):
    """A gossip in-flight value finished on a worker mesh: ``mix`` the
    rank's rows of the mix, ``w`` the (m,) push weights; ``phase`` (an
    attribute, not a field) the host's mirror of the phase counter, the
    next boundary's t (read from the device when absent)."""


class RankGossipInflight(_RankPending):
    """The in-flight push of a gossip rank boundary: ``own`` the rank's
    launch-time rows x' (a plane of their own, the exchange's send buffers),
    ``exchange`` the launched neighbour exchange of phase ``phase`` (the
    host's mirror of t at launch) and ``peers`` its schedule, ``peff`` the
    launch's (m, m) f32 Peff and ``w`` = Σ_j Peff[i, j], the (m,) push
    weights the next boundary debiases by. :meth:`finished` (the drain)
    waits once and forms the mix of the rank's rows into ``own`` (K5's
    gossip rank form, mode 2), the stacked run's in-flight value; with
    ``leaves`` (the per-leaf path: ``own`` every leaf's rows packed into one
    flat buffer a dtype) the mix comes back as per-leaf views."""

    # under the tests: the drain compares the host's phase with the device counter
    check_phase = False

    def __init__(self, own: Packed, exchange, peers, peff: torch.Tensor, w: torch.Tensor, phase: int,
                 leaves: bool = False):
        super().__init__()
        self.own, self.exchange, self.peers, self.peff, self.w, self.phase = own, exchange, peers, peff, w, phase
        self.leaves = leaves
        self.consumed = False  # a boundary formed the mix and rewrote own

    def finished(self, vars: AlgoVars) -> DrainedGossipInflight:
        if self.done is None:
            if self.consumed:
                raise RuntimeError("this gossip exchange was consumed by a later boundary; drain the newer state")
            if RankGossipInflight.check_phase and int(vars.extra[1]) != self.phase + 1:
                raise AssertionError(f"gossip phase: host {self.phase + 1}, device {int(vars.extra[1])}")
            recv = self.exchange.wait()
            lo = self.peers.rows[0]
            for b, bo in enumerate(self.own.buffers):
                anchor_ops.gossip_rank_(bo, bo, recv[b] if self.peers.received else None, self.peers.held,
                                        self.peers.received, lo, self.peff, self.w[:0].new_ones(bo.shape[0]),
                                        self.w[:0].new_zeros(bo.shape[0]), 0.0, mode=2)
            mix = tree_unflatten(self.own.layout.paths, leaf_views(self.own)) if self.leaves else self.own
            self.done = DrainedGossipInflight(mix=mix, w=self.w)
            self.done.phase = self.phase + 1
        return self.done


def _push(peff: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Peff @ t over the worker axis of an (m, ...) tensor, K5's gossip
    form's push (:func:`~repro_torch.kernels.anchor_mix.ref.push`) over
    column chunks, cast to t's dtype."""
    rows = _rows(t)
    out = torch.empty_like(rows)
    for c in column_chunks(rows):
        out[:, c] = push(peff, rows[:, c]).to(t.dtype)
    return out.reshape(t.shape)


class GossipPushSumStrategy(CommStrategy):
    """Stochastic-Gradient-Push gossip (arXiv 1811.10792) over a mixing
    topology (:mod:`repro_torch.core.topology`). Each worker carries a push
    weight w_i (``vars.extra = (w, t)``, t the phase counter):

        launch:  mix_i = Σ_j P[i,j]·w_j·x_j,   w'_i = Σ_j P[i,j]·w_j
        apply:   z_i = mix_i / w'_i,           x_i ← (1 − α)·x_i + α·z_i   (K5)

    Per bucket the boundary is one launch of K5's gossip form
    (:func:`~repro_torch.kernels.anchor_mix.ops.gossip_boundary_`): it
    debiases the consumed mix, pulls x toward it on the rows that move, and
    writes the next mix ``Peff @ x`` (Peff = P̃_t·diag(w), f32) into the same
    buffer, x and the mix in place. ``membership`` composes into P̃
    (:func:`~repro_torch.core.topology.compose_membership`: dead rows and
    columns zeroed, live columns renormalised). A row that is dead, or that
    received no push mass (it was dead when the consumed mix was launched),
    takes the identity. The (m,)-sized work (which rows move, the weights,
    Peff) stays on the device: the boundary reads nothing back to the host.
    The ``full`` topology takes Overlap-Local-SGD's exact K4 path with β = 0.

    Per leaf the debias, the pullback (the same-shape K5 on each leaf, the
    rows that stay restored) and the push (:func:`_push`, new mix trees) are
    separate ops, with the fused kernel's values."""

    name = "gossip_pushsum"
    topology: Optional[str] = None  # subclasses pin it; None defers to cfg.topology

    def __init__(self, cfg: AlgoConfig):
        super().__init__(cfg)
        self.topo_name = self.topology or cfg.topology or "full"
        self.full = self.topo_name == "full"
        self._mats = {}  # (m, device) -> the topology's (L, m, m) matrices on that device

    rank_capable = True

    @property
    def shards_anchor(self) -> bool:
        return self.full  # gossip_full is Overlap-Local-SGD with beta 0

    def init_vars(self, x) -> AlgoVars:
        first = tensors_of(x)[0]
        mesh = sharding.current_mesh()
        m = first.shape[0] * (1 if mesh is None else mesh.size)  # the push weights of all m workers
        w = torch.ones((m,), dtype=torch.float32, device=first.device)
        return AlgoVars(extra=(w, torch.zeros((), dtype=torch.int32, device=first.device)))

    def init_inflight(self, x, vars: AlgoVars):
        if self.full:
            return _init_anchor(self, x) if self.packed else _first_row(x)
        # w' = 1: round 0's debias divides by exactly 1.0
        mix = _copy_plane(_as_plane(x)) if self.packed else _clone(x)
        if sharding.current_mesh() is None:
            return GossipInflight(mix=mix, w=torch.ones_like(vars.extra[0]))
        out = DrainedGossipInflight(mix=mix, w=torch.ones_like(vars.extra[0]))  # the rank's rows of the mix
        out.phase = 0
        return out

    def _push_matrix(self, m: int, t: torch.Tensor, w: torch.Tensor, membership=None) -> torch.Tensor:
        """Round t's P̃_t · diag(w), (m, m) f32, chosen on the device; P̃ is
        composed with the membership's mask when there is one."""
        key = (m, w.device)
        if key not in self._mats:
            self._mats[key] = torch.as_tensor(cached_topology(self.topo_name, m).mats, device=w.device)
        mats = self._mats[key]
        P = mats[0] if len(mats) == 1 else torch.index_select(mats, 0, (t % len(mats)).reshape(1))[0]
        if membership is not None:
            P = compose_membership(P, membership.mask)
        return P * w[None, :]

    @staticmethod
    def _tick(vars: AlgoVars, w) -> AlgoVars:
        return AlgoVars(z=vars.z, v=vars.v, extra=(w, vars.extra[1] + 1))

    def boundary_apply(self, x, vars: AlgoVars, inflight, membership=None):
        alpha = self.cfg.alpha
        inflight = _arrived(inflight, vars)  # on a worker mesh: the exchange waited on, the rows' mix formed
        if self.full:
            return _pullback(x, inflight, alpha, membership), vars
        w, t = vars.extra
        mesh = sharding.current_mesh()
        lo, hi = (0, w.shape[0]) if mesh is None else mesh.rows(w.shape[0])  # the rank's rows of the (m,) vectors
        wmix = inflight.w
        # a row that received no push mass (dead when this collective
        # launched, rejoining now) keeps x: nothing arrived to debias
        moves = wmix > 0
        if membership is not None:
            moves = moves & (membership.mask > 0)
        wsafe = torch.where(wmix > 0, wmix, torch.ones_like(wmix))

        def debias(mix):  # the rank's rows of the mix
            return (mix.float() / wsafe[lo:hi].reshape((-1,) + (1,) * (mix.dim() - 1))).to(mix.dtype)

        old = _clone(x)
        anchor_ops.pullback_tree(x, tree_map(debias, inflight.mix), alpha)
        _live_where_(moves.to(torch.float32)[lo:hi], x, old)
        return x, AlgoVars(z=vars.z, v=vars.v, extra=(torch.where(moves, wmix, w), t))

    def boundary_launch(self, x, vars: AlgoVars, membership=None):
        w, t = vars.extra
        mesh = sharding.current_mesh()
        if self.full:
            return _launch_leaves(x, self._tick(vars, w), membership)
        Peff = self._push_matrix(_leading(x), t, w, membership)
        if mesh is not None:
            # every leaf's launch-time rows in one flat buffer a dtype, sent to the
            # peers the phase's push reads them from (the phase: one read of t)
            own, phase = pack(x, lead=1), int(t)
            peers = cached_rank_peers(self.topo_name, _leading(x), mesh.size, phase)[mesh.rank]
            out = RankGossipInflight(own, sharding.exchange_rows(own.buffers, peers, mesh), peers, Peff,
                                     torch.sum(Peff, dim=1), phase, leaves=True)
            return self._tick(vars, w), out
        mix = tree_map(lambda leaf: _push(Peff, leaf), x)
        return self._tick(vars, w), GossipInflight(mix=mix, w=torch.sum(Peff, dim=1))

    def _packed_boundary(self, px: Packed, vars: AlgoVars, inflight, probe: bool = False, membership=None):
        alpha = self.cfg.alpha
        w, t = vars.extra
        m = px.lead_shape[0]
        if self.full:
            outs = _pullback_mean(px, inflight, alpha, probe=probe, weights=_mem_weights(membership))
            out = (px, self._tick(vars, w), Packed(tuple(o[1] for o in outs), inflight.layout))
            return _with_stats(out, _fused_stats(outs, m, probe))
        # the push does not read through K3/K4: the standalone probe
        stats = packed_probe(px) if probe else None
        wmix = inflight.w
        got = wmix > 0
        moves = got if membership is None else got & (membership.mask > 0)
        wsafe = torch.where(got, wmix, torch.ones_like(wmix))
        w_new = torch.where(moves, wmix, w)
        Peff = self._push_matrix(m, t, w_new, membership)
        live = moves.to(torch.float32)
        for bx, bm in zip(px.buffers, inflight.mix.buffers):
            anchor_ops.gossip_boundary_(bx, bm, wsafe, live, Peff, alpha)
        vars = AlgoVars(z=vars.z, v=vars.v, extra=(w_new, t + 1))
        return _with_stats((px, vars, GossipInflight(mix=inflight.mix, w=torch.sum(Peff, dim=1))), stats)

    def _rank_boundary(self, px: Packed, vars: AlgoVars, inflight, mesh, probe: bool = False, membership=None):
        """``full``: Overlap-Local-SGD's rank boundary with β = 0 (K4's rank
        form and the async all-reduce). Else wait on the exchange the last
        boundary launched and, per bucket in one launch of K5's gossip rank
        form, form each own row's mix from the held launch-time rows with
        that launch's Peff (the first boundary and the one after a drain:
        the finished mix in ``inflight``), debias it, pull the live rows
        toward it and write their new launch-time copy; then launch the next
        exchange, of phase t (its schedule chosen on the host from the
        mirror of t the in-flight value carries). Peff, the weights and t
        stay (m,)-sized and replicated: no n-wide collective. With
        ``probe`` the pre-boundary stats come first."""
        w, t = vars.extra
        if self.full:
            _, out, stats = _rank_anchor_boundary(px, inflight, mesh, self.cfg.alpha, None, None, probe, membership)
            return _with_stats((px, self._tick(vars, w), out), stats)
        stats = rank_probe(px, mesh) if probe else None
        m = px.lead_shape[0] * mesh.size
        lo, hi = mesh.rows(m)
        if isinstance(inflight, RankGossipInflight) and inflight.done is not None:
            inflight = inflight.done  # drained through another reference to this state
        if isinstance(inflight, RankGossipInflight):
            recv, own, peff_prev, mode = inflight.exchange.wait(), inflight.own, inflight.peff, 0
            held, received, phase = inflight.peers.held, inflight.peers.received, inflight.phase + 1
            inflight.consumed = True
        else:  # the finished mix of the rank's rows
            own, peff_prev, mode, recv, held, received = inflight.mix, None, 1, (), tuple(range(lo, hi)), ()
            phase = getattr(inflight, "phase", None)
            phase = int(t) if phase is None else phase  # a restored state: one read of the counter
        wmix = inflight.w
        got = wmix > 0
        moves = got if membership is None else got & (membership.mask > 0)
        wsafe = torch.where(got, wmix, torch.ones_like(wmix))
        w_new = torch.where(moves, wmix, w)
        Peff = self._push_matrix(m, t, w_new, membership)
        live = moves.to(torch.float32)
        for b, (bx, bo) in enumerate(zip(px.buffers, own.buffers)):
            anchor_ops.gossip_rank_(bx, bo, recv[b] if received else None, held, received, lo,
                                    Peff if peff_prev is None else peff_prev, wsafe[lo:hi], live[lo:hi],
                                    self.cfg.alpha, mode)
        peers = cached_rank_peers(self.topo_name, m, mesh.size, phase)[mesh.rank]
        exchange = sharding.exchange_rows(own.buffers, peers, mesh)
        vars = AlgoVars(z=vars.z, v=vars.v, extra=(w_new, t + 1))
        out = RankGossipInflight(own, exchange, peers, Peff, torch.sum(Peff, dim=1), phase)
        return _with_stats((px, vars, out), stats)


class GossipFullStrategy(GossipPushSumStrategy):
    """Fully connected gossip: Overlap-Local-SGD with β = 0, bit for bit."""

    name = "gossip_full"
    topology = "full"


class GossipRingStrategy(GossipPushSumStrategy):
    """Static ring gossip: each worker averages with its two ring neighbours."""

    name = "gossip_ring"
    topology = "ring"


class GossipExpStrategy(GossipPushSumStrategy):
    """One-peer exponential gossip: ⌈log2 m⌉ phases cycled."""

    name = "gossip_exp"
    topology = "exp"


class LegacyStrategy(CommStrategy):
    """Runs a legacy single-hook ``Algorithm``
    (:mod:`repro_torch.core.algorithms`) under the two-phase protocol: its
    whole ``boundary`` runs in the apply phase (blocking), nothing is
    launched, on the per-leaf path."""

    def __init__(self, algorithm):
        self.algorithm = algorithm
        self.cfg = algorithm.cfg
        self.tau = algorithm.tau
        self.name = algorithm.name
        self.needs_anchor = algorithm.needs_anchor
        self.packed = False  # legacy semantics are the per-leaf reference
        # the shipped shims reduce through the mesh-aware worker mean
        self.rank_capable = getattr(algorithm, "rank_capable", False)

    def init_vars(self, x) -> AlgoVars:
        return self.algorithm.init_vars(x)

    def transform_grads(self, grads, vars):
        return self.algorithm.transform_grads(grads, vars)

    def boundary_apply(self, x, vars, inflight, membership=None):
        if membership is not None:
            raise ValueError("legacy algorithms predate the membership contract; run fault plans against a "
                             "native strategy")
        return self.algorithm.boundary(x, vars)

    def metrics(self, x, vars):
        return self.algorithm.metrics(x, vars)


def as_strategy(algorithm_or_strategy) -> CommStrategy:
    """A strategy as it is; a legacy ``Algorithm`` wrapped in
    :class:`LegacyStrategy`."""
    if isinstance(algorithm_or_strategy, CommStrategy):
        return algorithm_or_strategy
    from repro_torch.core.algorithms import Algorithm

    if isinstance(algorithm_or_strategy, Algorithm):
        return LegacyStrategy(algorithm_or_strategy)
    raise TypeError(f"expected a CommStrategy or Algorithm, got {type(algorithm_or_strategy).__name__}")


STRATEGIES = {
    "overlap_local_sgd": OverlapLocalSGDStrategy,
    "local_sgd": LocalSGDStrategy,
    "sync_sgd": SyncSGDStrategy,
    "easgd": EASGDStrategy,
    "cocod": CoCoDStrategy,
    "powersgd": PowerSGDStrategy,
    "delayed_avg": DelayedAveragingStrategy,
    "sparse_anchor": SparseAnchorStrategy,
    "gossip_pushsum": GossipPushSumStrategy,
    "gossip_full": GossipFullStrategy,
    "gossip_ring": GossipRingStrategy,
    "gossip_exp": GossipExpStrategy,
}

_ALIASES = {
    "dasgd": "delayed_avg",
    "loscar": "sparse_anchor",
    "overlap": "overlap_local_sgd",
    "sgp": "gossip_pushsum",
}


def make_strategy(cfg: AlgoConfig) -> CommStrategy:
    name = _ALIASES.get(cfg.name, cfg.name)
    if name not in STRATEGIES:
        raise ValueError(f"unknown strategy {cfg.name!r}; known: {sorted(STRATEGIES) + sorted(_ALIASES)}")
    return STRATEGIES[name](cfg)


def resolve_strategy(strategy) -> CommStrategy:
    """A name → ``AlgoConfig`` with library defaults → :func:`make_strategy`;
    an ``AlgoConfig`` → :func:`make_strategy`; a strategy passes through and
    a legacy ``Algorithm`` is wrapped (:func:`as_strategy`)."""
    if isinstance(strategy, str):
        strategy = AlgoConfig(name=strategy)
    if isinstance(strategy, AlgoConfig):
        return make_strategy(strategy)
    try:
        return as_strategy(strategy)
    except TypeError:
        raise TypeError(f"expected a strategy name, AlgoConfig, CommStrategy or Algorithm, got "
                        f"{type(strategy).__name__}") from None
