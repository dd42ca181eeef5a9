"""Two-phase communication strategies over the packed plane (counterpart of
the packed path of ``repro.core.strategy``: every strategy and alias of
the reference).

The paper's structure: the anchor collective launched at one round
boundary is consumed τ local steps later. The round engine calls one hook a
round, :meth:`CommStrategy.boundary_round`, which consumes the in-flight
collective launched at the previous boundary (eq. 4) and launches this
round's (eq. 5); the launched value rides in ``TrainState.inflight``.
Delayed averaging consumes it mid-round instead, through
:meth:`CommStrategy.local_post_update_packed`, which the engine calls after
every optimizer step; PowerSGD and sync-SGD act on the gradient plane
through :meth:`CommStrategy.transform_grads_packed`.

On one card the m workers are stacked in one ``(m, n)`` plane per dtype,
so the worker-mean "collective" is a reduction over the worker axis (inside
the fused boundary kernel K3/K4 where there is one) and a gossip push is an
(m, m)·(m, n) product.

Boundaries update x (and the anchor momentum v) **in place**. The reference
is pure, so it may hand the plane itself over as the in-flight value
(the gossip mix, the rebase strategies' x₀); here x is written in place, so
every in-flight plane has a buffer of its own, reused round after round.
Full-plane f32 temporaries are avoided: expressions over a whole plane run
over column chunks (:func:`_column_chunks`) or as one mixed-dtype in-place
op, with the values of the reference's expressions.

``boundary_round(..., probe=True)`` also returns the consensus stats of the
*pre-boundary* plane for the adaptive-τ controller: fused into K3/K4 (no
extra launch) where the boundary runs them (overlap, easgd, sparse_anchor,
gossip_full), else one standalone K8 launch a bucket. ``membership`` (a
:class:`~repro_torch.fault.Membership`) masks the boundary to the live
workers: dead rows pass through, worker means are the renormalised weighted
sums; the probe still covers all m rows. ``None`` is the fully-live path.

Not here (each raises, naming its ROADMAP item): the per-leaf oracle
(``packed=False``, item 4b) and host offload (item 9).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.config.base import AlgoConfig
from repro_torch.core import powersgd
from repro_torch.core.topology import cached_topology, compose_membership
from repro_torch.kernels.anchor_mix import ops as anchor_ops
from repro_torch.kernels.consensus_probe import packed_probe, stats_from_partials
from repro_torch.kernels.opt_step.ref import weak
from repro_torch.parallel.packing import Packed, buffer_map, leaf_segments, packed_like

# columns a chunk of a plane-wide expression takes, per worker row: its f32
# temporaries stay near 2^26 elements (256 MB) whatever the plane's size
_CHUNK_ELEMS = 1 << 26


class AlgoVars(NamedTuple):
    """Strategy-owned state slots (unused slots are None)."""

    z: Any = None  # anchor (easgd, sparse_anchor; overlap's consumed anchor with momentum)
    v: Any = None  # anchor momentum
    extra: Any = None  # gossip (w, t) / sparse error plane / PowerState


def _mem_weights(membership):
    """The (m,) f32 weights of a membership, or None (fully live)."""
    return None if membership is None else membership.weights


def _packed_worker_mean(p: Packed, weights=None) -> Packed:
    """One f32 worker mean per bucket, cast back to the bucket dtype; with
    ``weights`` the weighted sum Σ_i w_i·x_i (over column chunks)."""
    if weights is None:
        return buffer_map(lambda b: torch.mean(b, dim=0, dtype=torch.float32).to(b.dtype), p)
    wf = weights.float()[:, None]

    def weighted(b):
        out = torch.empty(b.shape[1], dtype=b.dtype, device=b.device)
        for c in _column_chunks(b):
            out[c] = torch.sum(b[:, c].float() * wf, dim=0).to(b.dtype)
        return out

    return buffer_map(weighted, p)


def _with_stats(out: tuple, stats) -> tuple:
    """A boundary's result, with the probe's stats appended when probed."""
    return out if stats is None else out + (stats,)


def _fused_stats(outs, m: int, probe: bool):
    """The stats K3/K4 emitted with ``probe=True`` (each output's last)."""
    return stats_from_partials([o[-1] for o in outs], m) if probe else None


def _pack_anchor(px: Packed) -> Packed:
    """A copy of worker 0's row of every bucket (all workers start equal)."""
    return Packed(tuple(b[0].clone() for b in px.buffers), px.layout)


def _copy_plane(px: Packed) -> Packed:
    return Packed(tuple(b.clone() for b in px.buffers), px.layout)


def _column_chunks(b: torch.Tensor):
    """Column slices of an (m, n) buffer, each at most ``_CHUNK_ELEMS``
    elements in all."""
    m, n = b.shape
    step = max(1, _CHUNK_ELEMS // max(m, 1))
    for c0 in range(0, n, step):
        yield slice(c0, min(n, c0 + step))


class CommStrategy:
    """Base strategy: Local SGD without averaging (every hook a no-op)."""

    name = "base"

    def __init__(self, cfg: AlgoConfig):
        if not cfg.packed:
            raise NotImplementedError(
                "the per-leaf oracle path (AlgoConfig.packed=False) is ROADMAP Queue 1 item 4b"
            )
        if cfg.offload:
            raise NotImplementedError("host offload (AlgoConfig.offload) is ROADMAP Queue 1 item 9")
        self.cfg = cfg
        self.tau = cfg.tau

    def init_vars(self, px: Packed) -> AlgoVars:
        return AlgoVars()

    def init_inflight(self, px: Packed, vars: AlgoVars):
        """The carried collective round 0's boundary consumes."""
        return None

    def transform_grads_packed(self, pg: Packed, vars: AlgoVars):
        """Gradient-space hook on the worker-stacked gradient plane."""
        return pg, vars

    def local_post_update_packed(self, px: Packed, vars: AlgoVars, inflight, k_in_round: int) -> Packed:
        """Mid-round consumption point, after the optimizer update of local
        step ``k_in_round`` (0-based)."""
        return px

    def boundary_round(self, px: Packed, vars: AlgoVars, inflight, probe: bool = False, membership=None):
        """One round boundary: consume ``inflight`` (eq. 4), launch the next
        collective (eq. 5). Returns ``(px, vars, inflight)``, with ``probe``
        also the pre-boundary plane's
        :class:`~repro_torch.kernels.consensus_probe.ConsensusStats`.
        ``membership`` masks the boundary; with no boundary math (base,
        sync_sgd, powersgd) the plane passes through."""
        return _with_stats((px, vars, None), packed_probe(px) if probe else None)


class SyncSGDStrategy(CommStrategy):
    """Fully synchronous SGD: the gradient mean every local step (τ = 1)."""

    name = "sync_sgd"

    def __init__(self, cfg: AlgoConfig):
        super().__init__(cfg)
        self.tau = 1

    def transform_grads_packed(self, pg: Packed, vars):
        """One worker mean per bucket, written back to every worker's row."""
        for b, g in zip(pg.buffers, _packed_worker_mean(pg).buffers):
            b.copy_(g.expand_as(b))
        return pg, vars


class LocalSGDStrategy(CommStrategy):
    """Periodic model averaging, eq. (2); blocking: nothing is launched."""

    name = "local_sgd"

    def boundary_round(self, px: Packed, vars, inflight, probe: bool = False, membership=None):
        # the probe reads the pre-average plane: after the average the drift is 0
        stats = packed_probe(px) if probe else None
        for b, avg in zip(px.buffers, _packed_worker_mean(px, _mem_weights(membership)).buffers):
            if membership is None:
                b.copy_(avg.expand_as(b))
            else:  # dead rows keep their stale parameters (they re-sync on rejoin); in place
                torch.where((membership.mask > 0)[:, None], avg[None], b, out=b)
        return _with_stats((px, vars, None), stats)


class OverlapLocalSGDStrategy(CommStrategy):
    """The paper's algorithm (+ anchor momentum when ``anchor_beta`` > 0).

    Per bucket one fused kernel: the pullback toward the anchor launched a
    round ago (eq. 4), the worker mean of the pulled-back plane (eq. 5) and,
    with momentum, v ← β·v + (mean − z), z ← z + v (eqs. 10–11)."""

    name = "overlap_local_sgd"

    def __init__(self, cfg: AlgoConfig):
        super().__init__(cfg)
        self.momentum = cfg.anchor_beta > 0

    def init_vars(self, px: Packed) -> AlgoVars:
        if not self.momentum:
            return AlgoVars()
        z = _pack_anchor(px)
        return AlgoVars(z=z, v=packed_like(z, 0.0))

    def init_inflight(self, px: Packed, vars):
        return _pack_anchor(px)

    def boundary_round(self, px: Packed, vars: AlgoVars, inflight, probe: bool = False, membership=None):
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


def _pullback_mean(px: Packed, z: Packed, alpha: float, mean_pre: bool = False, probe: bool = False, weights=None):
    """K4 per bucket: x pulled back in place; returns each bucket's outputs
    (x, mean[, stats])."""
    return [anchor_ops.pullback_mean(bx, bz, alpha, mean_pre=mean_pre, probe=probe, weights=weights)
            for bx, bz in zip(px.buffers, z.buffers)]


class EASGDStrategy(CommStrategy):
    """Elastic-averaging SGD [19], blocking: per bucket K4 pulls x toward z
    and takes the mean of the *pre*-pullback plane (``mean_pre``, the
    symmetric mix), then z ← (1 − r)·z + r·mean with r = min(α·m, 1), in
    the plane's dtype (the reference's ``tree_lerp`` at native dtype). Masked,
    r = min(α·m_live, 1) is a device tensor and the lerp runs in f32, as the
    reference's traced rate makes it."""

    name = "easgd"

    def init_vars(self, px: Packed) -> AlgoVars:
        return AlgoVars(z=_pack_anchor(px))

    def boundary_round(self, px: Packed, vars: AlgoVars, inflight, probe: bool = False, membership=None):
        alpha = self.cfg.alpha
        outs = _pullback_mean(px, vars.z, alpha, mean_pre=True, probe=probe, weights=_mem_weights(membership))
        if membership is None:
            rate = min(alpha * px.lead_shape[0], 1.0)
            for bz, o in zip(vars.z.buffers, outs):
                # (1 - r)·z + r·mean, each product and the sum rounded to z's
                # dtype; the constants are rounded to it first (JAX weak types)
                bz.mul_(weak(1.0 - rate, bz.dtype)).add_(o[1].mul_(weak(rate, bz.dtype)))
        else:
            rate = torch.clamp(alpha * membership.live_count(), max=1.0)
            for bz, o in zip(vars.z.buffers, outs):
                bz.copy_(((1.0 - rate) * bz.float() + rate * o[1].float()).to(bz.dtype))
        return _with_stats((px, vars, None), _fused_stats(outs, px.lead_shape[0], probe))


class _AvgRebaseStrategy(CommStrategy):
    """Strategies whose launched collective is the worker mean of the
    round's models plus each worker's launch-time copy, and whose
    consumption re-bases x_i ← avg(x₀) + (x_i − x₀ᵢ)."""

    class Inflight(NamedTuple):
        avg: Any  # mean of the launch-time models (the overlapped collective)
        x0: Any  # the launch-time plane, a buffer of its own

    def init_inflight(self, px: Packed, vars):
        return self.Inflight(avg=_packed_worker_mean(px), x0=_copy_plane(px))

    @staticmethod
    def _rebase_packed(px: Packed, inflight, membership=None) -> Packed:
        """x_i ← (avg + x_i) − x₀ᵢ in f32, cast to x's dtype, in place, over
        column chunks; with ``membership`` only the live rows."""
        for bx, b0, av in zip(px.buffers, inflight.x0.buffers, inflight.avg.buffers):
            for c in _column_chunks(bx):
                new = (av[None, c].float() + bx[:, c].float() - b0[:, c].float()).to(bx.dtype)
                if membership is not None:
                    new = torch.where((membership.mask > 0)[:, None], new, bx[:, c])
                bx[:, c] = new
        return px

    def _packed_launch(self, px: Packed, inflight, weights=None):
        """The next collective from the plane: the (weighted) worker mean, and
        x₀ copied into the consumed in-flight plane's buffer."""
        for b0, bx in zip(inflight.x0.buffers, px.buffers):
            b0.copy_(bx)
        return self.Inflight(avg=_packed_worker_mean(px, weights), x0=inflight.x0)


class CoCoDStrategy(_AvgRebaseStrategy):
    """CoCoD-SGD [20]: the boundary re-bases every worker onto the average
    launched a round ago plus its local delta, then launches the average of
    the re-based models. :class:`DelayedAveragingStrategy` with the delay
    pinned to τ."""

    name = "cocod"

    def boundary_round(self, px: Packed, vars, inflight, probe: bool = False, membership=None):
        # the rebase reads no pullback kernel: the standalone probe of the pre-rebase plane
        stats = packed_probe(px) if probe else None
        self._rebase_packed(px, inflight, membership)
        return _with_stats((px, vars, self._packed_launch(px, inflight, _mem_weights(membership))), stats)


class PowerSGDStrategy(CommStrategy):
    """PowerSGD [5]: rank-r gradient compression, synchronous (τ = 1); the
    compressed collectives live in the gradient hook
    (:mod:`repro_torch.core.powersgd`), the boundary is empty."""

    name = "powersgd"

    def __init__(self, cfg: AlgoConfig):
        super().__init__(cfg)
        self.tau = 1
        self.rank = cfg.powersgd_rank

    def init_vars(self, px: Packed) -> AlgoVars:
        return AlgoVars(extra=powersgd.init_state(px, self.rank))

    def transform_grads_packed(self, pg: Packed, vars: AlgoVars):
        pg, st = powersgd.transform_grads_packed(pg, vars.extra)
        return pg, AlgoVars(z=vars.z, v=vars.v, extra=st)


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

    def local_post_update_packed(self, px: Packed, vars, inflight, k_in_round: int) -> Packed:
        if self.delay < self.tau and k_in_round == self.delay - 1:
            self._rebase_packed(px, inflight)
        return px

    def boundary_round(self, px: Packed, vars, inflight, probe: bool = False, membership=None):
        # the mask covers the boundary's consumption only: the mid-round rebase
        # consumes a collective launched under the last round's membership
        stats = packed_probe(px) if probe else None
        if self.delay >= self.tau:
            self._rebase_packed(px, inflight, membership)
        return _with_stats((px, vars, self._packed_launch(px, inflight, _mem_weights(membership))), stats)


def _quantile_linear(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(a, q, method="linear")`` of a 1-D float32 tensor, in
    float32 as JAX computes it: position q·(n − 1) with q and n rounded to
    float32, the two neighbouring order statistics from a sort, and
    lo·(1 − h) + hi·h. (``torch.quantile`` refuses more than 2^24 elements.)"""
    n = a.numel()
    pos = np.float32(q) * (np.float32(n) - np.float32(1))
    low, high = np.floor(pos), np.ceil(pos)
    hw = pos - low
    lw = np.float32(1) - hw
    last = np.float32(n) - np.float32(1)
    low, high = int(min(max(low, 0), last)), int(min(max(high, 0), last))
    srt = torch.sort(a).values
    return srt[low] * float(lw) + srt[high] * float(hw)


def sparsify_topk_(delta: torch.Tensor, layout, bucket: int, k: float) -> torch.Tensor:
    """Per leaf of ``bucket``, the top-``k`` fraction of the f32 anchor delta
    by magnitude: an element is kept where |d| ≥ the (1 − k) linear quantile
    of the leaf's |d| (ties at the threshold are kept), else zeroed, in
    place. Leaves of ≤ 1 element are kept whole; padding lanes hold zeros
    and stay zero. Returns ``delta`` (now the sparse payload s)."""
    for slot in leaf_segments(layout, bucket):
        if slot.size <= 1:
            continue
        seg = delta[slot.offset : slot.offset + slot.size]
        mag = seg.abs()
        seg.masked_fill_(mag < _quantile_linear(mag, 1.0 - k), 0.0)
    return delta


class SparseAnchorStrategy(CommStrategy):
    """LOSCAR-style top-k sparse anchor averaging with error feedback:
    Overlap-Local-SGD (β = 0, K4 per bucket) whose launched anchor moves
    only by the top-``sparse_k`` part of Δ + e, Δ = mean(x) − z:

        s = top_k(Δ + e),  e' = (Δ + e) − s,  z' = z + s

    At ``sparse_k = 1`` it is exactly Overlap-Local-SGD with β = 0."""

    name = "sparse_anchor"

    def __init__(self, cfg: AlgoConfig):
        super().__init__(cfg)
        if not 0.0 < cfg.sparse_k <= 1.0:
            raise ValueError(f"sparse_k must be in (0, 1], got {cfg.sparse_k}")
        self.k = cfg.sparse_k

    def init_vars(self, px: Packed) -> AlgoVars:
        z = _pack_anchor(px)
        # f32 shadow of the anchor plane: the error feedback, element-aligned with z
        return AlgoVars(z=z, extra=packed_like(z, 0.0, dtype=torch.float32))

    def init_inflight(self, px: Packed, vars):
        return _pack_anchor(px)

    def boundary_round(self, px: Packed, vars: AlgoVars, inflight, probe: bool = False, membership=None):
        outs = _pullback_mean(px, inflight, self.cfg.alpha, probe=probe, weights=_mem_weights(membership))
        means = [o[1] for o in outs]
        if self.k >= 1.0:  # dense: z' = mean(x), nothing truncated
            z_next = means
        else:
            z_next = []
            for bi, (bm, bz, be) in enumerate(zip(means, inflight.buffers, vars.extra.buffers)):
                delta = bm.float() - bz.float() + be
                s = sparsify_topk_(delta.clone(), inflight.layout, bi, self.k)
                be.copy_(delta - s)
                z_next.append((bz.float() + s).to(bz.dtype))
        # the consumed anchor is the base of this round's launched delta
        out = (px, AlgoVars(z=inflight, v=vars.v, extra=vars.extra), Packed(tuple(z_next), inflight.layout))
        return _with_stats(out, _fused_stats(outs, px.lead_shape[0], probe))


class GossipInflight(NamedTuple):
    """A launched gossip push: the received neighbour-weighted sums (a
    worker-stacked plane of its own) and the (m,) f32 received push weights
    that debias them at the next boundary (z_i = mix_i / w_i)."""

    mix: Any
    w: Any


class GossipPushSumStrategy(CommStrategy):
    """Stochastic-Gradient-Push gossip (arXiv 1811.10792) over a mixing
    topology (:mod:`repro_torch.core.topology`). Each worker carries a push
    weight w_i (``vars.extra = (w, t)``, t the phase counter):

        launch:  mix_i = Σ_j P[i,j]·w_j·x_j,   w'_i = Σ_j P[i,j]·w_j
        apply:   z_i = mix_i / w'_i,           x_i ← (1 − α)·x_i + α·z_i   (K5)

    Per bucket the boundary debiases the consumed mix in place, runs K5,
    and writes the next mix ``Peff @ x`` (Peff = P̃_t·diag(w), f32) into the
    same buffer, column chunk by column chunk. ``membership`` composes into
    P̃ (:func:`~repro_torch.core.topology.compose_membership`: dead rows and
    columns zeroed, live columns renormalised). A row that is dead, or that
    received no push mass (it was dead when the consumed mix was launched),
    takes the identity: the boundary reads which rows those are on the host
    (one (m,) copy), keeps their rows of x aside and puts them back after
    K5. The ``full`` topology takes Overlap-Local-SGD's exact K4 path with
    β = 0."""

    name = "gossip_pushsum"
    topology: Optional[str] = None  # subclasses pin it; None defers to cfg.topology

    def __init__(self, cfg: AlgoConfig):
        super().__init__(cfg)
        self.topo_name = self.topology or cfg.topology or "full"
        self.full = self.topo_name == "full"
        self._mats = {}  # (m, device) -> the topology's (L, m, m) matrices on that device

    def init_vars(self, px: Packed) -> AlgoVars:
        dev = px.buffers[0].device
        w = torch.ones((px.lead_shape[0],), dtype=torch.float32, device=dev)
        return AlgoVars(extra=(w, torch.zeros((), dtype=torch.int32, device=dev)))

    def init_inflight(self, px: Packed, vars: AlgoVars):
        if self.full:
            return _pack_anchor(px)
        # w' = 1: round 0's debias divides by exactly 1.0
        return GossipInflight(mix=_copy_plane(px), w=torch.ones_like(vars.extra[0]))

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

    def boundary_round(self, px: Packed, vars: AlgoVars, inflight, probe: bool = False, membership=None):
        alpha = self.cfg.alpha
        w, t = vars.extra
        m = px.lead_shape[0]
        if self.full:
            outs = _pullback_mean(px, inflight, alpha, probe=probe, weights=_mem_weights(membership))
            out = (px, AlgoVars(z=vars.z, v=vars.v, extra=(w, t + 1)),
                   Packed(tuple(o[1] for o in outs), inflight.layout))
            return _with_stats(out, _fused_stats(outs, m, probe))
        # the push does not read through K3/K4: the standalone probe
        stats = packed_probe(px) if probe else None
        wmix = inflight.w
        got = wmix > 0
        moves = got if membership is None else got & (membership.mask > 0)
        held = np.nonzero(~moves.cpu().numpy())[0].tolist()  # rows that take the identity
        wb = torch.where(got, wmix, torch.ones_like(wmix))[:, None]
        w_new = torch.where(moves, wmix, w)
        Peff = self._push_matrix(m, t, w_new, membership)
        for bx, bm in zip(px.buffers, inflight.mix.buffers):
            bm.div_(wb)  # z = (mix_f32 / w').astype(dtype): one op computed in f32
            kept = bx[held] if len(held) else None  # a copy of those rows
            anchor_ops.anchor_mix(bx, bm, alpha)
            if kept is not None:
                bx[held] = kept
            for c in _column_chunks(bx):
                bm[:, c] = torch.matmul(Peff, bx[:, c].float())
        vars = AlgoVars(z=vars.z, v=vars.v, extra=(w_new, t + 1))
        return _with_stats((px, vars, GossipInflight(mix=inflight.mix, w=torch.sum(Peff, dim=1))), stats)


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
    an ``AlgoConfig`` → :func:`make_strategy`; a strategy passes through."""
    if isinstance(strategy, str):
        strategy = AlgoConfig(name=strategy)
    if isinstance(strategy, AlgoConfig):
        return make_strategy(strategy)
    if isinstance(strategy, CommStrategy):
        return strategy
    raise TypeError(f"expected a strategy name, AlgoConfig or CommStrategy, got {type(strategy).__name__}")
