"""Two-phase communication strategies over the packed plane (counterpart of
``repro.core.strategy``, the packed path of the strategies the classifier
slice runs).

The paper's structure: the anchor collective launched at one round
boundary is consumed τ local steps later. The round engine calls one hook a
round, :meth:`CommStrategy.boundary_round`, which consumes the in-flight
anchor launched at the previous boundary (eq. 4) and launches this round's
(eq. 5); the launched value rides in ``TrainState.inflight``.

On one card the m workers are stacked in one ``(m, n)`` plane per dtype,
so the worker-mean "collective" is the reduction over the worker axis
inside the fused boundary kernel (K3 with anchor momentum, K4 without).

The boundary updates x (and the anchor momentum v) **in place** and returns
them; the new anchor is a new buffer, so the consumed anchor stays intact
as ``vars.z``, as in the reference. Only the packed path is here: the
per-leaf oracle (``packed=False``), host offload and the membership-masked
(fault) boundary of the strategies raise, as do the other strategies.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.config.base import AlgoConfig
from repro_torch.kernels.anchor_mix import ops as anchor_ops
from repro_torch.parallel.packing import Packed, buffer_map, packed_like


class AlgoVars(NamedTuple):
    """Strategy-owned state slots (unused slots are None)."""

    z: Any = None  # the anchor consumed at the last boundary (anchor-momentum variant)
    v: Any = None  # anchor momentum
    extra: Any = None


def _packed_worker_mean(p: Packed) -> Packed:
    """One f32 worker mean per bucket, cast back to the bucket dtype."""
    return buffer_map(lambda b: torch.mean(b, dim=0, dtype=torch.float32).to(b.dtype), p)


def _pack_anchor(px: Packed) -> Packed:
    """A copy of worker 0's row of every bucket (all workers start equal)."""
    return Packed(tuple(b[0].clone() for b in px.buffers), px.layout)


def _plain_boundary(probe: bool, membership) -> None:
    """The port's boundaries run neither the consensus probe nor a
    membership mask yet."""
    if probe:
        raise NotImplementedError("the consensus probe (adaptive tau) is ROADMAP Queue 1 item 5")
    if membership is not None:
        raise NotImplementedError("membership-masked boundaries (faults) are ROADMAP Queue 1 item 6")


class CommStrategy:
    """Base strategy: Local SGD without averaging (every hook a no-op)."""

    name = "base"

    def __init__(self, cfg: AlgoConfig):
        if not cfg.packed:
            raise NotImplementedError(
                "the per-leaf oracle path (AlgoConfig.packed=False) is ROADMAP Queue 1 item 4"
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

    def boundary_round(self, px: Packed, vars: AlgoVars, inflight, probe: bool = False, membership=None):
        """One round boundary: consume ``inflight`` (eq. 4), launch the next
        anchor (eq. 5). Returns ``(px, vars, inflight)``."""
        _plain_boundary(probe, membership)
        return px, vars, None


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
        _plain_boundary(probe, membership)
        for b, avg in zip(px.buffers, _packed_worker_mean(px).buffers):
            b.copy_(avg.expand_as(b))
        return px, vars, None


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
        _plain_boundary(probe, membership)
        alpha = self.cfg.alpha
        if self.momentum:
            beta = self.cfg.anchor_beta
            z_next = tuple(
                anchor_ops.pullback_mean_momentum(bx, bz, bv, alpha, beta)[1]
                for bx, bz, bv in zip(px.buffers, inflight.buffers, vars.v.buffers)
            )
            # the consumed anchor becomes vars.z; v was updated in place
            vars = AlgoVars(z=inflight, v=vars.v, extra=vars.extra)
        else:
            z_next = tuple(anchor_ops.pullback_mean(bx, bz, alpha)[1] for bx, bz in zip(px.buffers, inflight.buffers))
        return px, vars, Packed(z_next, inflight.layout)


STRATEGIES = {
    "overlap_local_sgd": OverlapLocalSGDStrategy,
    "local_sgd": LocalSGDStrategy,
    "sync_sgd": SyncSGDStrategy,
}

# the reference's other strategies and aliases, not ported yet
_LATER = ("easgd", "cocod", "powersgd", "delayed_avg", "sparse_anchor", "gossip_pushsum", "gossip_full",
          "gossip_ring", "gossip_exp", "dasgd", "loscar", "sgp")
_ALIASES = {"overlap": "overlap_local_sgd"}


def make_strategy(cfg: AlgoConfig) -> CommStrategy:
    name = _ALIASES.get(cfg.name, cfg.name)
    if name in _LATER:
        raise NotImplementedError(f"strategy {cfg.name!r} is ROADMAP Queue 1 item 4 (the remaining strategies)")
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
