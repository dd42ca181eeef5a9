"""Legacy single-hook distributed-optimization algorithms, a deprecated shim
(counterpart of ``repro.core.algorithms``).

New code uses the two-phase :class:`repro_torch.core.strategy.CommStrategy`
protocol, where the round boundary is split into ``boundary_apply`` (consume
the collective launched last round, eq. 4) and ``boundary_launch`` (start
this round's, eq. 5). Here the overlap is only implicit in the order of the
statements inside ``boundary``. The classes are the seed's semantics on the
per-leaf path: the round engine wraps them in
:class:`~repro_torch.core.strategy.LegacyStrategy` (all their work in the
apply phase, nothing launched), and the tests hold the native per-leaf
strategies against them. On a worker mesh the shipped shims
(``rank_capable``) run on the rank's rows: their worker means are
:func:`~repro_torch.core.strategy._worker_mean`'s blocking all-reduce over
the ranks, and EASGD's rate takes the m of all ranks.

State layout: x is a nested dict of worker-stacked leaves ``(m, ...)``; the
anchor z (and its momentum v) are unstacked. x is updated in place (the
pullback is K5's row form, one launch a leaf), as on the native path.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.config.base import AlgoConfig
from repro_torch.core.strategy import (
    AlgoVars,
    CommStrategy,
    _clone,
    _first_row,
    _leading,
    _momentum_,
    _pullback,
    _rebase_rows_,
    _worker_mean,
)
from repro_torch.parallel.packing import tree_flatten
from repro_torch.utils.tree import tree_lerp, tree_map


class Algorithm:
    """Base: plain Local SGD, every hook a no-op. Deprecated: subclass
    :class:`repro_torch.core.strategy.CommStrategy` instead."""

    name = "base"
    needs_anchor = False
    # reduces only through the mesh-aware worker mean: runs on a worker mesh
    rank_capable = False

    def __init__(self, cfg: AlgoConfig):
        self.cfg = cfg
        self.tau = cfg.tau

    def init_vars(self, x_stacked) -> AlgoVars:
        return AlgoVars()

    def transform_grads(self, grads_stacked, vars: AlgoVars):
        return grads_stacked, vars

    def boundary(self, x_stacked, vars: AlgoVars):
        return x_stacked, vars

    def metrics(self, x_stacked, vars: AlgoVars) -> dict:
        return CommStrategy.metrics(self, x_stacked, vars)


class SyncSGD(Algorithm):
    """Fully synchronous SGD: gradients averaged across workers every step."""

    name = "sync_sgd"
    rank_capable = True

    def __init__(self, cfg: AlgoConfig):
        super().__init__(cfg)
        self.tau = 1

    def transform_grads(self, grads_stacked, vars):
        for g, avg in zip(tree_flatten(grads_stacked)[0], tree_flatten(_worker_mean(grads_stacked))[0]):
            g.copy_(avg.expand_as(g))
        return grads_stacked, vars


class LocalSGD(Algorithm):
    """Periodic model averaging (blocking), eq. (2) of the paper."""

    name = "local_sgd"
    rank_capable = True

    def boundary(self, x_stacked, vars):
        for t, avg in zip(tree_flatten(x_stacked)[0], tree_flatten(_worker_mean(x_stacked))[0]):
            t.copy_(avg.expand_as(t))
        return x_stacked, vars


class OverlapLocalSGD(Algorithm):
    """The paper's algorithm (+ momentum variant when anchor_beta > 0):
    (1) pull back toward the anchor of the PREVIOUS boundary (eq. 4);
    (2) the new anchor is the worker mean of the pulled-back models (eq. 5),
    with momentum v ← β·v + (mean − z), z ← z + v (eqs. 10–11); its first
    consumer is the next round's pullback."""

    name = "overlap_local_sgd"
    rank_capable = True
    needs_anchor = True

    def init_vars(self, x_stacked) -> AlgoVars:
        z = _first_row(x_stacked)  # all workers start equal
        v = tree_map(torch.zeros_like, z) if self.cfg.anchor_beta > 0 else None
        return AlgoVars(z=z, v=v)

    def boundary(self, x_stacked, vars: AlgoVars):
        z_stale = vars.z
        _pullback(x_stacked, z_stale, self.cfg.alpha)
        mean_x = _worker_mean(x_stacked)
        if vars.v is not None:
            beta = self.cfg.anchor_beta
            z_new = tree_map(lambda v, m, z: _momentum_(v, m, z, beta), vars.v, mean_x, z_stale)
        else:
            z_new = mean_x
        return x_stacked, AlgoVars(z=z_new, v=vars.v, extra=vars.extra)


class EASGD(Algorithm):
    """Elastic-averaging SGD [19]: symmetric mixing between the local models
    and the anchor, z moved at rate min(α·m, 1) toward the mean of the
    pre-pullback models; blocking."""

    name = "easgd"
    rank_capable = True
    needs_anchor = True

    def init_vars(self, x_stacked) -> AlgoVars:
        return AlgoVars(z=_first_row(x_stacked))

    def boundary(self, x_stacked, vars: AlgoVars):
        alpha = self.cfg.alpha
        rate = min(alpha * _leading(x_stacked), 1.0)
        mean_x = _worker_mean(x_stacked)  # pre-pullback models (symmetric W)
        _pullback(x_stacked, vars.z, alpha)
        return x_stacked, AlgoVars(z=tree_lerp(vars.z, mean_x, rate), v=None, extra=vars.extra)


class RoundStartVars(AlgoVars):
    """Legacy CoCoD's vars: ``extra`` the worker-stacked x at the start of
    the current round (on a worker mesh the rank's rows)."""

    ROWS = ("extra",)


class CoCoDSGD(Algorithm):
    """CoCoD-SGD [20]: at each boundary the average of the round's
    *starting* models (``vars.extra``) re-bases every worker,
    x_i ← avg(x_start) + (x_i − x_start_i)."""

    name = "cocod"
    rank_capable = True

    def init_vars(self, x_stacked) -> AlgoVars:
        return RoundStartVars(extra=_clone(x_stacked))  # x at the start of the current round

    def boundary(self, x_stacked, vars: AlgoVars):
        x_start = vars.extra
        avg_start = _worker_mean(x_start)  # the overlapped collective
        tree_map(_rebase_rows_, x_stacked, x_start, avg_start)
        return x_stacked, RoundStartVars(extra=_clone(x_stacked))


def make_algorithm(cfg: AlgoConfig) -> Algorithm:
    """Deprecated: use :func:`repro_torch.core.make_strategy`. The objects
    built here are the per-leaf reference the native strategies are held
    against."""
    warnings.warn(
        "make_algorithm() builds the deprecated single-hook Algorithm shim (oracle-only); "
        "use repro_torch.core.make_strategy instead",
        DeprecationWarning,
        stacklevel=2,
    )
    table = {
        "overlap_local_sgd": OverlapLocalSGD,
        "local_sgd": LocalSGD,
        "sync_sgd": SyncSGD,
        "easgd": EASGD,
        "cocod": CoCoDSGD,
    }
    if cfg.name == "powersgd":
        from repro_torch.core.powersgd import PowerSGD

        return PowerSGD(cfg)
    if cfg.name not in table:
        raise ValueError(f"unknown algorithm {cfg.name!r}; known: {sorted(table) + ['powersgd']}")
    return table[cfg.name](cfg)
