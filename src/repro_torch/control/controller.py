"""Adaptive-τ controller, the host-side decision loop (a copy of
``repro.control.controller``; the port imports nothing of the JAX package).

The paper fixes τ per run and points at AdaComm (its ref. [14]) for adapting
it. The controller grows τ while the workers' consensus distance stays a
small fraction of the parameter norm and shrinks it when they drift apart:

    τ_{r+1} = clip(τ_r · 2,      if  drift_r < lo · scale_r
              τ_r,               if  lo·scale ≤ drift ≤ hi·scale
              max(τ_r / 2, 1),   if  drift_r > hi · scale_r)

with drift_r = mean_i ‖x_i − x̄‖ and scale_r = ‖x̄‖, both measured on the
*pre-boundary* plane by the consensus probe
(:mod:`repro_torch.kernels.consensus_probe`). The strict inequalities are
the hysteresis band: a ratio inside [lo, hi], either edge included, holds τ.

``warmup_rounds`` holds τ for the first rounds; ``cooldown_rounds`` holds τ
for N rounds after every change, so a decision is judged on drift measured
at the new τ. A fault round (``update(..., fault=reason)``) is a
``fault_hold``: its drift was measured under a partial membership.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import torch

from repro_torch.parallel.packing import Packed, leaf_views, tree_flatten


@dataclass
class TauController:
    """AdaComm-style multiplicative τ controller with hysteresis.

    Telemetry: every :meth:`update` appends one structured record to
    ``history`` with keys ``round``, ``tau`` (the τ the round ran at),
    ``drift``, ``scale``, ``drift_ratio``, ``decision`` (one of
    ``warmup | cooldown | grow | shrink | hold | clamp | fault_hold``) and
    ``next_tau``; records of fault rounds additionally carry a ``fault``
    key with the harness's reason string. The training loop surfaces these
    records as the run's τ schedule.
    """

    tau: int = 1
    tau_min: int = 1
    tau_max: int = 32
    lo: float = 0.01  # drift/scale below this: communicate less often
    hi: float = 0.05  # drift/scale above this: communicate more often
    warmup_rounds: int = 0  # hold τ for the first N rounds
    cooldown_rounds: int = 0  # hold τ for N rounds after every change
    history: List[dict] = field(default_factory=list)
    _round: int = field(default=0, init=False, repr=False)
    _cooldown: int = field(default=0, init=False, repr=False)

    def update(self, drift: float, scale: float, fault: "str | None" = None) -> int:
        """Consume one round's consensus stats, return the next round's τ.

        ``fault`` (a reason string from the fault harness, e.g.
        ``"crash+deadline"``) marks a degraded round: τ is held — the
        round's drift was measured under a partial membership, so acting on
        it would let a crash masquerade as a non-IID drift signal — and the
        record carries the reason. Fault holds do not consume cooldown:
        the post-change observation window resumes on the next clean round.
        """
        ratio = float(drift) / max(float(scale), 1e-12)
        old = self.tau
        if fault is not None:
            decision = "fault_hold"
        elif self._round < self.warmup_rounds:
            decision = "warmup"
        elif self._cooldown > 0:
            decision = "cooldown"
            self._cooldown -= 1
        elif ratio < self.lo:
            self.tau = min(self.tau * 2, self.tau_max)
            decision = "grow" if self.tau != old else "clamp"
        elif ratio > self.hi:
            self.tau = max(self.tau // 2, self.tau_min)
            decision = "shrink" if self.tau != old else "clamp"
        else:
            decision = "hold"
        if decision in ("grow", "shrink"):
            self._cooldown = self.cooldown_rounds
        record = dict(
            round=self._round,
            tau=old,
            drift=float(drift),
            scale=float(scale),
            drift_ratio=ratio,
            decision=decision,
            next_tau=self.tau,
        )
        if fault is not None:
            record["fault"] = str(fault)
        self.history.append(record)
        self._round += 1
        return self.tau

    @property
    def taus_seen(self) -> List[int]:
        """Distinct τ values the schedule has run at (sorted)."""
        return sorted({h["tau"] for h in self.history} | {self.tau})


@dataclass
class AdaptiveTau(TauController):
    """The reference's back-compat name for :class:`TauController`: same
    defaults, no warmup or cooldown."""


def consensus_drift(x_stacked) -> tuple:
    """(mean_i ‖x_i − x̄‖, ‖x̄‖) over the stacked worker parameters, as 0-dim
    float32 tensors: the per-leaf oracle the probe is held against. Takes a
    ``Packed`` plane (its leaves through ``leaf_views``) or a nested dict of
    worker-stacked leaves."""
    leaves = leaf_views(x_stacked) if isinstance(x_stacked, Packed) else tree_flatten(x_stacked)[0]
    sq_drift, sq_scale = 0.0, 0.0
    for t in leaves:
        tf = t.float()
        mean = torch.mean(tf, dim=0, keepdim=True)
        sq_drift = sq_drift + torch.sum(torch.square(tf - mean)) / t.shape[0]
        sq_scale = sq_scale + torch.sum(torch.square(mean))
    return torch.sqrt(sq_drift), torch.sqrt(sq_scale)
