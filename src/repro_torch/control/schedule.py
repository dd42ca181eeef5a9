"""Simulated τ schedules for the dry-run cost model (DESIGN.md §6); the
port's copy of ``repro.control.schedule``.

A fixed-τ dry-run records one round program's cost; an adaptive-τ run is a
*sequence* of round programs selected by the controller. This module makes
that sequence cost-modelable without running training:

* ``per_tau_costs`` — the composed train cost (the reference's
  ``launch/costprobe.py``; ROADMAP item 10d ports it) is
  linear in τ by construction (every part's multiplier is τ-proportional
  except the once-per-round boundary), so per-τ program costs extrapolate
  exactly from one composed probe.
* ``simulate_trajectory`` — drives a :class:`TauController` against a
  documented reference drift model,

      drift/scale ≈ r0 · √τ / √(1 + t),    t = local steps taken so far

  (drift grows like √τ with the round length — the local-SGD deviation
  bound — and decays as optimization converges). This is a *planning*
  signal, not a prediction of any particular run; it exercises the exact
  controller code the live path uses.
* ``schedule_block`` — the dry-run JSON block: controller config, the
  simulated trajectory, per-τ costs/round-times, and the scheduled total
  wall-clock next to the fixed-τ baseline over the same local-step budget
  (both from :mod:`repro_torch.core.runtime_model`).
"""
from __future__ import annotations

import math
from typing import Iterable, List, Optional

from repro_torch.control.controller import TauController
from repro_torch.core.runtime_model import BLOCKING, GOSSIP, OVERLAPPED, RuntimeConfig, simulate

# strategies the runtime model has no entry for, mapped onto the entry with
# the same blocking structure (delayed_avg consumes mid-round like CoCoD;
# the sparse anchor keeps Overlap-Local-SGD's launch/consume window)
_RUNTIME_ALGO = {"delayed_avg": "cocod", "sparse_anchor": "overlap_local_sgd"}


def runtime_algo(strategy: str) -> str:
    """Map a strategy name onto the runtime model's algorithm set."""
    if strategy in BLOCKING or strategy in OVERLAPPED or strategy in GOSSIP:
        return strategy
    return _RUNTIME_ALGO.get(strategy, "local_sgd")


def per_tau_costs(composed: dict, taus: Iterable[int]) -> List[dict]:
    """Extrapolate a composed train cost (``costprobe.composed_cost``) to a
    set of τ values. Every part's multiplier except the boundary's scales
    linearly with τ (blocks and embed_head run τ·n_micro times, the
    optimizer τ times, the boundary once), so this is exact per-part
    arithmetic, not a fit."""
    tau0 = int(composed["tau"])
    rows = []
    for tau in taus:
        row = dict(tau=int(tau), flops=0.0, bytes=0.0, coll=0.0)
        for label, p in composed["parts"].items():
            mult = p["mult"] if label == "boundary" else p["mult"] * tau / tau0
            for k in ("flops", "bytes", "coll"):
                row[k] += mult * p[k]
        rows.append(row)
    return rows


def simulate_trajectory(ctrl: TauController, rounds: int, r0: Optional[float] = None, fault_plan=None) -> List[dict]:
    """Drive ``ctrl`` for ``rounds`` rounds of the reference drift model and
    return its telemetry history. Mutates ``ctrl`` (pass a fresh instance).

    ``r0`` anchors the model: it is the drift ratio of the very first round
    at τ=1. The default sits on the controller's upper threshold, so the
    schedule starts communication-bound and relaxes as the √(1+t) decay
    sets in — the trajectory sweeps shrink/hold/grow territory.

    ``fault_plan`` (:class:`repro_torch.fault.plan.FaultPlan`) marks each round's
    fault reason into the controller exactly as the live harness does: a
    degraded round is a ``fault_hold`` and its record carries the reason —
    the trajectory proves adaptive-τ and fault handling compose."""
    if r0 is None:
        r0 = ctrl.hi
    t = 0  # local steps taken
    for r in range(rounds):
        tau = ctrl.tau
        ratio = r0 * math.sqrt(tau) / math.sqrt(1.0 + t)
        fault = fault_plan.fault_reason(r) if fault_plan is not None else None
        ctrl.update(drift=ratio, scale=1.0, fault=fault)
        t += tau
    return ctrl.history


def _round_time(algo: str, tau: int, rt: RuntimeConfig, amortize: int = 8) -> float:
    """Mean per-round wall-clock at a given τ, amortized over a few rounds
    so overlapped algorithms pay (or hide) their in-flight collective."""
    res = simulate(algo, tau, tau * amortize, rt)
    return res.total_time / amortize


def schedule_block(
    strategy: str,
    ctrl: TauController,
    *,
    rounds: int = 50,
    rt: Optional[RuntimeConfig] = None,
    composed: Optional[dict] = None,
    r0: Optional[float] = None,
    fault_plan=None,
) -> dict:
    """Build the dry-run's ``tau_schedule`` JSON block.

    Simulates the controller trajectory, prices every τ the schedule
    touches (runtime-model round time; composed flops/bytes/coll when a
    composed cost is supplied), and totals the scheduled run against the
    fixed-τ baseline spending the same local-step budget at the starting τ.

    ``fault_plan`` threads the fault schedule through both halves: the
    trajectory records ``fault_hold`` decisions on degraded rounds, and the
    runtime config (unless explicitly given) takes the plan's straggler/
    jitter distributions via :meth:`FaultPlan.runtime_config`.
    """
    if rt is None:
        rt = fault_plan.runtime_config() if fault_plan is not None else RuntimeConfig()
    algo = runtime_algo(strategy)
    tau0 = ctrl.tau
    history = simulate_trajectory(ctrl, rounds, r0=r0, fault_plan=fault_plan)
    taus = ctrl.taus_seen
    times = {tau: _round_time(algo, tau, rt) for tau in taus}
    per_tau = [dict(tau=tau, round_time_s=times[tau]) for tau in taus]
    if composed is not None:
        for row, costs in zip(per_tau, per_tau_costs(composed, taus)):
            row.update({k: costs[k] for k in ("flops", "bytes", "coll")})
    total_steps = sum(h["tau"] for h in history)
    total_time = sum(times[h["tau"]] for h in history)
    fixed_rounds = max(total_steps // tau0, 1)
    fixed_time = _round_time(algo, tau0, rt) * fixed_rounds
    return dict(
        controller=dict(
            tau0=tau0,
            tau_min=ctrl.tau_min,
            tau_max=ctrl.tau_max,
            lo=ctrl.lo,
            hi=ctrl.hi,
            warmup_rounds=ctrl.warmup_rounds,
            cooldown_rounds=ctrl.cooldown_rounds,
        ),
        rounds=rounds,
        total_local_steps=total_steps,
        trajectory=[
            dict(
                round=h["round"],
                tau=h["tau"],
                drift_ratio=h["drift_ratio"],
                decision=h["decision"],
                next_tau=h["next_tau"],
                **({"fault": h["fault"]} if "fault" in h else {}),
            )
            for h in history
        ],
        per_tau=per_tau,
        compiled_programs=len(taus),
        total_time_s=total_time,
        fixed_tau_time_s=fixed_time,
    )
