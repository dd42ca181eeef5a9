"""Deterministic, seedable fault plans (a numpy copy of
``repro.fault.plan``; the port imports nothing of the JAX package).

A :class:`FaultPlan` holds everything the fault layer injects: crash/rejoin
events, per-worker persistent slowdowns, a lognormal per-step compute
jitter, and network jitter on the collective — all resolved into a
deterministic per-round schedule at query time from ``(seed, round)``
substreams (``np.random.default_rng([seed, r])``), so the same plan gives
the same membership history in both packages, bit for bit.

Two exclusion mechanisms compose per round:

* **crash windows** — worker w is dead for rounds ``[crash, rejoin)``;
* **straggler deadlines** — a live worker whose simulated round compute
  exceeds ``deadline_factor ×`` the nominal round time sits the round out.

A worker excluded at round r−1 and included at round r is *rejoining*: the
harness re-syncs its plane rows from the anchor before the round runs
(``resync_at``). :meth:`degraded_rounds` is the schedule's JSON face.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class FaultPlan:
    m: int  # worker count the plan is defined over
    seed: int = 0
    # crash windows: worker -> (crash_round, rejoin_round); rejoin_round may
    # be None for a permanent crash
    crashes: Tuple[Tuple[int, int, Optional[int]], ...] = ()  # (worker, crash_r, rejoin_r)
    # persistent per-worker compute slowdown factors (the paper's Fig. 5
    # "slow worker" knob); 1.0 = nominal
    slowdown: Tuple[Tuple[int, float], ...] = ()  # (worker, factor)
    # lognormal sigma on every worker's per-round compute (system noise)
    straggle_std: float = 0.0
    # probability a worker's round slows by straggle_factor (transient hiccup)
    straggle_prob: float = 0.0
    straggle_factor: float = 4.0
    # lognormal sigma on the collective's transit time (network jitter)
    jitter_std: float = 0.0
    # a worker whose simulated round compute exceeds this multiple of the
    # nominal round time misses the overlap window and sits the round out
    deadline_factor: float = 3.0

    def __post_init__(self):
        for w, r_crash, r_rejoin in self.crashes:
            if not 0 <= w < self.m:
                raise ValueError(f"crash worker {w} out of range for m={self.m}")
            if r_rejoin is not None and r_rejoin <= r_crash:
                raise ValueError(f"worker {w}: rejoin round {r_rejoin} must follow crash round {r_crash}")
        for w, f in self.slowdown:
            if not 0 <= w < self.m:
                raise ValueError(f"slowdown worker {w} out of range for m={self.m}")
            if f <= 0:
                raise ValueError(f"slowdown factor must be positive, got {f}")

    # -- deterministic per-round draws --------------------------------------

    def _rng(self, r: int) -> np.random.Generator:
        """Per-round substream: draws depend on (seed, round) only, never on
        query order — replaying any round is reproducible in isolation."""
        return np.random.default_rng([self.seed, r])

    def slow_factors(self) -> np.ndarray:
        """(m,) persistent compute-slowdown multipliers."""
        f = np.ones(self.m)
        for w, fac in self.slowdown:
            f[w] = fac
        return f

    def round_compute_factors(self, r: int) -> np.ndarray:
        """(m,) simulated compute time for round r, as a multiple of the
        nominal round time (1.0 = nominal): persistent slowdown × lognormal
        system noise × transient hiccups."""
        rng = self._rng(r)
        t = self.slow_factors().copy()
        if self.straggle_std > 0:
            t *= rng.lognormal(mean=0.0, sigma=self.straggle_std, size=self.m)
        if self.straggle_prob > 0:
            slow = rng.random(self.m) < self.straggle_prob
            t = np.where(slow, t * self.straggle_factor, t)
        return t

    def comm_jitter(self, r: int) -> float:
        """Multiplicative network jitter on round r's collective."""
        if self.jitter_std <= 0:
            return 1.0
        # dedicated substream offset so compute draws stay unchanged when
        # jitter is toggled on
        return float(np.random.default_rng([self.seed, r, 1]).lognormal(0.0, self.jitter_std))

    # -- the per-round schedule ---------------------------------------------

    def crashed_at(self, r: int) -> np.ndarray:
        """(m,) bool: dead inside a crash window at round r."""
        dead = np.zeros(self.m, bool)
        for w, r_crash, r_rejoin in self.crashes:
            if r_crash <= r and (r_rejoin is None or r < r_rejoin):
                dead[w] = True
        return dead

    def deadline_missed(self, r: int) -> np.ndarray:
        """(m,) bool: live workers whose simulated compute blew the deadline."""
        missed = self.round_compute_factors(r) > self.deadline_factor
        missed &= ~self.crashed_at(r)
        return missed

    def mask_at(self, r: int) -> np.ndarray:
        """(m,) bool liveness mask for round r (crashes ∧ deadline misses).

        Crash windows are authoritative: a crashed worker is dead, full stop.
        If every *non-crashed* worker blew its deadline, the fastest of them
        is kept (excluding all of them would turn a straggler blip into a
        lost round). A round where every worker is inside a crash window
        returns the all-False mask — that round has no boundary: the live
        path (``Membership.from_mask``) refuses to build it host-side, and
        the runtime model skips the collective and counts the round in
        ``RuntimeResult.skipped_rounds``."""
        live = ~(self.crashed_at(r) | self.deadline_missed(r))
        if not live.any():
            not_crashed = ~self.crashed_at(r)
            if not_crashed.any():
                candidates = np.nonzero(not_crashed)[0]
                live[candidates[np.argmin(self.round_compute_factors(r)[candidates])]] = True
        return live

    def resync_at(self, r: int) -> np.ndarray:
        """(m,) bool: workers rejoining at round r — excluded at r−1 (or
        crashed before round 0) and live at r. Their plane slices must be
        re-synced from the anchor before the round runs."""
        if r == 0:
            return np.zeros(self.m, bool)
        return self.mask_at(r) & ~self.mask_at(r - 1)

    # -- JSON faces ----------------------------------------------------------

    def events(self) -> dict:
        return dict(
            m=self.m,
            seed=self.seed,
            crashes=[dict(worker=w, crash_round=c, rejoin_round=j) for w, c, j in self.crashes],
            slowdown=[dict(worker=w, factor=f) for w, f in self.slowdown],
            straggle_std=self.straggle_std,
            straggle_prob=self.straggle_prob,
            straggle_factor=self.straggle_factor,
            jitter_std=self.jitter_std,
            deadline_factor=self.deadline_factor,
        )

    def degraded_rounds(self, rounds: int) -> dict:
        """The ``degraded_rounds`` JSON block: the fault events plus
        the resolved membership schedule over ``rounds`` rounds (only rounds
        where the mask departs from fully-live, plus every re-sync)."""
        schedule: List[dict] = []
        for r in range(rounds):
            mask = self.mask_at(r)
            resync = self.resync_at(r)
            if mask.all() and not resync.any():
                continue
            schedule.append(
                dict(
                    round=r,
                    live=int(mask.sum()),
                    excluded=[int(i) for i in np.nonzero(~mask)[0]],
                    crashed=[int(i) for i in np.nonzero(self.crashed_at(r))[0]],
                    missed_deadline=[int(i) for i in np.nonzero(self.deadline_missed(r))[0]],
                    resynced=[int(i) for i in np.nonzero(resync)[0]],
                )
            )
        return dict(events=self.events(), rounds=rounds, degraded=len(schedule), schedule=schedule)

    def runtime_config(self, base=None):
        """A :class:`repro_torch.core.runtime_model.RuntimeConfig` matched to
        this plan: worker count and seed from the plan, the cfg's own
        straggler knobs zeroed — when ``simulate(..., fault_plan=self)``
        runs, the plan's per-round factors are the straggler model, and
        leaving the cfg knobs on would double-count the noise. ``base``
        supplies the hardware constants (e.g.
        :func:`~repro_torch.core.runtime_model.calibrated_config` output)."""
        from dataclasses import replace

        from repro_torch.core.runtime_model import RuntimeConfig

        cfg = base if base is not None else RuntimeConfig()
        return replace(cfg, m=self.m, seed=self.seed, straggle_std=0.0, straggle_prob=0.0)

    def fault_reason(self, r: int) -> Optional[str]:
        """Compact per-round label for controller telemetry (None = clean)."""
        parts = []
        if self.crashed_at(r).any():
            parts.append("crash")
        if self.deadline_missed(r).any():
            parts.append("deadline")
        if self.resync_at(r).any():
            parts.append("rejoin")
        return "+".join(parts) or None

    # -- parsing --------------------------------------------------------------

    @classmethod
    def parse(cls, spec: str, m: int, seed: int = 0, **kw) -> "FaultPlan":
        """Parse the CLI/CI spec grammar, comma-separated:

            crash:W@R       worker W crashes at round R (no rejoin)
            crash:W@R-S     … and rejoins at round S
            slow:WxF        worker W runs Fx slower, persistently
            std:S           lognormal sigma S on per-round compute
            prob:P@F        each round, slow by F with probability P
            jitter:S        lognormal sigma S on collective transit
            deadline:F      deadline at F× the nominal round time

        e.g. ``"crash:1@2-5,slow:2x4"`` — worker 1 dead for rounds 2–4,
        worker 2 a persistent 4× straggler.
        """
        crashes: List[Tuple[int, int, Optional[int]]] = []
        slowdown: List[Tuple[int, float]] = []
        fields: Dict[str, float] = {}
        for item in filter(None, (s.strip() for s in spec.split(","))):
            kind, _, rest = item.partition(":")
            if kind == "crash":
                w, _, rr = rest.partition("@")
                r0, _, r1 = rr.partition("-")
                crashes.append((int(w), int(r0), int(r1) if r1 else None))
            elif kind == "slow":
                w, _, f = rest.partition("x")
                slowdown.append((int(w), float(f)))
            elif kind == "std":
                fields["straggle_std"] = float(rest)
            elif kind == "prob":
                p, _, f = rest.partition("@")
                fields["straggle_prob"] = float(p)
                if f:
                    fields["straggle_factor"] = float(f)
            elif kind == "jitter":
                fields["jitter_std"] = float(rest)
            elif kind == "deadline":
                fields["deadline_factor"] = float(rest)
            else:
                raise ValueError(f"unknown fault spec item {item!r}")
        fields.update(kw)
        return cls(m=m, seed=seed, crashes=tuple(crashes), slowdown=tuple(slowdown), **fields)
