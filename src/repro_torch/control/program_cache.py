"""Round programs keyed by τ (counterpart of
``repro.control.program_cache``).

In the reference τ is a static shape of the compiled round program, so
every τ the controller reaches compiles one program. The port's round step
loops over τ in Python and needs no program per τ, but
:class:`RoundProgramCache` still memoises ``make_program(tau)`` and counts
the builds, so ``len(exp.tau_programs)`` means what it means in the
reference: the distinct τ values a run has used (at most O(log τ_max)). A
CUDA graph per τ, captured once and replayed, is what the cache is for
later (ROADMAP).
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.control.controller import TauController, consensus_drift


class RoundProgramCache:
    """Memoised ``make_program(tau) -> program`` with a build counter:
    ``make_program`` is called at most once a distinct τ, and
    ``compilations`` counts those calls."""

    def __init__(self, make_program: Callable[[int], Callable]):
        self.make_program = make_program
        self._programs: Dict[int, Callable] = {}
        self.compilations = 0

    def program_for(self, tau: int) -> Callable:
        if tau not in self._programs:
            self._programs[tau] = self.make_program(tau)
            self.compilations += 1
        return self._programs[tau]

    @property
    def taus(self):
        """τ values with a built program (sorted)."""
        return sorted(self._programs)

    def __len__(self) -> int:
        return len(self._programs)

    def __contains__(self, tau: int) -> bool:
        return tau in self._programs


class TauScheduledTrainer:
    """A host-side loop that re-selects τ between rounds (the reference's
    older surface): ``make_step(tau)`` returns a round step for that τ,
    cached through :class:`RoundProgramCache`; it measures the *post*-
    boundary state with the per-leaf oracle. ``Experiment.fit(adaptive_tau=...)``
    reads the pre-boundary probe out of the round's metrics instead."""

    def __init__(self, make_step: Callable[[int], Callable], controller: TauController):
        self.programs = RoundProgramCache(make_step)
        self.ctrl = controller

    @property
    def make_step(self) -> Callable[[int], Callable]:
        return self.programs.make_program

    def step_for(self, tau: int) -> Callable:
        return self.programs.program_for(tau)

    def run_round(self, state, batch_fn):
        tau = self.ctrl.tau
        step = self.step_for(tau)
        batch = batch_fn(tau)
        state, metrics = step(state, batch)
        drift, scale = consensus_drift(state.x)
        self.ctrl.update(float(drift), float(scale))
        return state, metrics, tau
