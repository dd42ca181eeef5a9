"""Adaptive τ (counterpart of ``repro.control``): the host-side
:class:`TauController`, the per-leaf ``consensus_drift`` oracle, and the
per-τ round-program cache. The measurement side is
:mod:`repro_torch.kernels.consensus_probe` (K8, and the fused probe of
K3/K4); the drive side is ``repro_torch.api.Experiment.fit(adaptive_tau=...)``.
The reference's ``control/schedule.py`` (τ-schedule cost modelling for the
dry-run) needs the runtime model and stays with ROADMAP Queue 1 item 10."""
from repro_torch.control.controller import AdaptiveTau, TauController, consensus_drift
from repro_torch.control.program_cache import RoundProgramCache, TauScheduledTrainer

__all__ = ["AdaptiveTau", "TauController", "consensus_drift", "RoundProgramCache", "TauScheduledTrainer"]
