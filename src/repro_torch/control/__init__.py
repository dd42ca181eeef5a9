"""Adaptive τ (counterpart of ``repro.control``): the host-side
:class:`TauController`, the per-leaf ``consensus_drift`` oracle, and the
per-τ round-program cache. The measurement side is
:mod:`repro_torch.kernels.consensus_probe` (K8, and the fused probe of
K3/K4); the drive side is ``repro_torch.api.Experiment.fit(adaptive_tau=...)``;
:mod:`repro_torch.control.schedule` prices a τ schedule on the runtime model
(:mod:`repro_torch.core.runtime_model`)."""
from repro_torch.control.controller import AdaptiveTau, TauController, consensus_drift
from repro_torch.control.program_cache import RoundProgramCache, TauScheduledTrainer
from repro_torch.control.schedule import per_tau_costs, runtime_algo, schedule_block, simulate_trajectory

__all__ = ["AdaptiveTau", "TauController", "consensus_drift", "RoundProgramCache", "TauScheduledTrainer",
           "per_tau_costs", "runtime_algo", "schedule_block", "simulate_trajectory"]
