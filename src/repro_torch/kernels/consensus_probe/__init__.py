"""The consensus-distance probe of adaptive τ over the packed plane
(counterpart of ``repro.kernels.consensus_probe``): K8 standalone, one launch
a dtype bucket, and the same sums fused into K3/K4 (``anchor_mix`` with
``probe=True``) at no extra launch."""
from repro_torch.kernels.consensus_probe.ops import (
    ConsensusStats,
    packed_probe,
    probe_buffer,
    stats_from_partials,
    tree_probe,
)

__all__ = ["ConsensusStats", "packed_probe", "probe_buffer", "stats_from_partials", "tree_probe"]
