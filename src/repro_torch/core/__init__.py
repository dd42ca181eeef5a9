"""Distributed-optimization core (counterpart of ``repro.core``).

* :mod:`repro_torch.core.strategy`: the two-phase :class:`CommStrategy`
  protocol, on the packed plane and per leaf; :func:`make_strategy` is the
  factory and :func:`resolve_strategy` the one resolution chain.
* :mod:`repro_torch.core.algorithms`: the legacy single-``boundary``-hook
  ``Algorithm`` classes. **Deprecated, oracle-only.** Taking a legacy name
  from ``repro_torch.core`` warns with a ``DeprecationWarning`` (the lazy
  export below), as calling :func:`make_algorithm` does.
"""
import warnings

from repro_torch.core import mixing, topology
from repro_torch.core.strategy import (
    STRATEGIES,
    AlgoVars,
    CommStrategy,
    CoCoDStrategy,
    DelayedAveragingStrategy,
    EASGDStrategy,
    GossipExpStrategy,
    GossipFullStrategy,
    GossipInflight,
    GossipPushSumStrategy,
    GossipRingStrategy,
    LegacyStrategy,
    LocalSGDStrategy,
    OverlapLocalSGDStrategy,
    PowerSGDStrategy,
    SparseAnchorStrategy,
    SyncSGDStrategy,
    as_strategy,
    make_strategy,
    resolve_strategy,
    sparsify_topk,
    sparsify_topk_,
)
from repro_torch.core.topology import Topology, cached_topology, compose_membership, make_topology

# served lazily, so that importing repro_torch.core never touches the
# deprecated module and taking one of them warns at the import site
_LEGACY_NAMES = (
    "Algorithm",
    "CoCoDSGD",
    "EASGD",
    "LocalSGD",
    "OverlapLocalSGD",
    "SyncSGD",
    "make_algorithm",
)


def __getattr__(name):
    if name in _LEGACY_NAMES:
        warnings.warn(
            f"repro_torch.core.{name} is the deprecated single-hook Algorithm shim, kept only as the "
            "per-leaf oracle; use repro_torch.core.make_strategy / the two-phase CommStrategy protocol instead",
            DeprecationWarning,
            stacklevel=2,
        )
        from repro_torch.core import algorithms

        return getattr(algorithms, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LEGACY_NAMES))


__all__ = [
    "Algorithm",
    "AlgoVars",
    "CoCoDSGD",
    "CoCoDStrategy",
    "CommStrategy",
    "DelayedAveragingStrategy",
    "EASGD",
    "EASGDStrategy",
    "GossipExpStrategy",
    "GossipFullStrategy",
    "GossipInflight",
    "GossipPushSumStrategy",
    "GossipRingStrategy",
    "LegacyStrategy",
    "LocalSGD",
    "LocalSGDStrategy",
    "OverlapLocalSGD",
    "OverlapLocalSGDStrategy",
    "PowerSGDStrategy",
    "STRATEGIES",
    "SparseAnchorStrategy",
    "SyncSGD",
    "SyncSGDStrategy",
    "Topology",
    "as_strategy",
    "cached_topology",
    "compose_membership",
    "make_algorithm",
    "make_strategy",
    "make_topology",
    "mixing",
    "resolve_strategy",
    "sparsify_topk",
    "sparsify_topk_",
    "topology",
]
