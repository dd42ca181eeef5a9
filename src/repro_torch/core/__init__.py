from repro_torch.core.strategy import (
    STRATEGIES,
    AlgoVars,
    CommStrategy,
    LocalSGDStrategy,
    OverlapLocalSGDStrategy,
    SyncSGDStrategy,
    make_strategy,
    resolve_strategy,
)

__all__ = [
    "STRATEGIES",
    "AlgoVars",
    "CommStrategy",
    "LocalSGDStrategy",
    "OverlapLocalSGDStrategy",
    "SyncSGDStrategy",
    "make_strategy",
    "resolve_strategy",
]
