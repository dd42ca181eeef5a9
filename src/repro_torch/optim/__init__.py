from repro_torch.optim import schedules
from repro_torch.optim.optimizers import (
    Optimizer,
    PackedAdamState,
    PackedSGDState,
    adamw,
    clip_packed_by_global_norm_,
    from_config,
    offload_capable,
    packed_global_norm,
    sgd,
)

__all__ = [
    "Optimizer",
    "PackedAdamState",
    "PackedSGDState",
    "adamw",
    "clip_packed_by_global_norm_",
    "from_config",
    "offload_capable",
    "packed_global_norm",
    "schedules",
    "sgd",
]
