from repro_torch.config.base import (
    TORCH_DTYPES,
    AlgoConfig,
    ArchConfig,
    AttentionConfig,
    FrontendConfig,
    InputShape,
    ModelConfig,
    MoEConfig,
    OptimizerConfig,
    ParallelPlan,
    SSMConfig,
)
from repro_torch.config.registry import get_arch, list_archs, register

__all__ = [
    "TORCH_DTYPES",
    "AlgoConfig",
    "ArchConfig",
    "AttentionConfig",
    "FrontendConfig",
    "InputShape",
    "ModelConfig",
    "MoEConfig",
    "OptimizerConfig",
    "ParallelPlan",
    "SSMConfig",
    "get_arch",
    "list_archs",
    "register",
]
