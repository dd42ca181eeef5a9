"""Architecture registry: ``--arch <id>`` resolution.

Config modules in ``repro_torch.configs`` call :func:`register` at import
time; :func:`get_arch` imports the configs package so every caller sees the
full pool (one arch, ``qwen2-7b``, in the serving slice).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.config.base import ArchConfig

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch config: {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def _ensure_loaded() -> None:
    importlib.import_module("repro_torch.configs")


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)
