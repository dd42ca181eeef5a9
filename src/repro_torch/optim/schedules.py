"""Learning-rate schedules (counterpart of ``repro.optim.schedules``).

A schedule maps the step counter — a 0-dim integer tensor on the training
device — to a 0-dim float32 tensor on the same device, computed there (no
host synchronisation). Each op is the reference's f32 op, so the value at
every step equals the JAX schedule's. One care point: the warmup ratio
divides by a tensor, because PyTorch divides by a Python scalar through its
rounded reciprocal on the GPU, and the reference divides exactly.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

F32 = torch.float32


def warmup_step_decay(base_lr: float, warmup_steps: int, boundaries: Sequence[int],
                      decay_factor: float = 0.1) -> Callable:
    """Linear warmup over ``warmup_steps``, then ×``decay_factor`` at each
    boundary (the paper's CIFAR-10 recipe)."""
    boundaries = tuple(boundaries)

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(F32)
        lr = torch.full((), base_lr, dtype=F32, device=step.device)
        for b in boundaries:
            lr = torch.where(step >= b, lr * decay_factor, lr)
        if warmup_steps > 0:
            warm = base_lr * (step + 1.0) / torch.full((), float(warmup_steps), dtype=F32, device=step.device)
            lr = torch.where(step < warmup_steps, warm, lr)
        return lr

    return schedule


def cosine(base_lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.1) -> Callable:
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(F32)
        div = lambda v: torch.full((), float(v), dtype=F32, device=step.device)  # noqa: E731
        warm = base_lr * (step + 1.0) / div(max(warmup_steps, 1))
        frac = torch.clamp((step - warmup_steps) / div(max(total_steps - warmup_steps, 1)), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, base_lr * cos)

    return schedule


def constant(base_lr: float) -> Callable:
    def schedule(step: torch.Tensor) -> torch.Tensor:
        return torch.full((), base_lr, dtype=F32, device=step.device)

    return schedule


def from_config(cfg) -> Callable:
    """A schedule from an ``OptimizerConfig``."""
    if cfg.decay_steps:
        return warmup_step_decay(cfg.lr, cfg.warmup_steps, cfg.decay_steps, cfg.decay_factor)
    if cfg.warmup_steps:
        return warmup_step_decay(cfg.lr, cfg.warmup_steps, ())
    return constant(cfg.lr)
