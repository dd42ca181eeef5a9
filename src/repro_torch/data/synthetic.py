"""Synthetic classification data (counterpart of ``repro.data.synthetic``;
a numpy copy, so the same seed gives the same bytes). The LM token stream
comes with the LM slice."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ClassificationData:
    x: np.ndarray  # (n, dim) float32
    y: np.ndarray  # (n,) int32
    num_classes: int

    @property
    def n(self) -> int:
        return self.x.shape[0]


def make_classification(
    n: int = 50_000,
    dim: int = 64,
    num_classes: int = 10,
    noise: float = 0.6,
    seed: int = 0,
    nonlinear: bool = True,
) -> ClassificationData:
    """Random-teacher classification task: class centers plus noise, and an
    optional nonlinear warp; class structure makes non-IID splits skewed."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(num_classes, dim)).astype(np.float32)
    y = rng.integers(0, num_classes, size=(n,)).astype(np.int32)
    x = centers[y] + noise * rng.normal(size=(n, dim)).astype(np.float32)
    if nonlinear:
        w = rng.normal(size=(dim, dim)).astype(np.float32) / np.sqrt(dim)
        x = x + 0.1 * np.tanh(x @ w)
    return ClassificationData(x=x.astype(np.float32), y=y, num_classes=num_classes)
