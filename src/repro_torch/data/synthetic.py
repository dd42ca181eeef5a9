"""Synthetic data (counterpart of ``repro.data.synthetic``; a numpy copy, so
the same seed gives the same bytes): the classification task and the LM
token stream."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

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


def lm_batch_stream(batch: int, seq_len: int, vocab_size: int, seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Infinite stream of (tokens, targets), each (batch, seq_len) int32: each
    next token follows a fixed random permutation of the previous one with
    probability 0.75, else is uniform, so a model can learn the bigram."""
    rng = np.random.default_rng(seed)
    v = int(vocab_size)
    perm = rng.permutation(v)
    while True:
        toks = np.empty((batch, seq_len + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, v, size=(batch,))
        rand = rng.random((batch, seq_len))
        noise_tok = rng.integers(0, v, size=(batch, seq_len))
        for t in range(seq_len):
            follow = perm[toks[:, t]]
            toks[:, t + 1] = np.where(rand[:, t] < 0.75, follow, noise_tok[:, t])
        yield toks[:, :-1], toks[:, 1:]
