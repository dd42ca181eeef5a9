"""Worker-stacked host batches (counterpart of ``repro.data.pipeline``; a
numpy copy). Sampling is sequential without shuffling within an epoch, as
the paper trains ("evenly partitioned across all nodes and not shuffled")."""
from __future__ import annotations

from typing import Iterator, List

import numpy as np

from repro_torch.data.synthetic import ClassificationData


class WorkerBatcher:
    """Iterates worker-stacked (x, y) minibatches from per-worker index sets."""

    def __init__(self, data: ClassificationData, parts: List[np.ndarray], batch_per_worker: int, seed: int = 0,
                 reshuffle_each_epoch: bool = False):
        self.data = data
        self.parts = [np.asarray(p) for p in parts]
        self.b = batch_per_worker
        self.m = len(parts)
        self.rng = np.random.default_rng(seed)
        self.reshuffle = reshuffle_each_epoch
        self._pos = [0] * self.m

    def steps_per_epoch(self) -> int:
        return min(len(p) for p in self.parts) // self.b

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        xs, ys = [], []
        for i in range(self.m):
            part = self.parts[i]
            if self._pos[i] + self.b > len(part):
                self._pos[i] = 0
                if self.reshuffle:
                    self.rng.shuffle(part)
            sl = part[self._pos[i] : self._pos[i] + self.b]
            self._pos[i] += self.b
            xs.append(self.data.x[sl])
            ys.append(self.data.y[sl])
        return np.stack(xs), np.stack(ys)
