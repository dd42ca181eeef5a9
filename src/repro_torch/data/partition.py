"""IID / non-IID partitioning across Local-SGD workers (counterpart of
``repro.data.partition``; a numpy copy). Non-IID: every worker gets an equal
share, ``skew`` of it from one class (paper §4: 2000 of 3125 = 64%)."""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.data.synthetic import ClassificationData


def partition_iid(data: ClassificationData, m: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(data.n)
    per = data.n // m
    return [idx[i * per : (i + 1) * per] for i in range(m)]


def partition_noniid(data: ClassificationData, m: int, skew: float = 0.64, seed: int = 0) -> List[np.ndarray]:
    """Worker i gets ``skew`` of its samples from class (i mod C), the rest
    uniformly from the remainder."""
    rng = np.random.default_rng(seed)
    per = data.n // m
    n_major = int(round(per * skew))
    by_class = [np.flatnonzero(data.y == c) for c in range(data.num_classes)]
    for c in by_class:
        rng.shuffle(c)
    cursor = [0] * data.num_classes
    majors = []
    for i in range(m):
        c = i % data.num_classes
        majors.append(by_class[c][cursor[c] : cursor[c] + n_major])
        cursor[c] += n_major
    rest = np.concatenate([by_class[c][cursor[c] :] for c in range(data.num_classes)])
    rng.shuffle(rest)
    n_rest = per - n_major
    return [np.concatenate([majors[i], rest[i * n_rest : (i + 1) * n_rest]]) for i in range(m)]
