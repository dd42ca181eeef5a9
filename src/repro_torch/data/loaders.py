"""Worker-stacked batch builders (counterpart of ``repro.data.loaders``;
numpy, byte-identical to the reference's batches for the same seed). A
*batch fn* is a zero-arg callable returning one per-step batch of numpy
arrays shaped (m, b, ...); :func:`round_batch` stacks τ of them into the
(τ, m, b, ...) round the engine walks. The LM batch fn covers text archs;
the modality frontends' extra inputs are ROADMAP Queue 1 item 8."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import numpy as np

from repro_torch.data.partition import partition_iid, partition_noniid
from repro_torch.data.pipeline import WorkerBatcher
from repro_torch.data.synthetic import ClassificationData, lm_batch_stream, make_classification


def round_batch(next_batch: Callable, tau: int):
    """Stack τ per-step batches (m, b, ...) into one round (τ, m, b, ...); a
    batch is a tuple of arrays or a dict of them."""
    micro = [next_batch() for _ in range(tau)]
    if isinstance(micro[0], dict):
        return {k: np.stack([b[k] for b in micro]) for k in micro[0]}
    return tuple(np.stack(xs) for xs in zip(*micro))


def lm_batch_fn(cfg, m: int, batch: int, seq: int, seed: int = 0) -> Callable:
    """Worker-stacked synthetic LM batches for a text arch: a dict of
    ``tokens`` and ``targets``, each (m, batch, seq) int32; worker i reads
    the stream seeded ``seed + i``."""
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: LM batches for modality frontends are ROADMAP Queue 1 item 8")
    streams = [lm_batch_stream(batch, seq, cfg.vocab_size, seed=seed + i) for i in range(m)]

    def next_batch():
        toks, tgts = zip(*[next(s) for s in streams])
        return dict(tokens=np.stack(toks), targets=np.stack(tgts))

    return next_batch


@dataclass
class ClassificationSplits:
    """A train/test split plus per-worker index partitions."""

    train: ClassificationData
    test: ClassificationData
    parts: List[np.ndarray]

    @property
    def num_workers(self) -> int:
        return len(self.parts)


def make_classification_splits(m: int, *, n: int = 30000, dim: int = 64, num_classes: int = 10,
                               noise: float = 3.0, holdout: int = 4000, noniid: bool = False,
                               skew: float = 0.64, seed: int = 0) -> ClassificationSplits:
    """The synthetic task split into a holdout test set and m partitions."""
    data = make_classification(n=n, dim=dim, num_classes=num_classes, noise=noise, seed=seed)
    test = ClassificationData(x=data.x[:holdout], y=data.y[:holdout], num_classes=num_classes)
    train = ClassificationData(x=data.x[holdout:], y=data.y[holdout:], num_classes=num_classes)
    parts = partition_noniid(train, m, skew=skew, seed=seed) if noniid else partition_iid(train, m, seed=seed)
    return ClassificationSplits(train=train, test=test, parts=parts)


def classification_batch_fn(splits: ClassificationSplits, batch_per_worker: int, seed: int = 0) -> Callable:
    """Worker-stacked (x, y) numpy batches from the partitioned data."""
    return WorkerBatcher(splits.train, splits.parts, batch_per_worker, seed=seed).__next__
