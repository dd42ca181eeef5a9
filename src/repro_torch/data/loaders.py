"""Worker-stacked batch builders (counterpart of ``repro.data.loaders``;
numpy, byte-identical to the reference's batches for the same seed). A
*batch fn* is a zero-arg callable returning one per-step batch of numpy
arrays shaped (m, b, ...); :func:`round_batch` stacks τ of them into the
(τ, m, b, ...) round the engine walks. The LM batch fn covers text archs
and the modality frontends' batches (vision patch embeddings, audio
codebooks)."""
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
    """Worker-stacked synthetic LM batches for ``cfg``: a dict of ``tokens``
    and ``targets``, each (m, batch, seq) int32, worker i reading the stream
    seeded ``seed + i``. The frontends draw from one more generator,
    ``default_rng(seed)``, after every worker's text batch, which is drawn
    (and, for audio, thrown away) each step as in the reference: a vision
    batch adds ``image_embeds`` (m, batch, tokens_per_item, embed_dim) f32;
    an audio batch's ``tokens`` and ``targets`` are (m, batch, K, seq)."""
    streams = [lm_batch_stream(batch, seq, cfg.vocab_size, seed=seed + i) for i in range(m)]
    rng = np.random.default_rng(seed)
    fe = cfg.frontend

    def next_batch():
        toks, tgts = zip(*[next(s) for s in streams])
        if fe is not None and fe.kind == "audio":
            shape = (m, batch, fe.num_codebooks, seq)
            toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
            return dict(tokens=toks, targets=rng.integers(0, cfg.vocab_size, shape).astype(np.int32))
        out = dict(tokens=np.stack(toks), targets=np.stack(tgts))
        if fe is not None and fe.kind == "vision":
            shape = (m, batch, fe.tokens_per_item, fe.embed_dim)
            out["image_embeds"] = rng.normal(size=shape).astype(np.float32)
        return out

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
