from repro_torch.data.loaders import (
    ClassificationSplits,
    classification_batch_fn,
    lm_batch_fn,
    make_classification_splits,
    round_batch,
)
from repro_torch.data.partition import partition_iid, partition_noniid
from repro_torch.data.pipeline import WorkerBatcher
from repro_torch.data.synthetic import ClassificationData, lm_batch_stream, make_classification

__all__ = [
    "ClassificationData",
    "ClassificationSplits",
    "WorkerBatcher",
    "classification_batch_fn",
    "lm_batch_fn",
    "lm_batch_stream",
    "make_classification",
    "make_classification_splits",
    "partition_iid",
    "partition_noniid",
    "round_batch",
]
