"""Host-side evaluation metrics: the port's own copy of ``vipant_tpu/eval``."""

from .metrics import (
    classification_p1,
    grouped_pnr,
    multilabel_report,
    one_vs_k_retrieval,
    retrieval_metrics,
    symmetric_retrieval,
    zero_shot_classification,
)

__all__ = [
    "classification_p1",
    "grouped_pnr",
    "multilabel_report",
    "one_vs_k_retrieval",
    "retrieval_metrics",
    "symmetric_retrieval",
    "zero_shot_classification",
]
