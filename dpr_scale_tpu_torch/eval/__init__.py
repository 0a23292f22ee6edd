"""Retrieval evaluation: the port's copies of ``dpr_scale_tpu.eval`` (pure
Python, no accelerator), held equal to them by ``tests/test_torch_eval.py``."""
from dpr_scale_tpu_torch.eval.qa_eval import SimpleTokenizer, evaluate_retrieval, has_answers
from dpr_scale_tpu_torch.eval.msmarco import compute_metrics_from_files, trec_metrics

__all__ = [
    "SimpleTokenizer",
    "has_answers",
    "evaluate_retrieval",
    "compute_metrics_from_files",
    "trec_metrics",
]
