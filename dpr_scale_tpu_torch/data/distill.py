"""Embedding-distillation data assembly (the reference's
DPRDistillTransform, dpr_scale/transforms/dpr_distill_transform.py:12-81).

The port's copy of ``dpr_scale_tpu/data/distill.py``. Each training row
carries teacher vectors: ``ctx_target_vectors`` (a list of positive-context
embeddings) and ``qry_target_vector``. Every question becomes TWO examples,
(question -> a sampled positive context vector) and (question -> the
teacher query vector), so the student query encoder regresses onto both.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from dpr_scale_tpu_torch.data.tokenize import HFTokenizer
from dpr_scale_tpu_torch.utils.jsonl import json_loads


class DistillExampleBuilder:
    def __init__(self, pos_ctx_sample: bool = True, seed: int = 0):
        self.pos_ctx_sample = pos_ctx_sample
        self._rng = np.random.default_rng(seed)

    def reseed(self, entropy) -> None:
        """Pin the sampling RNG to a per-batch key, so each batch is a pure
        function of its (seed, epoch, position): what resuming at a batch
        index needs (the contract of ``DPRExampleBuilder.reseed``)."""
        self._rng = np.random.default_rng(list(entropy))

    def build_batch(self, rows: Sequence, stage: str = "train") -> Dict[str, list]:
        questions: List[str] = []
        targets: List[List[float]] = []
        for row in rows:
            if isinstance(row, (bytes, bytearray, str)):
                row = json_loads(row)
            ctx_vecs = row["ctx_target_vectors"]
            if not ctx_vecs:
                raise ValueError(f"No positive contexts in row {row.get('question')!r}")
            if not isinstance(ctx_vecs[0], (list, tuple)):
                raise ValueError(
                    f"ctx_target_vectors must be a list of embeddings in row "
                    f"{row.get('question')!r}"
                )
            if stage == "train" and self.pos_ctx_sample:
                pick = int(self._rng.integers(len(ctx_vecs)))
            else:
                pick = 0
            questions.extend([row["question"]] * 2)
            targets.append(list(ctx_vecs[pick]))
            targets.append(list(row["qry_target_vector"]))
        return {"questions": questions, "targets": targets}


class DistillBatcher:
    def __init__(self, tokenizer: HFTokenizer):
        self.tokenizer = tokenizer

    def __call__(self, built: Dict[str, list]) -> Dict[str, np.ndarray]:
        ids, mask = self.tokenizer(built["questions"])
        return {
            "query_ids": ids,
            "query_mask": mask,
            "target_vectors": np.asarray(built["targets"], dtype=np.float32),
        }
