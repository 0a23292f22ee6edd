"""Fixed-shape batch assembly: examples -> numpy arrays ready for the device.

The port's copy of ``dpr_scale_tpu/data/batching.py``. Produces the same
logical batch contract as the reference transform's output
(dpr_scale/transforms/dpr_transform.py:179-187) — ``query_ids``,
``contexts_ids``, ``pos_ctx_indices``, ``scores``, ``ctx_mask`` — plus the
explicit attention masks the encoders take, all with fixed shapes.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from dpr_scale_tpu_torch.data.example import DPRExample, maybe_add_title
from dpr_scale_tpu_torch.data.tokenize import HFTokenizer


class DPRBatcher:
    """Tokenize a list of :class:`DPRExample` into one fixed-shape batch.

    Output dict (B = batch, C = ctxs per question, L = max_seq_len):
      query_ids        (B, L)  int32
      query_mask       (B, L)  int32  attention mask
      contexts_ids     (B*C, L) int32  row-major: question-major blocks,
                                       positive first within each block
      contexts_mask    (B*C, L) int32
      pos_ctx_indices  (B,)    int32  flat index of each question's positive
      scores           (B, C)  float32 teacher scores
      ctx_mask         (B*C,)  bool   True where the context is a dummy pad
    """

    def __init__(self, tokenizer: HFTokenizer, query_max_seq_len=None, ctx_max_seq_len=None):
        self.tokenizer = tokenizer
        self.query_max_seq_len = query_max_seq_len
        self.ctx_max_seq_len = ctx_max_seq_len

    def __call__(self, examples: Sequence[DPRExample]) -> Dict[str, np.ndarray]:
        questions = [ex.question for ex in examples]
        ctx_texts: List[str] = []
        ctx_dummy: List[bool] = []
        pos_idx: List[int] = []
        scores: List[List[float]] = []
        for ex in examples:
            pos_idx.append(len(ctx_texts))
            ctx_texts.extend(ex.ctx_texts)
            ctx_dummy.extend(ex.ctx_is_dummy)
            scores.append(ex.scores)

        q_ids, q_mask = self.tokenizer(questions, max_seq_len=self.query_max_seq_len)
        c_ids, c_mask = self.tokenizer(ctx_texts, max_seq_len=self.ctx_max_seq_len)
        return {
            "query_ids": q_ids,
            "query_mask": q_mask,
            "contexts_ids": c_ids,
            "contexts_mask": c_mask,
            "pos_ctx_indices": np.asarray(pos_idx, dtype=np.int32),
            "scores": np.asarray(scores, dtype=np.float32),
            "ctx_mask": np.asarray(ctx_dummy, dtype=bool),
        }


class TextBatcher:
    """Tokenize plain text rows (corpus passages / queries) for encoding
    (the passage and query collate paths of
    dpr_scale/datamodule/dpr.py:415-528)."""

    def __init__(self, tokenizer: HFTokenizer, use_title: bool = False, sep_token=None):
        self.tokenizer = tokenizer
        self.use_title = use_title
        self.sep_token = sep_token if sep_token is not None else tokenizer.sep_token

    def passages(self, rows: Sequence[dict]) -> Dict[str, np.ndarray]:
        texts = [
            maybe_add_title(r["text"], r.get("title"), self.use_title, self.sep_token)
            for r in rows
        ]
        ids, mask = self.tokenizer(texts)
        out = {"input_ids": ids, "attention_mask": mask}
        if rows and "id" in rows[0]:
            out["corpus_ids"] = np.asarray([r["id"] for r in rows], dtype=object)
        return out

    def queries(self, rows: Sequence[dict]) -> Dict[str, np.ndarray]:
        texts = [r["question"] for r in rows]
        ids, mask = self.tokenizer(texts)
        return {"input_ids": ids, "attention_mask": mask}
