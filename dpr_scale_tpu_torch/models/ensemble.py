"""Ensemble encoders: SPAR's dense + lexical concatenation and DrBoost.

Counterpart of :mod:`dpr_scale_tpu.models.ensemble`:
  * ``SalientPhraseAwareDenseRetrieverTask`` (dpr_scale/task/spar_task.py:25-58):
    two trained bi-encoders; the query vectors concatenated with
    ``lexical_weight`` on the SECOND (lexical) model's queries only; the
    context vectors concatenated unweighted;
  * ``DrBoostTask`` (task/drboost_task.py:22-59): inference-time
    concatenation of N weak encoders' embeddings.

A composition of encoders, not a module of its own: each component keeps its
weights and its forward; the concatenation happens on the embeddings.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


class ConcatEncoders:
    """N bi-encoders -> concatenated embeddings. ``query_weights[i]`` scales
    component i's QUERY embeddings (SPAR: base 1.0, the lexical model
    weighted; DrBoost: all 1.0)."""

    def __init__(self, components: Sequence[torch.nn.Module],
                 query_weights: Optional[Sequence[float]] = None):
        if not components:
            raise ValueError("ConcatEncoders needs at least one encoder")
        self.components = list(components)
        self.query_weights = (list(query_weights) if query_weights is not None
                              else [1.0] * len(self.components))
        if len(self.query_weights) != len(self.components):
            raise ValueError(f"{len(self.query_weights)} query weights for "
                             f"{len(self.components)} encoders")

    @torch.no_grad()
    def encode_queries(self, input_ids, attention_mask=None) -> torch.Tensor:
        outs = []
        for model, w in zip(self.components, self.query_weights):
            emb = model.encode_query(input_ids, attention_mask)
            outs.append(emb * w if w != 1.0 else emb)
        return torch.cat(outs, dim=-1)

    @torch.no_grad()
    def encode_contexts(self, input_ids, attention_mask=None) -> torch.Tensor:
        return torch.cat([m.encode_context(input_ids, attention_mask) for m in self.components],
                         dim=-1)
