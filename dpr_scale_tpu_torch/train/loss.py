"""Contrastive in-batch-negative loss + ranking metrics.

Counterpart of :mod:`dpr_scale_tpu.train.loss`, with the same semantics:

* :func:`similarity_scores` — ``Q @ C^T`` in fp32, dummy contexts driven to
  ``NEG_INF`` (a large finite value, so softmax and its gradient stay
  NaN-free);
* :func:`contrastive_loss` — temperature-scaled softmax cross-entropy against
  the positive-context index; without in-batch negatives each query sees
  only its own context block (:func:`_block_mask`);
* :func:`rank_metrics` — summed gold rank / MRR / accuracy@k with
  stable-sort tie semantics.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

NEG_INF = -1e30  # large-finite stand-in for -inf: keeps softmax/grad NaN-free


def similarity_scores(query_repr, context_repr, ctx_mask: Optional[torch.Tensor] = None):
    """(B, D) x (C, D) -> (B, C) fp32 scores; ``ctx_mask`` (C,) True = dummy."""
    scores = torch.matmul(query_repr.float(), context_repr.float().T)
    if ctx_mask is not None:
        scores = scores.masked_fill(ctx_mask[None, :], NEG_INF)
    return scores


def _block_mask(n_query: int, n_ctx: int, pos_ctx_indices, ctx_mask):
    """(B, C) True = masked: everything outside each query's own ctx block,
    plus dummies inside it."""
    ctx_per_query = n_ctx // n_query
    ctx_ids = torch.arange(n_ctx, device=pos_ctx_indices.device)[None, :]
    block_lo = pos_ctx_indices[:, None]
    in_block = (ctx_ids >= block_lo) & (ctx_ids < block_lo + ctx_per_query)
    return ~in_block | ctx_mask[None, :]


def contrastive_loss(
    query_repr,
    context_repr,
    pos_ctx_indices,
    ctx_mask,
    softmax_temperature: float = 1.0,
    in_batch_negatives: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (mean CE loss over queries, the (B, C) masked score matrix)."""
    if in_batch_negatives:
        masked = similarity_scores(query_repr, context_repr, ctx_mask)
    else:
        scores = similarity_scores(query_repr, context_repr)
        qc_mask = _block_mask(
            query_repr.shape[0], context_repr.shape[0], pos_ctx_indices, ctx_mask
        )
        masked = scores.masked_fill(qc_mask, NEG_INF)
    masked = masked / softmax_temperature
    log_probs = torch.log_softmax(masked, dim=-1)
    gold = log_probs.gather(1, pos_ctx_indices.long()[:, None])[:, 0]
    return -gold.mean(), masked


def rank_metrics(scores, pos_ctx_indices, k: int = 1) -> Dict[str, torch.Tensor]:
    """Summed (not averaged) rank / mrr / accuracy@k; the descending rank of
    the gold context is 1 + #strictly-higher + #ties at earlier positions."""
    pos_ctx_indices = pos_ctx_indices.long()
    gold = scores.gather(1, pos_ctx_indices[:, None])
    pos = torch.arange(scores.shape[1], device=scores.device)[None, :]
    earlier_tie = (scores == gold) & (pos < pos_ctx_indices[:, None])
    rank = 1 + (scores > gold).sum(dim=1) + earlier_tie.sum(dim=1)
    return {
        "rank_sum": rank.sum().float(),
        "mrr_sum": (1.0 / rank.float()).sum(),
        "hits_at_k": (rank <= k).sum().float(),
        "query_count": torch.tensor(float(scores.shape[0]), device=scores.device),
    }
