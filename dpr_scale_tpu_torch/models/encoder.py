"""Dense retrieval encoders: CLS pooling + optional projection head.

Counterpart of :mod:`dpr_scale_tpu.models.encoder` (``DenseEncoder``,
``BiEncoder`` and ``SpladeBiEncoder``); ``projection_dim == -1`` projects
to the hidden size. A
forward given a :class:`~dpr_scale_tpu_torch.models.transformer.DropoutRng`
runs in training mode (dropout on), otherwise it is deterministic; the
query tower draws from ``rng.fold(0)``, the context tower from
``rng.fold(1)``, so a shared trunk draws other masks for each.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dpr_scale_tpu_torch.models.transformer import (
    Dense,
    DropoutRng,
    LayerNorm,
    TransformerConfig,
    TransformerEncoder,
    fold,
)
from dpr_scale_tpu_torch.models.multivec import MultiVecEncoder


class DenseEncoder(nn.Module):
    """Token ids -> one fp32 embedding per sequence (B, D)."""

    def __init__(self, cfg: TransformerConfig, projection_dim: int = 0):
        super().__init__()
        self.cfg = cfg
        self.transformer = TransformerEncoder(cfg)
        self.projection_dim = projection_dim
        if projection_dim:
            dim = cfg.hidden_size if projection_dim == -1 else projection_dim
            self.project = Dense(cfg.hidden_size, dim, cfg.dtype)
            self.project_ln = LayerNorm(dim, cfg.layer_norm_eps, cfg.dtype)

    def forward(
        self,
        input_ids,
        attention_mask: Optional[torch.Tensor] = None,
        rng: Optional[DropoutRng] = None,
    ):
        pooled = self.transformer(input_ids, attention_mask, rng)[:, 0]  # [CLS]
        if self.projection_dim:
            pooled = self.project_ln(self.project(pooled))
        # embeddings leave the encoder in fp32, as the MIPS index expects
        return pooled.float()


class BiEncoder(nn.Module):
    """Query + context towers, optionally weight-shared."""

    def __init__(
        self,
        cfg: TransformerConfig,
        projection_dim: int = 0,
        shared: bool = True,
        query_cfg: Optional[TransformerConfig] = None,
    ):
        super().__init__()
        self.shared = shared
        self.context_encoder = DenseEncoder(cfg, projection_dim)
        if not shared:
            self.query_encoder = DenseEncoder(query_cfg or cfg, projection_dim)

    def encode_query(self, input_ids, attention_mask=None, rng=None):
        enc = self.context_encoder if self.shared else self.query_encoder
        return enc(input_ids, attention_mask, rng)

    def encode_context(self, input_ids, attention_mask=None, rng=None):
        return self.context_encoder(input_ids, attention_mask, rng)

    def forward(self, query_ids, query_mask, contexts_ids, contexts_mask, rng=None):
        return (
            self.encode_query(query_ids, query_mask, fold(rng, 0)),
            self.encode_context(contexts_ids, contexts_mask, fold(rng, 1)),
        )


class SpladeBiEncoder(nn.Module):
    """SPLADE as a single-vector bi-encoder: the ``max log(1+relu(MLM))``
    vocab vector (reference SPLADEEncoder, splade_model.py:26-32) behind
    BiEncoder's interface, so the dense task, the corpus encoder and the
    MIPS index take it unchanged (the "sparse" vector is a dense (B, V)
    tensor). Parameter names are the Flax module's
    (``context_encoder.{transformer,mlm_head}``, ``query_encoder`` when not
    shared)."""

    def __init__(self, cfg: TransformerConfig, shared: bool = True):
        super().__init__()
        self.shared = shared
        self.context_encoder = MultiVecEncoder(cfg, variant="splade")
        if not shared:
            self.query_encoder = MultiVecEncoder(cfg, variant="splade")

    def encode_query(self, input_ids, attention_mask=None, rng=None):
        enc = self.context_encoder if self.shared else self.query_encoder
        return enc(input_ids, attention_mask, rng=rng)["splade_repr"]

    def encode_context(self, input_ids, attention_mask=None, rng=None):
        return self.context_encoder(input_ids, attention_mask, rng=rng)["splade_repr"]

    def forward(self, query_ids, query_mask, contexts_ids, contexts_mask, rng=None):
        return (
            self.encode_query(query_ids, query_mask, fold(rng, 0)),
            self.encode_context(contexts_ids, contexts_mask, fold(rng, 1)),
        )
