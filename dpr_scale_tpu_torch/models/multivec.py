"""Multi-vector / late-interaction encoder family: CITADEL, COIL, ColBERT,
SPLADE.

Counterpart of :mod:`dpr_scale_tpu.models.multivec` (``MLMHead`` and
``MultiVecEncoder``; reference dpr_scale/models/citadel_models/*):

  * citadel (citadel_model.py:46-82): MLM logits -> ``log(1+relu)``
    router; top-k expert routing per token; projected token vectors;
    load-balancing statistics; optional CLS head;
  * coil (coil_model.py:45-61): projected token vectors gated by *lexical*
    exact match — the expert id IS the input token id;
  * colbert (colbert_model.py:37-43): projected token vectors, plain MaxSim;
  * splade (splade_model.py:26-32): ``max_t log(1+relu(logits))``, a
    sparse vocab vector.

The output dicts are the JAX module's: position 0 ([CLS]) dropped from the
token planes, pad positions zeroed (``expert_repr``) or given expert id -1.
Submodules carry the Flax names (``transformer``, ``mlm_head.{transform,
transform_ln,decoder}``, ``tok_project``, ``cls_project``), so
:func:`~dpr_scale_tpu_torch.models.convert.from_jax_params` carries a Flax
``MultiVecEncoder`` tree across unchanged and ``init_params`` seeds it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dpr_scale_tpu_torch.models.transformer import (
    Dense,
    DropoutRng,
    LayerNorm,
    TransformerConfig,
    TransformerEncoder,
)

VARIANTS = ("citadel", "coil", "colbert", "splade")


class MLMHead(nn.Module):
    """BERT MLM head: Dense -> gelu -> LayerNorm -> vocab decoder (untied)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        h = cfg.hidden_size
        self.transform = Dense(h, h, cfg.dtype)
        self.transform_ln = LayerNorm(h, cfg.layer_norm_eps, cfg.dtype)
        self.decoder = Dense(h, cfg.vocab_size, cfg.dtype)

    def forward(self, hidden):
        return self.decoder(self.transform_ln(F.gelu(self.transform(hidden))))


def _saturate(logits, tok_mask):
    """``log1p(relu(logits)) * mask`` on the fp32 logits. Without autograd
    it runs in place: the (B, T, vocab) fp32 plane is ~1 GB at B = 64,
    L = 128, and the router keeps one live copy of it."""
    if torch.is_grad_enabled():
        return torch.log1p(torch.relu(logits)) * tok_mask[..., None]
    return logits.relu_().log1p_().mul_(tok_mask[..., None])


class MultiVecEncoder(nn.Module):
    """Shared trunk for the multi-vector family.

    variant: "citadel" | "coil" | "colbert" | "splade"
    """

    def __init__(
        self,
        cfg: TransformerConfig,
        variant: str = "citadel",
        tok_projection_dim: Optional[int] = None,
        cls_projection_dim: Optional[int] = None,
    ):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
        self.cfg = cfg
        self.variant = variant
        self.tok_projection_dim = tok_projection_dim
        self.cls_projection_dim = cls_projection_dim
        h = cfg.hidden_size
        self.transformer = TransformerEncoder(cfg)
        if variant in ("citadel", "splade"):
            self.mlm_head = MLMHead(cfg)
        if tok_projection_dim and variant in ("citadel", "coil", "colbert"):
            self.tok_project = Dense(h, tok_projection_dim, cfg.dtype)
        if cls_projection_dim:
            self.cls_project = Dense(h, cls_projection_dim, cfg.dtype)

    def _tokens(self, toks, tok_mask):
        expert = toks
        if self.tok_projection_dim:
            expert = self.tok_project(toks).float()
        return expert * tok_mask[..., None]

    def forward(
        self,
        input_ids,
        attention_mask: Optional[torch.Tensor] = None,
        topk: int = 1,
        add_cls: bool = False,
        rng: Optional[DropoutRng] = None,
        routing_stats: bool = True,
    ) -> Dict[str, torch.Tensor]:
        """``routing_stats=False`` (inference) skips the training-only
        CITADEL outputs (router_repr / router_mask / router_softmax_repr,
        each (B, vocab) fp32)."""
        if attention_mask is None:
            attention_mask = (input_ids != self.cfg.pad_token_id).to(torch.int32)
        hidden = self.transformer(input_ids, attention_mask, rng)
        # position 0 is [CLS]; token-level machinery works on positions 1:
        toks = hidden[:, 1:, :].float()
        tok_mask = attention_mask[:, 1:].float()  # (B, T)
        ret: Dict[str, torch.Tensor] = {"attention_mask": tok_mask}

        if add_cls:
            cls = hidden[:, 0, :].float()
            if self.cls_projection_dim:
                cls = self.cls_project(cls).float()
            ret["cls_repr"] = cls

        if self.variant == "splade":
            logits = self.mlm_head(hidden[:, 1:, :]).float()
            ret["splade_repr"] = _saturate(logits, tok_mask).amax(dim=1)  # (B, V)
            return ret

        if self.variant == "colbert":
            ret["expert_repr"] = self._tokens(toks, tok_mask)
            return ret

        if self.variant == "coil":
            ret["expert_repr"] = self._tokens(toks, tok_mask)
            # lexical routing: the expert id IS the token id; pad positions
            # get id -1 so they never exact-match
            ids = input_ids[:, 1:]
            ret["expert_ids"] = torch.where(tok_mask > 0, ids, torch.full_like(ids, -1))
            return ret

        # citadel
        logits = self.mlm_head(hidden[:, 1:, :]).float()  # (B, T, V)
        if routing_stats:
            # before the router overwrites the logits in place
            ret["router_softmax_repr"] = torch.softmax(logits, dim=-1).sum(dim=1)  # (B, V)
        full_router = _saturate(logits, tok_mask)
        del logits
        if routing_stats:
            ret["router_repr"] = full_router.amax(dim=1)  # (B, V)
        expert_weights, expert_ids = torch.topk(full_router, topk, dim=-1)  # (B, T, K)
        del full_router
        # pad positions: weights are already 0 there; give ids -1 so they
        # never match real experts
        expert_ids = torch.where(
            tok_mask[..., None] > 0, expert_ids, torch.full_like(expert_ids, -1)
        ).to(torch.int32)
        ret["expert_weights"] = expert_weights
        ret["expert_ids"] = expert_ids
        ret["expert_repr"] = self._tokens(toks, tok_mask)

        if not routing_stats:
            return ret
        # routing statistics (citadel_model.py:62-73): a scatter-add instead
        # of a (B, T, K, V) one-hot keeps memory at (B, V)
        B = expert_ids.shape[0]
        active = (expert_weights > 0.0).float()  # (B, T, K)
        safe_ids = torch.where(expert_ids < 0, torch.zeros_like(expert_ids), expert_ids)
        router_mask = torch.zeros(B, self.cfg.vocab_size, device=active.device).scatter_add_(
            1, safe_ids.reshape(B, -1).long(), active.reshape(B, -1)
        )
        ret["router_mask"] = router_mask
        ret["avg_cond_num_experts"] = router_mask.sum(dim=1).mean()
        ret["avg_marg_num_experts"] = router_mask.amax(dim=0).sum()
        return ret
