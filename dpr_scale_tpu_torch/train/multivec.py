"""Multi-vector (CITADEL / COIL / ColBERT) scoring, losses and training task.

Counterpart of :mod:`dpr_scale_tpu.train.multivec` (reference
dpr_scale/task/citadel_task.py), with its names and semantics:

  * ``colbert_score_*``, ``coil_gate_*``, ``citadel_gate_*``: the literal
    token-similarity tensors, (Q, LQ·KQ, C, LC·KC) for CITADEL, as the JAX
    functions build them, and :func:`expert_sim_score_literal`, the JAX
    scorer over them. Over a whole batch the literal form is the tests'
    reference and on no path;
  * :func:`expert_sim_score`: the same (Q, C) / (Q, M) late-interaction
    scores (MaxSim over context tokens and their experts, sum or max over
    query tokens), the literal form applied to blocks of queries and
    contexts whose gated product holds at most ``block`` (default
    :data:`SCORE_BLOCK`) elements.
    Under autograd each block is checkpointed: its forward keeps nothing
    and its backward recomputes the block, so the working memory is a few
    blocks, never the whole product. The max's gradient is split evenly
    among tied maxima (``amax``), as JAX splits it;
  * ``dot_score``, ``distilled_loss``, ``softmax_ce``;
  * :class:`MultiVecRetrieverTask`: the router and expert contrastive
    losses, teacher distillation, in-batch or pairwise blocks, the optional
    CLS score, the load-balancing and L1 regularisers annealed by epoch,
    the routing statistics; GradCache over the encoders' output dicts; data
    parallelism: on a rank's slice of a global batch
    (``parallel.mesh.SHARDED``) every rank gathers the output dicts and
    computes the loss of the global batch, whose routing statistics (the
    usage means of the load loss, ``avg_marg_num_experts``: a max over the
    batch) are the global batch's, and the ranks' gradients are summed.

The JAX package's XLA fuses the gated MaxSim into one reduction; eager
PyTorch would materialise every intermediate of the literal form (10.6 GB
per fp32 tensor at conf/citadel.yaml's training batch, 270 GB at its test
batch), hence the blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from dpr_scale_tpu_torch.models.multivec import MultiVecEncoder
from dpr_scale_tpu_torch.models.transformer import DropoutRng, TransformerConfig, fold
from dpr_scale_tpu_torch.optim.factory import AdamW, Optimizer, global_norm
from dpr_scale_tpu_torch.parallel.mesh import (
    SHARDED,
    all_gather_cat,
    all_reduce_sum,
    gather_splice,
    step_dropout_rng,
)
from dpr_scale_tpu_torch.train.gradcache import grad_cache_grads
from dpr_scale_tpu_torch.train.loss import NEG_INF, rank_metrics
from dpr_scale_tpu_torch.train.task import TrainState, batch_to_device, new_state, summed_eval

# elements of one block's gated product (128 MiB in fp32): the scorer's
# working memory is a few tensors of this size
SCORE_BLOCK = 1 << 25
# sequences a side encoded at once by the evaluation (its batches carry
# num_val_negative / num_test_negative contexts a query)
EVAL_ENCODE_ROWS = 256

# --------------------------------------------------------------------- #
# the literal forms (JAX's functions, transcribed)


def colbert_score_inbatch(q_repr: Dict, c_repr: Dict) -> torch.Tensor:
    """(Q, LQ, C, LC) token-similarity tensor (citadel_task.py:162-166)."""
    return torch.einsum("qld,cmd->qlcm", q_repr["expert_repr"].float(),
                        c_repr["expert_repr"].float())


def colbert_score_pairwise(q_repr: Dict, c_repr: Dict) -> torch.Tensor:
    """(Q, LQ, M, LC) where contexts come in blocks of M per query."""
    Q, _LQ, D = q_repr["expert_repr"].shape
    M = c_repr["expert_repr"].shape[0] // Q
    c = c_repr["expert_repr"].float().reshape(Q, M, -1, D)
    return torch.einsum("qld,qmcd->qlmc", q_repr["expert_repr"].float(), c)


def coil_gate_inbatch(scores, q_repr, c_repr):
    """Zero out token pairs whose token ids differ (citadel_task.py:175-189)."""
    eq = q_repr["expert_ids"][:, :, None, None] == c_repr["expert_ids"][None, None, :, :]
    gate = eq.to(scores.dtype)
    if "expert_weights" in q_repr:
        gate = gate * (q_repr["expert_weights"][:, :, None, None]
                       * c_repr["expert_weights"][None, None, :, :])
    return scores * gate


def coil_gate_pairwise(scores, q_repr, c_repr):
    Q, _LQ = q_repr["expert_ids"].shape
    M = c_repr["expert_ids"].shape[0] // Q
    cids = c_repr["expert_ids"].reshape(Q, M, -1)
    gate = (q_repr["expert_ids"][:, :, None, None] == cids[:, None, :, :]).to(scores.dtype)
    if "expert_weights" in q_repr:
        cw = c_repr["expert_weights"].reshape(Q, M, -1)
        gate = gate * (q_repr["expert_weights"][:, :, None, None] * cw[:, None, :, :])
    return scores * gate  # (Q, LQ, M, LC)


def citadel_gate_inbatch(scores, q_repr, c_repr):
    """Routed-expert gating (citadel_task.py:197-213): scores (Q, LQ, C, LC)
    -> (Q, LQ*KQ, C, LC*KC)."""
    qid, cid = q_repr["expert_ids"], c_repr["expert_ids"]
    eq = qid[:, :, :, None, None, None] == cid[None, None, None, :, :, :]
    w = (q_repr["expert_weights"][:, :, :, None, None, None]
         * c_repr["expert_weights"][None, None, None, :, :, :])
    gate = torch.where(eq, w, torch.zeros((), dtype=w.dtype, device=w.device))
    s = scores[:, :, None, :, :, None] * gate
    Q, LQ, KQ, C, LC, KC = s.shape
    return s.reshape(Q, LQ * KQ, C, LC * KC)


def citadel_gate_pairwise(scores, q_repr, c_repr):
    qid = q_repr["expert_ids"]
    Q, _LQ, _KQ = qid.shape
    M = c_repr["expert_ids"].shape[0] // Q
    cid = c_repr["expert_ids"].reshape(Q, M, -1, c_repr["expert_ids"].shape[-1])
    cw = c_repr["expert_weights"].reshape(Q, M, -1, c_repr["expert_weights"].shape[-1])
    eq = qid[:, None, :, :, None, None] == cid[:, :, None, None, :, :]  # (Q, M, LQ, KQ, LC, KC)
    w = q_repr["expert_weights"][:, None, :, :, None, None] * cw[:, :, None, None, :, :]
    gate = torch.where(eq, w, torch.zeros((), dtype=w.dtype, device=w.device))
    gate = gate.permute(0, 2, 3, 1, 4, 5)  # (Q, LQ, KQ, M, LC, KC)
    s = scores[:, :, None, :, :, None] * gate
    Q, LQ, KQ, M, LC, KC = s.shape
    return s.reshape(Q, LQ * KQ, M, LC * KC)


def _variant(q_repr) -> str:
    ids = q_repr.get("expert_ids")
    if ids is None:
        return "colbert"
    return "citadel" if ids.ndim == 3 else "coil"


def _pool(maxsim, query_pool: str):
    if query_pool == "sum":
        return maxsim.sum(dim=1)
    if query_pool == "max":
        return maxsim.amax(dim=1)
    raise ValueError("query_pool must be sum or max")


def _mask_contexts(scores, ctx_mask, pairwise: bool):
    if ctx_mask is None:
        return scores
    mask2d = ctx_mask.reshape(scores.shape[0], -1) if pairwise else ctx_mask[None, :]
    return scores.masked_fill(mask2d, NEG_INF)


def expert_sim_score_literal(q_repr, c_repr, ctx_mask=None, pairwise=False, query_pool="sum"):
    """The JAX ``expert_sim_score`` transcribed: the whole gated product of
    its inputs at once. :func:`expert_sim_score` calls it on one bounded
    block at a time; over a whole batch it is the tests' reference."""
    variant = _variant(q_repr)
    if pairwise:
        scores = colbert_score_pairwise(q_repr, c_repr)
        gate = {"coil": coil_gate_pairwise, "citadel": citadel_gate_pairwise}.get(variant)
    else:
        scores = colbert_score_inbatch(q_repr, c_repr)
        gate = {"coil": coil_gate_inbatch, "citadel": citadel_gate_inbatch}.get(variant)
    if gate is not None:
        scores = gate(scores, q_repr, c_repr)
    return _mask_contexts(_pool(scores.amax(dim=-1), query_pool), ctx_mask, pairwise)


# --------------------------------------------------------------------- #
# the blocked scorer


def _run_block(query_pool: str, pairwise: bool, q_block: Dict, c_block: Dict):
    """(q, c) pooled scores of one block of queries and contexts: the
    literal form on the block's slices, checkpointed under autograd."""
    leaves = [*q_block.values(), *c_block.values()]
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        return checkpoint(expert_sim_score_literal, q_block, c_block, None, pairwise, query_pool,
                          use_reentrant=False)
    return expert_sim_score_literal(q_block, c_block, None, pairwise, query_pool)


def _rows(repr_: Dict, rows: slice) -> Dict:
    """The scored leaves of ``repr_`` for ``rows``."""
    return {k: repr_[k][rows] for k in ("expert_repr", "expert_ids", "expert_weights")
            if k in repr_}


def expert_sim_score(
    q_repr: Dict,
    c_repr: Dict,
    ctx_mask: Optional[torch.Tensor] = None,
    pairwise: bool = False,
    query_pool: str = "sum",
    block: int = SCORE_BLOCK,
) -> torch.Tensor:
    """Late-interaction score matrix, (Q, C) in-batch or (Q, M) pairwise
    (contexts in blocks of M a query), equal to the JAX function. Each
    block of queries and contexts builds its gated product of at most
    ``block`` elements (one query against one context can exceed it: that
    pair is the smallest block), takes the max over the context tokens and
    their experts and pools over the query tokens; under autograd the
    blocks are checkpointed (module docstring)."""
    Q, LQ = q_repr["expert_repr"].shape[:2]
    C, LC = c_repr["expert_repr"].shape[:2]
    KQ = KC = 1
    if _variant(q_repr) == "citadel":
        KQ, KC = q_repr["expert_ids"].shape[-1], c_repr["expert_ids"].shape[-1]
    if pairwise:
        M = C // Q
        qb = max(1, block // (LQ * KQ * M * LC * KC))
        parts = [_run_block(query_pool, True, _rows(q_repr, slice(lo, lo + qb)),
                            _rows(c_repr, slice(lo * M, (lo + qb) * M)))
                 for lo in range(0, Q, qb)]
        return _mask_contexts(torch.cat(parts, dim=0), ctx_mask, True)

    per_pair = LQ * KQ * LC * KC
    if per_pair * C <= block:
        qb, cb = max(1, block // (per_pair * C)), C
    else:
        qb, cb = 1, max(1, block // per_pair)
    rows = []
    for q0 in range(0, Q, qb):
        q_block = _rows(q_repr, slice(q0, q0 + qb))
        rows.append(torch.cat([_run_block(query_pool, False, q_block,
                                          _rows(c_repr, slice(c0, c0 + cb)))
                               for c0 in range(0, C, cb)], dim=1))
    return _mask_contexts(torch.cat(rows, dim=0), ctx_mask, False)


def dot_score(q, c, ctx_mask=None, pairwise=False):
    """Single-vector similarity (router / CLS), in-batch or block-pairwise
    (citadel_task.py:137-153)."""
    q, c = q.float(), c.float()
    if pairwise:
        M = c.shape[0] // q.shape[0]
        scores = torch.einsum("qd,qmd->qm", q, c.reshape(q.shape[0], M, -1))
    else:
        scores = q @ c.T
    return _mask_contexts(scores, ctx_mask, pairwise)


def distilled_loss(input_logits, target_logits):
    """Soft-label CE (citadel_task.py:240-247), max-shifted for stability."""
    input_logits = input_logits - input_logits.amax(dim=-1, keepdim=True).detach()
    target_logits = target_logits - target_logits.amax(dim=-1, keepdim=True).detach()
    input_probs = torch.softmax(input_logits, dim=-1)
    target_probs = torch.softmax(target_logits, dim=-1)
    return -(target_probs * torch.log(input_probs + 1e-6)).sum(dim=-1).mean()


def softmax_ce(scores, labels):
    logp = torch.log_softmax(scores, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


# --------------------------------------------------------------------- #
# task


def gather_reprs(repr_: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An encoder output dict of a rank's slice made the global batch's:
    float leaves gathered with this rank's part spliced in (so it keeps its
    graph), integer ones gathered; the 0-d routing statistics are dropped
    (:func:`routing_stats` recomputes them from the gathered planes)."""
    return {k: (gather_splice(v) if v.is_floating_point() else all_gather_cat(v))
            for k, v in repr_.items() if v.ndim >= 1}


def routing_stats(repr_: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``repr_`` with ``avg_cond_num_experts`` / ``avg_marg_num_experts``
    computed from its whole ``router_mask`` (the model's formulas): the
    max over the batch is not a combination of per-chunk or per-rank
    values."""
    repr_ = dict(repr_)
    if "router_mask" in repr_:
        rm = repr_["router_mask"]
        repr_["avg_cond_num_experts"] = rm.sum(dim=1).mean()
        repr_["avg_marg_num_experts"] = rm.amax(dim=0).sum()
    return repr_


@dataclasses.dataclass
class MultiVecRetrieverTask:
    """CITADEL / COIL / ColBERT training (reference MultiVecRetrieverTask)
    on the dense task's pattern: the step updates the state in place, the
    dropout of step ``n`` is ``DropoutRng(dropout_seed, n)`` (the query
    tower on its fold 0, the context tower on fold 1; on a sharded batch
    the rank is folded in first), ``grad_cache_chunks > 1`` takes the
    gradients by GradCache, and a sharded batch trains on the global
    batch's loss (module docstring)."""

    cfg: TransformerConfig
    variant: str = "citadel"
    tok_projection_dim: Optional[int] = None
    cls_projection_dim: Optional[int] = None
    add_cls: bool = False
    query_topk: int = 1
    context_topk: int = 1
    shared_model: bool = True  # one encoder for both sides, as in JAX
    query_pool: str = "sum"
    in_batch: bool = True
    k: int = 1
    # regularizer coefficients (citadel_task.py:283-328)
    query_expert_load_loss_coef: float = 0.0
    context_expert_load_loss_coef: float = 0.0
    query_router_marg_load_loss_coef: float = 0.0
    context_router_marg_load_loss_coef: float = 0.0
    anneal_factor: float = 0.0
    teacher_coef: float = 0.0
    tau: float = 1.0
    max_epochs: int = 1
    optimizer: Optional[Optimizer] = None
    device: torch.device = torch.device("cpu")
    grad_cache_chunks: int = 1

    def __post_init__(self):
        if self.optimizer is None:
            self.optimizer = AdamW(1e-5)  # optax.adamw(1e-5)
        self.device = torch.device(self.device)

    def new_model(self) -> MultiVecEncoder:
        return MultiVecEncoder(self.cfg, variant=self.variant,
                               tok_projection_dim=self.tok_projection_dim,
                               cls_projection_dim=self.cls_projection_dim)

    def init_state(
        self, seed: int = 0, state_dict: Optional[Mapping[str, torch.Tensor]] = None
    ) -> TrainState:
        """A fresh state: parameters from ``state_dict`` (e.g.
        ``models.convert.from_jax_params`` of a Flax ``MultiVecEncoder``) or
        the JAX init's distributions drawn from ``seed``; zero optimizer
        moments; step 0."""
        return new_state(self.new_model(), self.optimizer, seed, state_dict, self.device)

    def load_params(self, state: TrainState, state_dict: Mapping[str, torch.Tensor]) -> TrainState:
        """Warm start: the parameters of ``state_dict`` into ``state``'s
        model; the optimizer moments and the step stay as they are."""
        with torch.no_grad():
            state.model.load_state_dict(state_dict)
        return state

    def to_device(self, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return batch_to_device(batch, self.device)

    def _encode(self, model, batch, rng: Optional[DropoutRng]):
        q_repr = model(batch["query_ids"], batch["query_mask"], topk=self.query_topk,
                       add_cls=self.add_cls, rng=fold(rng, 0))
        c_repr = model(batch["contexts_ids"], batch["contexts_mask"], topk=self.context_topk,
                       add_cls=self.add_cls, rng=fold(rng, 1))
        return q_repr, c_repr

    def _anneal(self, loss, epoch):
        if not self.anneal_factor:
            return loss
        return min(1.0, (float(epoch) / self.max_epochs) ** self.anneal_factor) * loss

    def compute_loss(
        self, q_repr, c_repr, ctx_mask, labels, teacher_scores, epoch
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        metrics: Dict[str, torch.Tensor] = {}
        loss = 0.0
        pairwise_mode = not self.in_batch
        block_labels = torch.zeros_like(labels) if pairwise_mode else labels

        if "router_repr" in c_repr:
            router_loss = 0.0
            if 1 - self.teacher_coef > 0:
                rs = dot_score(q_repr["router_repr"], c_repr["router_repr"], ctx_mask,
                               pairwise=pairwise_mode)
                router_loss = softmax_ce(rs, block_labels)
            if self.teacher_coef > 0:
                prs = dot_score(q_repr["router_repr"], c_repr["router_repr"], ctx_mask,
                                pairwise=True)
                router_loss = (1 - self.teacher_coef) * router_loss + self.teacher_coef * \
                    distilled_loss(prs / self.tau, teacher_scores / self.tau)
            metrics["router_loss"] = router_loss
            loss += router_loss

        if "expert_repr" in c_repr:
            expert_loss = 0.0
            if 1 - self.teacher_coef > 0:
                es = expert_sim_score(q_repr, c_repr, ctx_mask, pairwise=pairwise_mode,
                                      query_pool=self.query_pool)
                if "cls_repr" in c_repr and not pairwise_mode:
                    es = es + dot_score(q_repr["cls_repr"], c_repr["cls_repr"], ctx_mask)
                expert_loss = softmax_ce(es, block_labels)
            if self.teacher_coef > 0:
                pes = expert_sim_score(q_repr, c_repr, ctx_mask, pairwise=True,
                                       query_pool=self.query_pool)
                expert_loss = (1 - self.teacher_coef) * expert_loss + self.teacher_coef * \
                    distilled_loss(pes / self.tau, teacher_scores / self.tau)
            metrics["expert_loss"] = expert_loss
            loss += expert_loss

        # load balancing (router_marg): mean usage x mean softmax mass
        for side, repr_, coef in (
            ("query", q_repr, self.query_router_marg_load_loss_coef),
            ("context", c_repr, self.context_router_marg_load_loss_coef),
        ):
            if coef > 0 and "router_mask" in repr_:
                aux = coef * (repr_["router_mask"].mean(dim=0)
                              * repr_["router_softmax_repr"].mean(dim=0)).sum()
                aux = self._anneal(aux, epoch)
                metrics[f"{side}_router_marg_load_loss"] = aux
                loss += aux
        # L1 sparsity on expert weights
        for side, repr_, coef in (
            ("query", q_repr, self.query_expert_load_loss_coef),
            ("context", c_repr, self.context_expert_load_loss_coef),
        ):
            if coef > 0 and "expert_weights" in repr_:
                aux = coef * repr_["expert_weights"].sum(dim=(1, 2)).mean()
                aux = self._anneal(aux, epoch)
                metrics[f"{side}_expert_load_loss"] = aux
                loss += aux

        for side, repr_ in (("query", q_repr), ("context", c_repr)):
            if "avg_cond_num_experts" in repr_:
                metrics[f"avg_{side}_cond_num_experts"] = repr_["avg_cond_num_experts"]
                metrics[f"avg_{side}_marg_num_experts"] = repr_["avg_marg_num_experts"]
        return loss, metrics

    def loss_and_grads(
        self, state: TrainState, batch, rng: Optional[DropoutRng] = None, epoch: float = 0
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], List[torch.Tensor]]:
        """(loss, metrics, the gradient for each of
        ``state.model.parameters()``), by GradCache when
        ``grad_cache_chunks > 1``; deterministic without ``rng``. The dense
        task's returns (loss, gradients): the loss comes first and the
        gradients last in both."""
        model = state.model
        params = list(model.parameters())
        if self.grad_cache_chunks > 1:
            return self._grad_cache(model, params, batch, rng, epoch)
        q_repr, c_repr = self._encode(model, batch, rng)
        loss, metrics = self._global_loss(q_repr, c_repr, batch, epoch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return loss, metrics, grads

    def _global_loss(self, q_repr, c_repr, batch, epoch):
        """``compute_loss`` of the global batch: on a sharded batch the
        output dicts, the positive indices (into the global context list),
        the context mask and the teacher scores gathered from every rank;
        the routing statistics from the whole ``router_mask``."""
        ctx_mask, labels, teacher = batch["ctx_mask"], batch["pos_ctx_indices"], batch["scores"]
        if batch.get(SHARDED):
            q_repr, c_repr = gather_reprs(q_repr), gather_reprs(c_repr)
            ctx_mask, labels, teacher = (all_gather_cat(t) for t in (ctx_mask, labels, teacher))
        return self.compute_loss(routing_stats(q_repr), routing_stats(c_repr), ctx_mask, labels,
                                 teacher, epoch)

    def _grad_cache(self, model, params, batch, rng, epoch):
        """GradCache over ``grad_cache_chunks`` strided chunks (the JAX
        task's ``_grad_cache_grads``): the loss sees the whole (on a sharded
        batch, the global) batch's output dicts, and the routing statistics
        are recomputed from the unchunked ``router_mask``
        (``avg_marg_num_experts`` is a max over the whole batch, so
        per-chunk values cannot be combined)."""

        def encode_chunk(qi, qm, ci, cm, chunk_rng):
            return self._encode(model, {"query_ids": qi, "query_mask": qm,
                                        "contexts_ids": ci, "contexts_mask": cm}, chunk_rng)

        def loss_on_reprs(q_full, c_full):
            return self._global_loss(q_full, c_full, batch, epoch)

        return grad_cache_grads(params, batch, rng, self.grad_cache_chunks, encode_chunk,
                                loss_on_reprs)

    def train_step(self, state: TrainState, batch, epoch: float = 0) -> Tuple[TrainState, Dict]:
        """One step (an update, or with accumulation a micro-step). Metrics
        stay on the device: the loss terms, the routing statistics, the loss
        and the PRE-clip global norm of the gradient. A sharded batch
        (``SHARDED``) gives every rank the global batch's loss and metrics
        and, once the ranks' gradients are summed, its gradient."""
        sharded = bool(batch.get(SHARDED))
        rng = step_dropout_rng(state.dropout_seed, state.step, self.device, sharded)
        loss, metrics, grads = self.loss_and_grads(state, batch, rng, epoch)
        if sharded:
            all_reduce_sum(grads)
        params = list(state.model.parameters())
        grad_norm = global_norm(grads)
        self.optimizer.update(params, grads, state.opt_state, grad_norm)
        state.step += 1
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}
        metrics["train_loss"] = loss.detach()
        metrics["grad_norm"] = grad_norm
        return state, metrics

    def encode_eval(self, model, ids, mask, topk):
        """One side of an evaluation batch, EVAL_ENCODE_ROWS sequences at a
        time, without the training-only routing planes."""
        parts = [model(ids[lo:lo + EVAL_ENCODE_ROWS], mask[lo:lo + EVAL_ENCODE_ROWS], topk=topk,
                       add_cls=self.add_cls, routing_stats=False)
                 for lo in range(0, ids.shape[0], EVAL_ENCODE_ROWS)]
        return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """Deterministic in-batch scoring (expert scores plus the CLS score),
        summed metrics, as the JAX eval step returns them."""
        model = state.model
        q_repr = self.encode_eval(model, batch["query_ids"], batch["query_mask"],
                                   self.query_topk)
        c_repr = self.encode_eval(model, batch["contexts_ids"], batch["contexts_mask"],
                                   self.context_topk)
        scores = expert_sim_score(q_repr, c_repr, batch["ctx_mask"], query_pool=self.query_pool)
        if "cls_repr" in q_repr:
            scores = scores + dot_score(q_repr["cls_repr"], c_repr["cls_repr"], batch["ctx_mask"])
        labels = batch["pos_ctx_indices"]
        metrics = rank_metrics(scores, labels, self.k)
        metrics["loss_sum"] = softmax_ce(scores, labels) * scores.shape[0]
        metrics["ctx_count"] = scores.shape[1] - batch["ctx_mask"].float().sum()
        return metrics

    def run_eval(self, state: TrainState, batches: Iterable) -> Dict[str, float]:
        """Epoch metrics over per-batch scoring, summed counts."""
        return summed_eval(self, state, batches)
