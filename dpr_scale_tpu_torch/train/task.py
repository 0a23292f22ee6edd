"""DPR bi-encoder training task on one device.

Counterpart of :class:`dpr_scale_tpu.train.task.DenseRetrieverTask`:

    encode queries + contexts (the CLS bi-encoder, or with
    ``encoder_family="splade"`` the SPLADE vocab vectors) -> similarity
    -> masked temperature CE
    -> gradients -> the optimizer (clip, then adamw / adam / lamb / madgrad,
    with or without accumulation) on fp32 master parameters.

The JAX task is functional (a jitted step maps a state to a new one); here
the step updates the model's parameters and the optimizer's state in place
and returns the same state object. The dropout of step ``n`` is a pure
function of ``(dropout_seed, n)`` (:class:`DropoutRng`), as JAX's
``fold_in(dropout_rng, step)`` is. ``grad_cache_chunks > 1`` takes the
gradients by GradCache (:mod:`dpr_scale_tpu_torch.train.gradcache`): the
monolithic step's at the activation memory of one chunk.

Data parallel (:mod:`dpr_scale_tpu_torch.parallel.mesh`): on a batch that is
this rank's slice of the global one (``SHARDED``), the query and context
embeddings of every rank are gathered, this rank's own spliced in with its
graph (reference ``dpr_task.py:163-196``), the loss is the global batch's,
and the ranks' gradients are summed: each rank's step is the
single-process step on the global batch. ``Zero1`` partitions the
optimizer state.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from dpr_scale_tpu_torch.models.convert import init_params
from dpr_scale_tpu_torch.models.encoder import BiEncoder, SpladeBiEncoder
from dpr_scale_tpu_torch.models.transformer import DropoutRng, TransformerConfig
from dpr_scale_tpu_torch.optim.factory import AdamW, Optimizer, global_norm
from dpr_scale_tpu_torch.parallel.mesh import (
    SHARDED,
    ZERO1_KEY,
    all_gather_cat,
    all_reduce_sum,
    gather_splice,
    gather_zero1,
    rank,
    step_dropout_rng,
)
from dpr_scale_tpu_torch.train.gradcache import grad_cache_grads
from dpr_scale_tpu_torch.train.loss import contrastive_loss, rank_metrics

_INT_KEYS = ("query_ids", "query_mask", "contexts_ids", "contexts_mask")


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module  # BiEncoder, SpladeBiEncoder or MultiVecEncoder
    opt_state: Dict
    step: int
    dropout_seed: int

    def state_dict(self) -> Dict:
        """The state as a checkpoint holds it: the fp32 parameters; the
        optimizer's state (:meth:`Optimizer.init`), each per-parameter list
        keyed by the parameter names (the live tensors, not copies), its
        name under ``optimizer`` and its counters as ints; ``step`` and
        ``dropout_seed``. A ZeRO-1 state is gathered whole first (a
        collective: every rank calls this), so that its checkpoint loads at
        any world size."""
        names = [name for name, _ in self.model.named_parameters()]
        params = [p for _, p in self.model.named_parameters()]
        owner = self.opt_state.get(ZERO1_KEY)
        out = {"params": {name: p.detach() for name, p in zip(names, params)}}
        for key, value in self.opt_state.items():
            if key == ZERO1_KEY:
                continue
            if isinstance(value, list) and owner is not None:
                value = gather_zero1(value, owner, params)
            out[key] = dict(zip(names, value)) if isinstance(value, list) else value
        out["step"], out["dropout_seed"] = int(self.step), int(self.dropout_seed)
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Mapping) -> None:
        """Copy a :meth:`state_dict` into this state in place: the tensors
        stay on their device with their dtypes. Raises on another optimizer
        (a state saved without an ``optimizer`` name, the AdamW-only format,
        loads into the adam family), a missing or an unexpected parameter
        name, or a shape that differs."""
        mine = self.opt_state["optimizer"]
        theirs = state.get("optimizer")
        layout = set(self.opt_state) - {"optimizer", ZERO1_KEY}
        if (theirs is None and layout != {"count", "mu", "nu"}) or theirs not in (None, mine):
            raise ValueError(
                f"the checkpoint holds the state of optimizer {theirs or 'adamw'!r}, this "
                f"run's is {mine!r} (task.optim.name, trainer.accumulate_grad_batches)"
            )
        self.model.load_state_dict(state["params"])
        names = [name for name, _ in self.model.named_parameters()]
        owner = self.opt_state.get(ZERO1_KEY)  # ZeRO-1: this rank's entries only
        mine_names = names if owner is None else [n for n, o in zip(names, owner) if o == rank()]
        for key, mine_value in self.opt_state.items():
            if key in ("optimizer", ZERO1_KEY):
                continue
            if not isinstance(mine_value, list):
                self.opt_state[key] = int(state[key])
                continue
            if set(state[key]) != set(names):
                raise KeyError(
                    f"optimizer {key} names differ from the model's: missing "
                    f"{sorted(set(names) - set(state[key]))}, unexpected "
                    f"{sorted(set(state[key]) - set(names))}"
                )
            for name, t in zip(mine_names, mine_value):
                src = state[key][name]
                if src.shape != t.shape:
                    raise ValueError(f"optimizer {key}[{name}]: {tuple(src.shape)} != {tuple(t.shape)}")
                t.copy_(src)
        self.step = int(state["step"])
        self.dropout_seed = int(state["dropout_seed"])


def new_state(model, optimizer: Optimizer, seed: int, state_dict, device) -> TrainState:
    """A fresh state of ``model``: parameters from ``state_dict`` (e.g. the
    output of ``models.convert.from_jax_params``) or the JAX init's
    distributions drawn from ``seed``; zero optimizer moments; step 0."""
    if state_dict is None:
        state_dict = init_params(model, torch.Generator().manual_seed(seed))
    model.load_state_dict(state_dict)
    model.to(device)
    return TrainState(model, optimizer.init(list(model.parameters())), 0, seed)


def batch_to_device(batch: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch from the datamodule -> tensors on ``device`` (pinned,
    non-blocking copies on a GPU), the teacher ``scores`` too where the
    batch has them; a rank's slice of a global batch keeps its ``SHARDED``
    flag."""
    out = {SHARDED: True} if batch.get(SHARDED) else {}
    for key in _INT_KEYS + ("pos_ctx_indices", "ctx_mask", "scores"):
        if key not in batch:
            continue
        t = torch.from_numpy(np.ascontiguousarray(batch[key]))
        if key == "pos_ctx_indices":
            t = t.long()
        if device.type == "cuda":
            t = t.pin_memory()
        out[key] = t.to(device, non_blocking=True)
    return out


def summed_eval(task, state: TrainState, batches: Iterable) -> Dict[str, float]:
    """Epoch metrics of per-batch scoring: ``task.eval_step``'s summed
    counts over ``batches``, as the JAX tasks' ``run_eval`` reports them."""
    totals: Dict[str, float] = {}
    n_batches = 0
    for batch in batches:
        m = task.eval_step(state, task.to_device(batch))
        n_batches += 1
        for key, val in m.items():
            totals[key] = totals.get(key, 0.0) + float(val)
    if not n_batches:
        return {}
    nq = totals["query_count"]
    return {
        "avg_rank": totals["rank_sum"] / nq,
        "mrr": totals["mrr_sum"] / nq,
        f"accuracy@{task.k}": totals["hits_at_k"] / nq,
        "ctx_count": totals["ctx_count"] / n_batches,
        "loss": totals["loss_sum"] / nq,
        "query_count": nq,
    }


@dataclasses.dataclass
class DenseRetrieverTask:
    """Owns the BiEncoder's construction, the optimizer and the steps."""

    cfg: TransformerConfig
    projection_dim: int = 0
    shared_model: bool = True
    softmax_temperature: float = 1.0
    k: int = 1  # accuracy@k
    in_batch_negatives: bool = True
    in_batch_eval: bool = True
    encoder_family: str = "dense"  # "splade": SpladeBiEncoder; else BiEncoder
    optimizer: Optional[Optimizer] = None
    device: torch.device = torch.device("cpu")
    grad_cache_chunks: int = 1

    def __post_init__(self):
        if self.optimizer is None:
            self.optimizer = AdamW(1e-5, weight_decay=1e-4)  # optax.adamw(1e-5)
        self.device = torch.device(self.device)

    def init_state(
        self, seed: int = 0, state_dict: Optional[Mapping[str, torch.Tensor]] = None
    ) -> TrainState:
        """A fresh state: parameters from ``state_dict`` (e.g. the output of
        ``models.convert.from_jax_params``) or the JAX init's distributions
        drawn from ``seed``; zero optimizer moments; step 0."""
        if self.encoder_family == "splade":
            model = SpladeBiEncoder(self.cfg, shared=self.shared_model)
        else:
            model = BiEncoder(
                self.cfg, projection_dim=self.projection_dim, shared=self.shared_model
            )
        return new_state(model, self.optimizer, seed, state_dict, self.device)

    def load_params(self, state: TrainState, state_dict: Mapping[str, torch.Tensor]) -> TrainState:
        """Warm start (``task.pretrained_checkpoint_path``): the parameters
        of ``state_dict`` into ``state``'s model; the optimizer moments and
        the step stay as they are."""
        with torch.no_grad():
            state.model.load_state_dict(state_dict)
        return state

    def to_device(self, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return batch_to_device(batch, self.device)

    def _loss(self, model, batch, rng: Optional[DropoutRng], in_batch_negatives: bool):
        q, c = model(*(batch[k] for k in _INT_KEYS), rng)
        return self._global_loss(q, c, batch, in_batch_negatives)

    def _global_loss(self, q, c, batch, in_batch_negatives: bool):
        """The loss over the global score matrix: a sharded batch's
        embeddings gathered from every rank, this rank's spliced in, and its
        positive indices (which point into the global context list) and
        dummy mask gathered."""
        pos, ctx_mask = batch["pos_ctx_indices"], batch["ctx_mask"]
        if batch.get(SHARDED):
            q, c = gather_splice(q), gather_splice(c)
            pos, ctx_mask = all_gather_cat(pos), all_gather_cat(ctx_mask)
        return contrastive_loss(q, c, pos, ctx_mask, self.softmax_temperature, in_batch_negatives)

    def loss_and_grads(
        self, state: TrainState, batch, rng: Optional[DropoutRng] = None
    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The training loss of ``batch`` and its gradient for each of
        ``state.model.parameters()``, by GradCache when
        ``grad_cache_chunks > 1``; deterministic (no dropout) without
        ``rng``."""
        params = list(state.model.parameters())
        if self.grad_cache_chunks > 1:
            return self._grad_cache(state.model, params, batch, rng)
        loss, _scores = self._loss(state.model, batch, rng, self.in_batch_negatives)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss, [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]

    def _grad_cache(self, model, params, batch, rng: Optional[DropoutRng]):
        """GradCache over ``grad_cache_chunks`` strided chunks, chunk ``g``
        encoded with ``rng.fold(g)`` (the JAX task's ``_grad_cache_grads``)."""

        def encode_chunk(qi, qm, ci, cm, chunk_rng):
            q, c = model(qi, qm, ci, cm, chunk_rng)
            return {"emb": q}, {"emb": c}

        def loss_on_reprs(q_full, c_full):
            loss, _scores = self._global_loss(q_full["emb"], c_full["emb"], batch,
                                              self.in_batch_negatives)
            return loss, {}

        loss, _aux, grads = grad_cache_grads(
            params, batch, rng, self.grad_cache_chunks, encode_chunk, loss_on_reprs
        )
        return loss, grads

    def train_step(self, state: TrainState, batch, epoch: float = 0) -> Tuple[TrainState, Dict]:
        """One step (an update, or with accumulation a micro-step). Metrics
        stay on the device (no host sync): the loss and the PRE-clip global
        norm of this step's gradient. ``epoch`` is unused (the loop passes
        it to every task). A sharded batch (``SHARDED``) gives every rank
        the global batch's loss and, once the ranks' gradients are summed,
        its gradient."""
        sharded = bool(batch.get(SHARDED))
        rng = step_dropout_rng(state.dropout_seed, state.step, self.device, sharded)
        loss, grads = self.loss_and_grads(state, batch, rng)
        if sharded:
            all_reduce_sum(grads)
        params = list(state.model.parameters())
        grad_norm = global_norm(grads)
        self.optimizer.update(params, grads, state.opt_state, grad_norm)
        state.step += 1
        return state, {"train_loss": loss.detach(), "grad_norm": grad_norm}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """Deterministic scoring within the batch, every context visible but
        the dummies; summed metrics, as the JAX eval step returns them."""
        loss, scores = self._loss(state.model, batch, None, True)
        metrics = rank_metrics(scores, batch["pos_ctx_indices"], self.k)
        metrics["loss_sum"] = loss * scores.shape[0]
        metrics["ctx_count"] = scores.shape[1] - batch["ctx_mask"].float().sum()
        return metrics

    def run_eval(self, state: TrainState, batches: Iterable) -> Dict[str, float]:
        """Epoch metrics. ``in_batch_eval``: per-batch scoring, summed counts;
        otherwise every query is ranked against ALL eval contexts."""
        if not self.in_batch_eval:
            return self._run_eval_full(state, batches)
        return summed_eval(self, state, batches)

    @torch.no_grad()
    def _run_eval_full(self, state: TrainState, batches: Iterable) -> Dict[str, float]:
        q_parts, c_parts, labels, masks = [], [], [], []
        offset = 0
        for batch in batches:
            b = self.to_device(batch)
            q, c = state.model(*(b[k] for k in _INT_KEYS))
            q_parts.append(q)
            c_parts.append(c)
            labels.append(b["pos_ctx_indices"] + offset)
            masks.append(b["ctx_mask"])
            offset += c.shape[0]
        if not q_parts:
            return {}
        lab, mask = torch.cat(labels), torch.cat(masks)
        loss, scores = contrastive_loss(
            torch.cat(q_parts), torch.cat(c_parts), lab, mask,
            self.softmax_temperature, True,
        )
        m = rank_metrics(scores, lab, self.k)
        nq = float(m["query_count"])
        return {
            "avg_rank": float(m["rank_sum"]) / nq,
            "mrr": float(m["mrr_sum"]) / nq,
            f"accuracy@{self.k}": float(m["hits_at_k"]) / nq,
            "ctx_count": float(offset) - float(mask.float().sum()),
            "loss": float(loss),
            "query_count": nq,
        }
