"""DPR bi-encoder training task on one device.

Counterpart of :class:`dpr_scale_tpu.train.task.DenseRetrieverTask`:

    encode queries + contexts -> similarity -> masked temperature CE
    -> gradients -> clip -> AdamW on fp32 master parameters.

The JAX task is functional (a jitted step maps a state to a new one); here
the step updates the model's parameters and the optimizer's moments in place
and returns the same state object. The dropout of step ``n`` is a pure
function of ``(dropout_seed, n)`` (:class:`DropoutRng`), as JAX's
``fold_in(dropout_rng, step)`` is. Single device only: the multi-GPU global
batch (all_gather of contexts) and GradCache are ROADMAP.md A5 and A6.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from dpr_scale_tpu_torch.models.convert import init_params
from dpr_scale_tpu_torch.models.encoder import BiEncoder
from dpr_scale_tpu_torch.models.transformer import REMAT_REFUSAL, DropoutRng, TransformerConfig
from dpr_scale_tpu_torch.optim.factory import AdamW, global_norm
from dpr_scale_tpu_torch.train.loss import contrastive_loss, rank_metrics

_INT_KEYS = ("query_ids", "query_mask", "contexts_ids", "contexts_mask")


@dataclasses.dataclass
class TrainState:
    model: BiEncoder
    opt_state: Dict
    step: int
    dropout_seed: int


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
    encoder_family: str = "dense"
    optimizer: Optional[AdamW] = None
    device: torch.device = torch.device("cpu")
    grad_cache_chunks: int = 1

    def __post_init__(self):
        if self.encoder_family != "dense":
            raise NotImplementedError(
                f"encoder_family={self.encoder_family!r} is not ported yet; the "
                "port trains the dense CLS bi-encoder"
            )
        if self.cfg.remat:  # training takes gradients
            raise NotImplementedError(REMAT_REFUSAL)
        if self.grad_cache_chunks > 1:
            raise NotImplementedError(
                "task.grad_cache_chunks > 1 (GradCache) is not ported yet "
                "(ROADMAP.md A6)"
            )
        if self.optimizer is None:
            self.optimizer = AdamW(1e-5, weight_decay=1e-4)  # optax.adamw(1e-5)
        self.device = torch.device(self.device)

    def init_state(
        self, seed: int = 0, state_dict: Optional[Mapping[str, torch.Tensor]] = None
    ) -> TrainState:
        """A fresh state: parameters from ``state_dict`` (e.g. the output of
        ``models.convert.from_jax_params``) or the JAX init's distributions
        drawn from ``seed``; zero optimizer moments; step 0."""
        model = BiEncoder(
            self.cfg, projection_dim=self.projection_dim, shared=self.shared_model
        )
        if state_dict is None:
            state_dict = init_params(model, torch.Generator().manual_seed(seed))
        model.load_state_dict(state_dict)
        model.to(self.device)
        params = list(model.parameters())
        return TrainState(model, self.optimizer.init(params), 0, seed)

    def to_device(self, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A numpy batch from the datamodule -> tensors on the task's device
        (pinned, non-blocking copies on a GPU)."""
        out = {}
        for key in _INT_KEYS + ("pos_ctx_indices", "ctx_mask"):
            t = torch.from_numpy(np.ascontiguousarray(batch[key]))
            if key == "pos_ctx_indices":
                t = t.long()
            if self.device.type == "cuda":
                t = t.pin_memory()
            out[key] = t.to(self.device, non_blocking=True)
        return out

    def _loss(self, model, batch, rng: Optional[DropoutRng], in_batch_negatives: bool):
        q, c = model(*(batch[k] for k in _INT_KEYS), rng)
        return contrastive_loss(
            q, c, batch["pos_ctx_indices"], batch["ctx_mask"],
            self.softmax_temperature, in_batch_negatives,
        )

    def loss_and_grads(
        self, state: TrainState, batch, rng: Optional[DropoutRng] = None
    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The training loss of ``batch`` and its gradient for each of
        ``state.model.parameters()``; deterministic (no dropout) without
        ``rng``."""
        loss, _scores = self._loss(state.model, batch, rng, self.in_batch_negatives)
        params = list(state.model.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss, [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]

    def train_step(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        """One update. Metrics stay on the device (no host sync): the loss
        and the PRE-clip global gradient norm."""
        rng = DropoutRng(state.dropout_seed, state.step, self.device)
        loss, grads = self.loss_and_grads(state, batch, rng)
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
        totals: Dict[str, float] = {}
        n_batches = 0
        for batch in batches:
            m = self.eval_step(state, self.to_device(batch))
            n_batches += 1
            for key, val in m.items():
                totals[key] = totals.get(key, 0.0) + float(val)
        if not n_batches:
            return {}
        nq = totals["query_count"]
        return {
            "avg_rank": totals["rank_sum"] / nq,
            "mrr": totals["mrr_sum"] / nq,
            f"accuracy@{self.k}": totals["hits_at_k"] / nq,
            "ctx_count": totals["ctx_count"] / n_batches,
            "loss": totals["loss_sum"] / nq,
            "query_count": nq,
        }

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
