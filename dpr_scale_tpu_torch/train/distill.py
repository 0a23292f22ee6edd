"""Embedding distillation on one device: a student query encoder regresses
onto teacher vectors (the reference's DPRDistillTask,
dpr_scale/task/dpr_distill_task.py).

Counterpart of :class:`dpr_scale_tpu.train.distill.DPRDistillTask`: the
training loss is the MSE of ``DenseEncoder``'s output onto the batch's
``target_vectors`` (:158-169); evaluation ranks ``pred . targets^T``
against ``arange`` (each row's own target is its gold) with
:func:`~dpr_scale_tpu_torch.train.loss.rank_metrics` (:171-194). The step
updates the state in place, as the dense task's does; the dropout of step
``n`` is a pure function of ``(dropout_seed, n)``. On a rank's slice of a
global batch (``parallel.mesh.SHARDED``) the predictions and targets of
every rank are gathered (this rank's predictions spliced in with their
graph), the loss is the global batch's and the ranks' gradients are
summed, as in the dense task.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from dpr_scale_tpu_torch.models.encoder import DenseEncoder
from dpr_scale_tpu_torch.models.transformer import DropoutRng, TransformerConfig
from dpr_scale_tpu_torch.optim.factory import AdamW, Optimizer, global_norm
from dpr_scale_tpu_torch.parallel.mesh import (
    SHARDED,
    all_gather_cat,
    all_reduce_sum,
    gather_splice,
    step_dropout_rng,
)
from dpr_scale_tpu_torch.train.loss import rank_metrics
from dpr_scale_tpu_torch.train.task import TrainState, new_state, summed_eval


@dataclasses.dataclass
class DPRDistillTask:
    cfg: TransformerConfig
    projection_dim: int = 0
    k: int = 1  # accuracy@k
    optimizer: Optional[Optimizer] = None
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        if self.optimizer is None:
            self.optimizer = AdamW(1e-5, weight_decay=1e-4)  # optax.adamw(1e-5)
        self.device = torch.device(self.device)

    def init_state(
        self, seed: int = 0, state_dict: Optional[Mapping[str, torch.Tensor]] = None
    ) -> TrainState:
        """A fresh state of the student ``DenseEncoder``: parameters from
        ``state_dict`` (e.g. ``models.convert.from_jax_params`` of the Flax
        ``DenseEncoder``) or the JAX init's distributions drawn from
        ``seed``; zero optimizer moments; step 0."""
        model = DenseEncoder(self.cfg, projection_dim=self.projection_dim)
        return new_state(model, self.optimizer, seed, state_dict, self.device)

    def load_params(self, state: TrainState, state_dict: Mapping[str, torch.Tensor]) -> TrainState:
        with torch.no_grad():
            state.model.load_state_dict(state_dict)
        return state

    def to_device(self, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {SHARDED: True} if batch.get(SHARDED) else {}
        for key in ("query_ids", "query_mask", "target_vectors"):
            t = torch.from_numpy(np.ascontiguousarray(batch[key]))
            if self.device.type == "cuda":
                t = t.pin_memory()
            out[key] = t.to(self.device, non_blocking=True)
        return out

    def loss_and_grads(self, state: TrainState, batch, rng: Optional[DropoutRng] = None):
        """The MSE of ``batch`` and its gradient for each of
        ``state.model.parameters()``; deterministic without ``rng``."""
        params = list(state.model.parameters())
        pred = state.model(batch["query_ids"], batch["query_mask"], rng)
        targets = batch["target_vectors"]
        if batch.get(SHARDED):
            pred, targets = gather_splice(pred), all_gather_cat(targets)
        loss = torch.mean((pred - targets) ** 2)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss, [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]

    def train_step(self, state: TrainState, batch, epoch: float = 0) -> Tuple[TrainState, Dict]:
        """One step; the loss and the PRE-clip global norm of its gradient
        stay on the device. ``epoch`` is unused."""
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
        """In-batch target ranking, summed metrics, as the JAX eval step
        returns them."""
        pred = state.model(batch["query_ids"], batch["query_mask"])
        targets = batch["target_vectors"]
        scores = torch.matmul(pred.float(), targets.float().T)
        labels = torch.arange(targets.shape[0], device=targets.device)
        metrics = rank_metrics(scores, labels, self.k)
        metrics["loss_sum"] = torch.mean((pred - targets) ** 2) * pred.shape[0]
        metrics["ctx_count"] = torch.tensor(float(targets.shape[0]), device=targets.device)
        return metrics

    def run_eval(self, state: TrainState, batches: Iterable) -> Dict[str, float]:
        return summed_eval(self, state, batches)
