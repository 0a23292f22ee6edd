"""Training loop driver (counterpart of :class:`dpr_scale_tpu.train.loop.Trainer`):
epochs of train steps, ``max_steps``, periodic metrics, validation each
epoch (and every ``eval_every_steps``), and a final test.

No checkpoint manager yet (ROADMAP.md A3): ``test`` evaluates the state it
is given.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from dpr_scale_tpu_torch.utils.logging import MetricLogger
from dpr_scale_tpu_torch.train.task import DenseRetrieverTask, TrainState


class Trainer:
    def __init__(
        self,
        task: DenseRetrieverTask,
        datamodule,
        max_epochs: int = 1,
        max_steps: Optional[int] = None,
        log_every: int = 10,
        eval_every_steps: Optional[int] = None,
        logger: Optional[MetricLogger] = None,
    ):
        self.task = task
        self.dm = datamodule
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.log_every = log_every
        self.eval_every_steps = eval_every_steps
        self.log = logger or MetricLogger()
        self._last_validated_step = -1

    def fit(self, state: TrainState) -> TrainState:
        global_step = state.step
        t0 = time.time()
        examples = 0
        for epoch in range(self.max_epochs):
            for batch in self.dm.train_batches(epoch):
                examples += len(batch["pos_ctx_indices"])
                state, metrics = self.task.train_step(state, self.task.to_device(batch))
                global_step += 1
                if global_step % self.log_every == 0:
                    scalars = {
                        "train_loss": float(metrics["train_loss"]),
                        "grad_norm": float(metrics["grad_norm"]),
                    }  # float() syncs: the rate below covers finished steps
                    scalars["queries_per_s"] = examples / max(time.time() - t0, 1e-9)
                    # the LR of the update just applied (count - 1)
                    scalars["lr"] = float(self.task.optimizer.schedule(global_step - 1))
                    self.log.scalars(global_step, scalars)
                    t0, examples = time.time(), 0
                if self.eval_every_steps and global_step % self.eval_every_steps == 0:
                    self._validate(state, global_step)
                if self.max_steps and global_step >= self.max_steps:
                    self._validate(state, global_step)
                    return state
            self._validate(state, global_step)
        return state

    def _validate(self, state: TrainState, step: int) -> Dict[str, float]:
        if step == self._last_validated_step:
            return {}
        self._last_validated_step = step
        metrics = self.task.run_eval(state, self.dm.val_batches())
        if metrics:
            self.log.scalars(step, {f"valid_{k}": v for k, v in metrics.items()})
        return metrics

    def test(self, state: TrainState) -> Dict[str, float]:
        metrics = self.task.run_eval(state, self.dm.test_batches())
        if metrics:
            self.log.scalars(state.step, {f"test_{k}": v for k, v in metrics.items()})
        return metrics
