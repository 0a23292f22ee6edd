"""Training loop driver (counterpart of :class:`dpr_scale_tpu.train.loop.Trainer`):
epochs of train steps, ``max_steps``, periodic metrics, validation each
epoch (and every ``eval_every_steps``) with a checkpoint save, and a final
test of the best checkpoint.

A state restored at step ``n`` continues the schedule: completed epochs are
skipped, and an epoch left in the middle resumes at its next batch through
the datamodule's ``start_batch=`` (batches are pure functions of seed,
epoch and position, so the batches are those of an unbroken run).
``profile_dir`` records ``fit`` in a torch.profiler trace
(:func:`~dpr_scale_tpu_torch.utils.profiling.trace_if`). Each step gets
its epoch as a float, as in JAX: the multi-vector task anneals its
regularisers by it.

In a data-parallel run (:mod:`dpr_scale_tpu_torch.parallel`) every rank
builds the same global batches and trains on its contiguous slice of each
(``shard_batch``); validation runs whole on every rank (the same metrics
everywhere). Rank 0 alone logs, saves checkpoints (every rank takes part in
gathering a ZeRO-1 state first) and runs the test.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from dpr_scale_tpu_torch.parallel.mesh import SHARDED, is_main, shard_batch, world_size
from dpr_scale_tpu_torch.train.checkpoint import CheckpointManager
from dpr_scale_tpu_torch.train.task import TrainState
from dpr_scale_tpu_torch.utils.logging import MetricLogger
from dpr_scale_tpu_torch.utils.profiling import trace_if


class Trainer:
    def __init__(
        self,
        task,  # DenseRetrieverTask or MultiVecRetrieverTask
        datamodule,
        checkpoint: Optional[CheckpointManager] = None,
        max_epochs: int = 1,
        max_steps: Optional[int] = None,
        log_every: int = 10,
        eval_every_steps: Optional[int] = None,
        logger: Optional[MetricLogger] = None,
        profile_dir: Optional[str] = None,
    ):
        self.task = task
        self.dm = datamodule
        self.checkpoint = checkpoint
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.log_every = log_every
        self.eval_every_steps = eval_every_steps
        self.log = logger or MetricLogger()
        self.profile_dir = profile_dir
        self._last_validated_step = -1

    def fit(self, state: TrainState) -> TrainState:
        with trace_if(self.profile_dir):
            return self._fit(state)

    def _fit(self, state: TrainState) -> TrainState:
        global_step = state.step
        if self.max_steps and global_step >= self.max_steps:
            return state  # a resumed run that had finished trains no further
        steps_per_epoch = self.dm.steps_per_epoch()
        start_epoch = (
            min(global_step // steps_per_epoch, self.max_epochs) if steps_per_epoch else 0
        )
        skip = global_step - start_epoch * steps_per_epoch
        t0 = time.time()
        examples = 0
        for epoch in range(start_epoch, self.max_epochs):
            batches, skip = self.dm.train_batches(epoch, start_batch=skip), 0
            for batch in batches:
                examples += len(batch.get("pos_ctx_indices", batch["query_ids"]))
                local, sharded = shard_batch(batch)
                if sharded:
                    local[SHARDED] = True
                state, metrics = self.task.train_step(
                    state, self.task.to_device(local), float(epoch)
                )
                global_step += 1
                if global_step % self.log_every == 0 and is_main():
                    scalars = {
                        "train_loss": float(metrics["train_loss"]),
                        "grad_norm": float(metrics["grad_norm"]),
                    }  # float() syncs: the rate below covers finished steps
                    scalars["queries_per_s"] = examples / max(time.time() - t0, 1e-9)
                    # the LR of the last update applied (count - 1)
                    scalars["lr"] = self.task.optimizer.applied_lr(state.opt_state)
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
            return {}  # eval_every_steps on an epoch's end: one save a step
        self._last_validated_step = step
        metrics = self.task.run_eval(state, self.dm.val_batches())
        if metrics and is_main():
            self.log.scalars(step, {f"valid_{k}": v for k, v in metrics.items()})
        if self.checkpoint is not None and world_size() == 1:
            self.checkpoint.save(step, state, metrics or {})
        elif self.checkpoint is not None:
            snapshot = state.state_dict()  # every rank: gathers a ZeRO-1 state
            if is_main():
                self.checkpoint.save(step, snapshot, metrics or {})
        return metrics

    def test(self, state: TrainState, restore_best: bool = True) -> Dict[str, float]:
        """Test metrics of the best checkpoint, restored into ``state`` in
        place (of ``state`` itself without a checkpoint, or with
        ``restore_best=False``). Rank 0 alone: the others return {}."""
        if not is_main():
            return {}
        if restore_best and self.checkpoint is not None and self.checkpoint.best_step() is not None:
            state = self.checkpoint.restore(state)
        metrics = self.task.run_eval(state, self.dm.test_batches())
        if metrics:
            self.log.scalars(state.step, {f"test_{k}": v for k, v in metrics.items()})
        return metrics
