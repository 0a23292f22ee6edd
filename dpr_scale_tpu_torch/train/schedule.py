"""LR schedules (counterpart of :mod:`dpr_scale_tpu.train.schedule`).

A schedule is evaluated at the count of updates already applied, as optax
does: the first update uses ``schedule(0)``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np


def linear_warmup_decay(
    base_lr: float, warmup_steps: int, total_steps: int
) -> Callable[[int], float]:
    """Linear warmup to ``base_lr`` over ``warmup_steps``, then linear decay
    to 0 at ``total_steps``; fp32 arithmetic, as the JAX schedule's."""
    f32 = np.float32

    def schedule(step) -> float:
        step = f32(step)
        if step < warmup_steps:
            return float(f32(base_lr) * (step / f32(max(1.0, warmup_steps))))
        decay = (f32(total_steps) - step) / f32(max(1.0, total_steps - warmup_steps))
        return float(f32(base_lr) * max(f32(0.0), decay))

    return schedule
