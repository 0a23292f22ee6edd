"""Optimizer registry (counterpart of :mod:`dpr_scale_tpu.optim.factory`).

``adamw`` and ``adam`` follow optax's update rule term by term, on fp32
master parameters, in place:

    g      <- clip_by_global_norm(g)       (optional, optax's formula)
    mu     <- (1 - b1) g + b1 mu,   nu <- (1 - b2) g^2 + b2 nu,   count += 1
    u      <- (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
    u      <- u + weight_decay * p                          (adamw only)
    p      <- p - lr(updates applied so far) * u

The clip scales by ``max_norm / g_norm`` only when ``g_norm >= max_norm``
(optax; ``torch.nn.utils.clip_grad_norm_`` would add 1e-6 to the norm), and
decides on the device, so a step needs no host sync. ``lamb``, ``madgrad``
and gradient accumulation are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class AdamW:
    """optax ``chain(clip_by_global_norm, adamw | adam)`` on a list of fp32
    parameters; the state is a dict, so a step is a pure function of
    (params, grads, state) apart from the in-place updates."""

    def __init__(
        self,
        learning_rate: Union[float, Callable[[int], float]],
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        grad_clip_norm: Optional[float] = None,
    ):
        self.schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm

    def init(self, params: List[torch.Tensor]) -> Dict:
        return {
            "count": 0,
            "mu": [torch.zeros_like(p) for p in params],
            "nu": [torch.zeros_like(p) for p in params],
        }

    @torch.no_grad()
    def update(
        self,
        params: List[torch.Tensor],
        grads: List[torch.Tensor],
        state: Dict,
        g_norm: Optional[torch.Tensor] = None,
    ) -> None:
        """One update of ``params`` in place; ``grads`` are consumed (scaled
        in place by the clip). ``g_norm``: their global norm, if known."""
        if self.grad_clip_norm:
            g_norm = global_norm(grads) if g_norm is None else g_norm
            trigger = g_norm < self.grad_clip_norm
            one = torch.ones((), device=g_norm.device)
            torch._foreach_div_(grads, torch.where(trigger, one, g_norm))
            torch._foreach_mul_(grads, torch.where(trigger, one, one * self.grad_clip_norm))
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        lr = self.schedule(state["count"])
        state["count"] += 1
        count = state["count"]
        # bias corrections in fp32, as optax computes them
        one, n = np.float32(1.0), np.float32(count)
        mu_hat = torch._foreach_div(mu, float(one - np.float32(self.b1) ** n))
        denom = torch._foreach_div(nu, float(one - np.float32(self.b2) ** n))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(mu_hat, params, alpha=self.weight_decay)
        torch._foreach_add_(params, mu_hat, alpha=-lr)


def make_optimizer(
    name: str = "adamw",
    learning_rate: Union[float, Callable[[int], float]] = 1e-5,
    weight_decay: float = 0.0,
    betas=(0.9, 0.999),
    eps: Optional[float] = None,
    grad_clip_norm: Optional[float] = None,
    accumulate_steps: int = 1,
) -> AdamW:
    name = name.lower()
    if name in ("lamb", "madgrad"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (queued in ROADMAP.md); "
            "use task.optim.name=adamw"
        )
    if name not in ("adamw", "adam"):
        raise ValueError(f"unknown optimizer {name!r}")
    if accumulate_steps > 1:
        raise NotImplementedError(
            "trainer.accumulate_grad_batches > 1 is not ported yet (queued in "
            "ROADMAP.md)"
        )
    return AdamW(
        learning_rate,
        b1=betas[0],
        b2=betas[1],
        eps=1e-8 if eps is None else eps,
        weight_decay=weight_decay if name == "adamw" else 0.0,
        grad_clip_norm=grad_clip_norm,
    )
