"""Optimizer registry (counterpart of :mod:`dpr_scale_tpu.optim.factory`).

Every optimizer follows its optax counterpart term by term, on fp32 master
parameters, in place. ``adamw`` and ``adam``:

    g      <- clip_by_global_norm(g)       (optional, optax's formula)
    mu     <- (1 - b1) g + b1 mu,   nu <- (1 - b2) g^2 + b2 nu,   count += 1
    u      <- (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
    u      <- u + weight_decay * p                          (adamw only)
    p      <- p - lr(updates applied so far) * u

``lamb`` (``optax.lamb``) takes the same ``u`` with the weight decay, then
scales each parameter's ``u`` by the trust ratio ``||p|| / ||u||`` (1
where either norm is 0). ``madgrad`` is :mod:`.madgrad`.
``accumulate_steps > 1`` wraps the optimizer in :class:`MultiSteps`
(``optax.MultiSteps``): the clip and the update run on the mean of every
``k`` gradients, so the optimizer's ``count``, and with it the learning-rate
schedule, advances once per ``k`` steps.

The clip scales by ``max_norm / g_norm`` only when ``g_norm >= max_norm``
(optax; ``torch.nn.utils.clip_grad_norm_`` would add 1e-6 to the norm), and
decides on the device, so a step needs no host sync.

An optimizer's state is a dict (:meth:`Optimizer.init`): its ``name`` under
``optimizer``, int counters, and per-parameter lists of tensors, which a
checkpoint keys by parameter name (``TrainState.state_dict``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

Schedule = Union[float, Callable[[int], float]]


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """optax ``chain(clip_by_global_norm, <optimizer>)`` on a list of fp32
    parameters. A subclass names its per-parameter state lists in
    ``trees`` and does the update in :meth:`_apply`; a step is a pure
    function of (params, grads, state) apart from the in-place updates."""

    name = ""
    trees: tuple = ()
    norm = staticmethod(global_norm)  # of the gradient the clip takes (ZeRO-1: across ranks)

    def __init__(self, learning_rate: Schedule, grad_clip_norm: Optional[float] = None):
        self.schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
        self.grad_clip_norm = grad_clip_norm

    def init(self, params: List[torch.Tensor]) -> Dict:
        return {"optimizer": self.name, "count": 0,
                **{t: [torch.zeros_like(p) for p in params] for t in self.trees}}

    def applied_lr(self, state: Dict) -> float:
        """The learning rate of the last update applied (of the first one
        before any)."""
        return float(self.schedule(max(state["count"] - 1, 0)))

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
            g_norm = self.norm(grads) if g_norm is None else g_norm
            trigger = g_norm < self.grad_clip_norm
            one = torch.ones((), device=g_norm.device)
            torch._foreach_div_(grads, torch.where(trigger, one, g_norm))
            torch._foreach_mul_(grads, torch.where(trigger, one, one * self.grad_clip_norm))
        lr = self.schedule(state["count"])
        state["count"] += 1
        self._apply(params, grads, state, lr)

    def _apply(self, params, grads, state, lr) -> None:
        raise NotImplementedError


class AdamW(Optimizer):
    """``adamw`` (``adam`` with ``weight_decay=0``)."""

    trees = ("mu", "nu")

    def __init__(
        self,
        learning_rate: Schedule,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        grad_clip_norm: Optional[float] = None,
        name: str = "adamw",
    ):
        super().__init__(learning_rate, grad_clip_norm)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.name = name

    def _adam_direction(self, params, grads, state) -> List[torch.Tensor]:
        """``u`` with the weight decay: the moments updated in place, the
        bias corrections in fp32, as optax computes them."""
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        one, n = np.float32(1.0), np.float32(state["count"])
        u = torch._foreach_div(mu, float(one - np.float32(self.b1) ** n))
        denom = torch._foreach_div(nu, float(one - np.float32(self.b2) ** n))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(u, denom)
        if self.weight_decay:
            torch._foreach_add_(u, params, alpha=self.weight_decay)
        return u

    def _apply(self, params, grads, state, lr) -> None:
        torch._foreach_add_(params, self._adam_direction(params, grads, state), alpha=-lr)


class Lamb(AdamW):
    """``optax.lamb``: adam's direction with the weight decay, scaled per
    parameter by the trust ratio ``||p|| / ||u||``."""

    def __init__(self, learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_clip_norm: Optional[float] = None):
        super().__init__(learning_rate, b1, b2, eps, weight_decay, grad_clip_norm, name="lamb")

    def _apply(self, params, grads, state, lr) -> None:
        u = self._adam_direction(params, grads, state)
        p_norms, u_norms = torch._foreach_norm(params), torch._foreach_norm(u)
        for t, pn, un in zip(u, p_norms, u_norms):
            ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
            t.mul_(ratio)
        torch._foreach_add_(params, u, alpha=-lr)


class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=k)``: each step adds its
    gradient to the running mean ``acc`` (Welford's update, as optax); the
    ``k``-th runs ``inner`` (its clip included) on the mean and zeroes it.
    The other steps leave the parameters and ``inner``'s state as they are.
    The state is ``inner``'s with ``acc`` and ``mini_step`` added."""

    def __init__(self, inner: Optimizer, every_k: int):
        if every_k < 2:
            raise ValueError(f"MultiSteps accumulates 2 or more steps, not {every_k}")
        self.inner, self.k = inner, int(every_k)
        self.name = f"{inner.name}/accumulate_{self.k}"

    def init(self, params: List[torch.Tensor]) -> Dict:
        state = self.inner.init(params)
        state.update(optimizer=self.name, mini_step=0, acc=[torch.zeros_like(p) for p in params])
        return state

    def applied_lr(self, state: Dict) -> float:
        return self.inner.applied_lr(state)

    @torch.no_grad()
    def update(self, params, grads, state: Dict, g_norm: Optional[torch.Tensor] = None) -> None:
        """One micro-step; ``g_norm`` (of this step's gradient) is unused:
        the clip takes the norm of the mean."""
        del g_norm
        acc, n = state["acc"], state["mini_step"]
        delta = torch._foreach_sub(grads, acc)
        torch._foreach_div_(delta, float(n + 1))
        torch._foreach_add_(acc, delta)
        if n + 1 < self.k:
            state["mini_step"] = n + 1
            return
        self.inner.update(params, acc, state)
        torch._foreach_zero_(acc)
        state["mini_step"] = 0


def make_optimizer(
    name: str = "adamw",
    learning_rate: Schedule = 1e-5,
    weight_decay: float = 0.0,
    betas=(0.9, 0.999),
    eps: Optional[float] = None,  # None: 1e-8 for the adam family, 1e-6 madgrad
    grad_clip_norm: Optional[float] = None,
    accumulate_steps: int = 1,
):
    from dpr_scale_tpu_torch.optim.madgrad import Madgrad

    name = name.lower()
    adam_eps = 1e-8 if eps is None else eps
    if name in ("adamw", "adam"):
        opt = AdamW(learning_rate, b1=betas[0], b2=betas[1], eps=adam_eps,
                    weight_decay=weight_decay if name == "adamw" else 0.0,
                    grad_clip_norm=grad_clip_norm, name=name)
    elif name == "lamb":
        opt = Lamb(learning_rate, b1=betas[0], b2=betas[1], eps=adam_eps,
                   weight_decay=weight_decay, grad_clip_norm=grad_clip_norm)
    elif name == "madgrad":
        opt = Madgrad(learning_rate, weight_decay=weight_decay,
                      eps=1e-6 if eps is None else eps, grad_clip_norm=grad_clip_norm)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return MultiSteps(opt, accumulate_steps) if accumulate_steps > 1 else opt
