"""MADGRAD (momentumized adaptive dual averaging), counterpart of
:mod:`dpr_scale_tpu.optim.madgrad` (the facebookresearch method,
https://arxiv.org/abs/2101.11075), on fp32 master parameters in place:

    lamb_k = lr_k * sqrt(k + 1)
    g      = grad + weight_decay * param            (classic L2)
    s_k+1  = s_k + lamb_k * g
    v_k+1  = v_k + lamb_k * g*g
    z_k+1  = x0 - s_k+1 / (v_k+1^(1/3) + eps)
    x_k+1  = (1 - c) x_k + c z_k+1,   c = 1 - momentum

The state: ``count``, ``grad_sum`` (s), ``grad_sum_sq`` (v) and ``x0``, the
parameters at :meth:`Madgrad.init`.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from dpr_scale_tpu_torch.optim.factory import Optimizer, Schedule


class Madgrad(Optimizer):
    name = "madgrad"
    trees = ("grad_sum", "grad_sum_sq", "x0")

    def __init__(self, learning_rate: Schedule = 1e-2, momentum: float = 0.9,
                 weight_decay: float = 0.0, eps: float = 1e-6,
                 grad_clip_norm: Optional[float] = None):
        if not 0.0 <= momentum < 1.0:
            raise ValueError(f"momentum must be in [0,1): {momentum}")
        super().__init__(learning_rate, grad_clip_norm)
        self.momentum, self.weight_decay, self.eps = momentum, weight_decay, eps

    def init(self, params: List[torch.Tensor]) -> Dict:
        state = super().init(params)
        state["x0"] = [p.detach().clone() for p in params]
        return state

    def _apply(self, params, grads, state, lr) -> None:
        k = state["count"] - 1  # the count before this update
        lamb = float(torch.tensor(lr, dtype=torch.float32)
                     * torch.sqrt(torch.tensor(k + 1.0, dtype=torch.float32)))
        if self.weight_decay:
            torch._foreach_add_(grads, params, alpha=self.weight_decay)
        s, v = state["grad_sum"], state["grad_sum_sq"]
        torch._foreach_add_(s, grads, alpha=lamb)
        torch._foreach_addcmul_(v, grads, grads, value=lamb)
        ck = 1.0 - self.momentum
        # z = x0 - s / (cbrt(v) + eps); p += ((1 - ck) p + ck z) - p
        denom = torch._foreach_pow(v, 1.0 / 3.0)
        torch._foreach_add_(denom, self.eps)
        z = torch._foreach_div(s, denom)
        torch._foreach_neg_(z)
        torch._foreach_add_(z, state["x0"])
        new = torch._foreach_mul(params, 1.0 - ck)
        torch._foreach_add_(new, z, alpha=ck)
        torch._foreach_sub_(new, params)
        torch._foreach_add_(params, new)

