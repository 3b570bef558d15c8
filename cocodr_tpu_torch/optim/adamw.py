"""AdamW with optax.adamw's numerics: the optimizer of
`OptimizerConfig(name="adamw")` (the JAX package builds
`optax.adamw(schedule, eps=eps, weight_decay=weight_decay)`).

optax.adamw is scale_by_adam (bias-corrected moments, eps outside the
square root, eps_root 0), then add_decayed_weights (the decay added to the
Adam step of every parameter, before the rate), then the learning rate,
read at the update count before it increments, as in optim/lamb.py. The
bias corrections 1 - b^t are float32, as optax computes them. The count
lives in each parameter group (`"count"`), so it is saved with
`state_dict()`.
"""
from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch


class AdamW(torch.optim.Optimizer):
    """params -> p <- p - lr(count) * (m_hat / (sqrt(v_hat) + eps) +
    weight_decay * p), m_hat = m / (1 - b1^t) and v_hat = v / (1 - b2^t)
    at t = count + 1. The defaults are optax.adamw's."""

    def __init__(self, params, lr: Union[float, Callable] = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        self.schedule = lr if callable(lr) else (lambda _count: lr)
        defaults = dict(betas=betas, eps=eps, weight_decay=weight_decay,
                        count=0)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every parameter that has a gradient, each stage
        one multi-tensor (torch._foreach_*) call over the group."""
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        for group in self.param_groups:
            lr = float(self.schedule(group["count"]))
            b1, b2 = group["betas"]
            eps, wd = group["eps"], group["weight_decay"]
            params = [p for p in group["params"] if p.grad is not None]
            for p in params:
                if not self.state[p]:
                    self.state[p]["exp_avg"] = torch.zeros_like(p)
                    self.state[p]["exp_avg_sq"] = torch.zeros_like(p)
            if params:
                grads = [p.grad for p in params]
                ms = [self.state[p]["exp_avg"] for p in params]
                vs = [self.state[p]["exp_avg_sq"] for p in params]
                t = np.float32(group["count"] + 1)
                bc1 = float(np.float32(1) - np.float32(b1) ** t)
                bc2 = float(np.float32(1) - np.float32(b2) ** t)
                torch._foreach_mul_(ms, b1)
                torch._foreach_add_(ms, torch._foreach_mul(grads, 1 - b1))
                torch._foreach_mul_(vs, b2)
                torch._foreach_add_(vs, torch._foreach_mul(
                    torch._foreach_mul(grads, grads), 1 - b2))
                denom = torch._foreach_sqrt(torch._foreach_div(vs, bc2))
                torch._foreach_add_(denom, eps)
                update = torch._foreach_div(torch._foreach_div(ms, bc1),
                                            denom)
                if wd != 0.0:
                    torch._foreach_add_(update,
                                        torch._foreach_mul(params, wd))
                torch._foreach_mul_(update, -lr)
                torch._foreach_add_(params, update)
            group["count"] += 1
