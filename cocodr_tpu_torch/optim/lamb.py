"""LAMB with the reference's semantics: the counterpart of
cocodr_tpu/optim/lamb.py (`lamb` = `scale_by_reference_lamb` chained with
optax's `scale_by_learning_rate`).

The reference's Lamb (ANCE/utils/lamb.py) differs from the paper and from
optax.lamb:
  - no bias correction of the Adam moments;
  - the weight norm is clamped to [0, 10];
  - weight decay is added into the Adam step before the trust ratio;
  - the trust ratio is 1 when either norm is 0;
  - `adam=True` forces the trust ratio to 1 (plain un-debiased Adam).

The trust ratio is per tensor. The JAX package stacks the encoder's layers
into [L, ...] leaves and takes one ratio per layer slice of them; the port
holds one tensor per layer, which is the same thing.

The learning rate is a float or a schedule of the update count, read at
the count before it increments, as optax's `scale_by_learning_rate` reads
it: the first update uses schedule(0). The count lives in each parameter
group (`"count"`), so it is saved with `state_dict()`.
"""
from __future__ import annotations

from typing import Callable, Union

import torch


class Lamb(torch.optim.Optimizer):
    """params -> updates p <- p - lr(count) * trust * adam_step, with
    adam_step = m / (sqrt(v) + eps) + weight_decay * p, m and v the
    un-debiased moments, trust = clip(|p|, 0, 10) / |adam_step|."""

    def __init__(self, params, lr: Union[float, Callable] = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0, adam: bool = False):
        self.schedule = lr if callable(lr) else (lambda _count: lr)
        defaults = dict(betas=betas, eps=eps, weight_decay=weight_decay,
                        adam=adam, count=0)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every parameter that has a gradient. Each stage
        runs as one multi-tensor (torch._foreach_*) call over the group,
        rounded as the per-tensor formula: the optimizer would otherwise
        be ~15 small launches per tensor, ~3,000 at bert-base."""
        if closure is not None:
            raise ValueError("Lamb.step takes no closure")
        for group in self.param_groups:
            lr = float(self.schedule(group["count"]))
            b1, b2 = group["betas"]
            eps, wd = group["eps"], group["weight_decay"]
            params = [p for p in group["params"] if p.grad is not None]
            grads = [p.grad for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p]["exp_avg"] = torch.zeros_like(p)
                    self.state[p]["exp_avg_sq"] = torch.zeros_like(p)
            if params:
                ms = [self.state[p]["exp_avg"] for p in params]
                vs = [self.state[p]["exp_avg_sq"] for p in params]
                update = lamb_update(params, grads, ms, vs, b1, b2, eps, wd,
                                     group["adam"])
                torch._foreach_mul_(update, -lr)
                torch._foreach_add_(params, update)
            group["count"] += 1


def lamb_update(params, grads, ms, vs, b1, b2, eps, wd, adam):
    """Moments in place (m <- b1 m + (1 - b1) g, v <- b2 v + (1 - b2) g^2)
    -> the updates trust * (m / (sqrt(v) + eps) + wd p), before the rate."""
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(vs, b2)
    torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                               1 - b2))
    denom = torch._foreach_sqrt(vs)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(ms, denom)
    if wd != 0.0:
        torch._foreach_add_(update, torch._foreach_mul(params, wd))
    if not adam:
        torch._foreach_mul_(update, trust_ratios(params, update))
    return update


def trust_ratios(params, update):
    """clip(|p|, 0, 10) / |update| per tensor, as 0-dim tensors; 1 where
    either norm is 0 (no host sync)."""
    w = torch.stack(torch._foreach_norm(params)).clamp(0.0, 10.0)
    a = torch.stack(torch._foreach_norm(update))
    trust = torch.where((w == 0) | (a == 0), torch.ones_like(w),
                        w / a.clamp_min(1e-38))
    return list(trust.unbind())
