"""Gradient accumulation with optax.MultiSteps' semantics: the optimizer of
`OptimizerConfig(grad_accum_steps=k)` (the JAX package wraps its LAMB or
AdamW in `optax.MultiSteps(tx, every_k_schedule=k)`).

Each `step()` folds the parameters' `.grad` (already clipped by the train
step, as the JAX steps clip each micro-batch's gradient before the
optimizer) into a running mean, optax's `_acc_update` with the mean on:
acc <- acc + (g - acc) / (n + 1) at mini-step n (Welford's form of
(g + n * acc) / (n + 1)). On the k-th micro-batch the inner optimizer
steps once on the mean and the accumulator resets; on every other one the
parameters and the inner state (moments, schedule count) stay as they
are. A parameter with no gradient in a micro-batch adds a zero, as its
zero gradient would in optax; one with none in the whole window gets none
at the emitting step.

The train state's `step` goes on counting micro-batches (the dropout
generators, save_steps and the skip on resume read it), while the inner
optimizer's schedule count moves once per k. `state_dict()` holds the
mini-step, the gradient step and the accumulator beside the inner
optimizer's state, so that a checkpoint taken inside a window resumes bit
for bit.
"""
from __future__ import annotations

import torch


class MultiSteps:
    """inner: the optimizer that takes the accumulated step (Lamb, AdamW);
    every_k: micro-batches per update. Duck-types the parts of
    torch.optim.Optimizer that the port's steps and checkpoints use
    (`param_groups`, `state`, `zero_grad`, `step`, `state_dict`,
    `load_state_dict`)."""

    def __init__(self, inner, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.inner = inner
        self.every_k = every_k
        self.mini_step = 0
        self.gradient_step = 0
        self.acc = {}  # parameter -> the running mean of its gradients

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def _params(self):
        return [p for group in self.param_groups for p in group["params"]]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self, closure=None) -> None:
        """Accumulate the parameters' .grad; on the k-th micro-batch step the
        inner optimizer on the mean and reset."""
        if closure is not None:
            raise ValueError("MultiSteps.step takes no closure")
        n = self.mini_step
        params = self._params()
        for p in params:
            acc = self.acc.get(p)
            if p.grad is None and acc is None:
                continue
            if acc is None:
                acc = self.acc[p] = torch.zeros_like(p)
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            acc.add_(g.sub(acc).div_(n + 1))
        if n + 1 < self.every_k:
            self.mini_step = n + 1
            return
        grads = [p.grad for p in params]
        try:
            for p in params:
                p.grad = self.acc.get(p)
            self.inner.step()
        finally:
            for p, g in zip(params, grads):
                p.grad = g
        for acc in self.acc.values():
            acc.zero_()
        self.mini_step = 0
        self.gradient_step += 1

    def state_dict(self) -> dict:
        index = {p: i for i, p in enumerate(self._params())}
        return {"inner": self.inner.state_dict(), "every_k": self.every_k,
                "mini_step": self.mini_step,
                "gradient_step": self.gradient_step,
                "acc": {index[p]: a for p, a in self.acc.items()}}

    def load_state_dict(self, sd: dict) -> None:
        if sd["every_k"] != self.every_k:
            raise ValueError(f"a checkpoint of every_k {sd['every_k']} "
                             f"loaded into MultiSteps({self.every_k})")
        self.inner.load_state_dict(sd["inner"])
        self.mini_step = int(sd["mini_step"])
        self.gradient_step = int(sd["gradient_step"])
        params = self._params()
        self.acc = {params[int(i)]: a.to(params[int(i)].device,
                                         params[int(i)].dtype, copy=True)
                    for i, a in sd["acc"].items()}
