"""The backward of the port's autograd.Functions around kernels: as the JAX
package's jax.custom_vjp backwards do, recompute a differentiable
formulation from the saved inputs and return its gradients."""
from __future__ import annotations

import torch


def recompute_grads(fn, inputs, needs_grad, grad_out):
    """Gradients of fn(*inputs) against grad_out for the inputs whose
    needs_grad entry is True, None for the others."""
    leaves = [t.detach().requires_grad_(need)
              for t, need in zip(inputs, needs_grad)]
    wanted = [t for t in leaves if t.requires_grad]
    if not wanted:
        return (None,) * len(leaves)
    with torch.enable_grad():
        out = fn(*leaves)
    grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return tuple(next(grads) if t.requires_grad else None for t in leaves)
