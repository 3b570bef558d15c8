"""Device resolution for the port's entry points, and the TF32 policy of
the kernel-free float32 products.

Counterpart of cocodr_tpu/ops/mips.py::_tpu_like_backend, with one
difference: the JAX package falls back to XLA off the TPU, while the port
never falls back. An entry point runs on the card unless its caller asks
for the CPU.
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises when it names CUDA and there is
    no usable card (the caller must pass device="cpu" to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 for float32 matmuls on the card set to `enabled`, and the
    caller's setting restored after (also after an error); a context
    manager or a decorator. The flag belongs to the whole process, so a
    thread that runs float32 products at the same time sees it too.

    Off where an operand holds float32 values (TF32 rounds it to 10
    mantissa bits: k-means' x2 - 2xc + c2 cancels, an assignment near a
    boundary moves); on where both operands hold bf16 values, which TF32
    represents exactly, so the products stay exact and the sums float32."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
