"""Device resolution for the port's entry points.

Counterpart of cocodr_tpu/ops/mips.py::_tpu_like_backend, with one
difference: the JAX package falls back to XLA off the TPU, while the port
never falls back. An entry point runs on the card unless its caller asks
for the CPU.
"""
from __future__ import annotations

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
