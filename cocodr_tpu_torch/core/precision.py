"""Precision policy: the counterpart of cocodr_tpu/core/precision.py.

The reference trains fp16 through Apex AMP O1 with loss scaling
(reference ANCE/drivers/run_ann.py:161-169). The port computes in bf16 on
the card (the kernels' dtype) with float32 parameters and optimizer
state, so no loss scaling is needed; reductions, losses and similarities
accumulate in float32 whatever the compute dtype. `compute_dtype` is what
models.bert.BertConfig.dtype takes.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    @classmethod
    def bf16(cls) -> "Precision":
        return cls()

    @classmethod
    def fp32(cls) -> "Precision":
        return cls(compute_dtype=torch.float32)
