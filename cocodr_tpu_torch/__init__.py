"""PyTorch/CUDA port of cocodr_tpu for one NVIDIA H100.

The JAX package `cocodr_tpu` stays the reference; this package imports
nothing of it (nor JAX). What the port covers so far is corpus encoding
(token records, `data` -> BERT body tower, `models` -> embeddings,
`pipelines.encode`), the serving path (text queries -> BERT query tower
-> exact or approximate top-k over a device-resident corpus, `ops.mips*`
-> ranked doc ids, `pipelines.serve`) and search (`parallel.topk`),
through hand-written CUDA kernels built from `csrc/` at first use
(`ops._build`).
"""
from cocodr_tpu_torch.ops._device import resolve_device

__all__ = ["resolve_device"]
