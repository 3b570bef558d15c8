"""Search dispatch for mining and evaluation: the counterpart of
cocodr_tpu/parallel/topk.py::search_topk, single device only.

The sharded search over a mesh (`mips_topk_sharded`,
`distributed_topk`) and the IVF search (`ops/ivf.py`) are not ported yet
(ROADMAP.md Queue 1 items 11 and 7); asking for either raises.
"""
from __future__ import annotations

import torch

from cocodr_tpu_torch.ops._device import resolve_device
from cocodr_tpu_torch.ops.mips import mips_topk_chunked_queries


def search_topk(queries, corpus, k: int, mesh=None, q_chunk: int = 4096,
                tile: int = 16384, exact_fp32: bool = False,
                method: str = "auto", n_real: int = 0, device="cuda"):
    """Top-k search of queries [Q, D] over corpus [N, D] (numpy arrays or
    tensors) -> host (scores [Q, k], ids [Q, k]) numpy arrays, through
    ops.mips.mips_topk_chunked_queries on `device` (the card unless the
    caller passes device="cpu"). A corpus tensor already on that device
    is used in place, with no copy (`.to(dev)` returns it); a numpy array
    or a tensor elsewhere is copied there, in its own dtype, on every
    call. A caller that searches one corpus several times places it once
    (pipelines/ance.py::place_corpus: bf16, padded for the methods that
    take n_real, as the kernel searches would per call otherwise).

    mesh: None, or a torch DeviceMesh of one device; more devices raise.
    method='ivf' raises unless exact_fp32 (which searches exactly, as in
    the JAX package), so the JAX function's ivf_index and ivf_nprobe have
    no counterpart yet."""
    if mesh is not None and mesh.size() > 1:
        raise NotImplementedError(
            "sharded search over a mesh is not ported yet: ROADMAP.md "
            "Queue 1 item 11 (parallel/*)"
        )
    if method == "ivf" and not exact_fp32:
        raise NotImplementedError(
            "method='ivf' is not ported yet: ROADMAP.md Queue 1 item 7 "
            "(ops/ivf.py)"
        )
    if method == "ivf":
        method = "auto"  # exact_fp32 searches exactly
    dev = resolve_device(device)
    corpus = torch.as_tensor(corpus).to(dev)
    return mips_topk_chunked_queries(
        queries, corpus, k, q_chunk=q_chunk, tile=tile,
        exact_fp32=exact_fp32, method=method, n_real=n_real,
    )
