"""Search dispatch for mining and evaluation: the counterpart of
cocodr_tpu/parallel/topk.py::search_topk, single device only.

The sharded search over a mesh (`mips_topk_sharded`, `distributed_topk`)
is not ported yet (ROADMAP.md Queue 1 item 11); asking for it raises.
"""
from __future__ import annotations

import torch

from cocodr_tpu_torch.ops._device import resolve_device
from cocodr_tpu_torch.ops.ivf import build_ivf_index, ivf_topk_chunked
from cocodr_tpu_torch.ops.mips import mips_topk_chunked_queries


def search_topk(queries, corpus, k: int, mesh=None, q_chunk: int = 4096,
                tile: int = 16384, exact_fp32: bool = False,
                method: str = "auto", ivf_index=None, ivf_nprobe: int = 32,
                n_real: int = 0, device="cuda"):
    """Top-k search of queries [Q, D] over corpus [N, D] (numpy arrays or
    tensors) -> host (scores [Q, k], ids [Q, k]) numpy arrays, through
    ops.mips.mips_topk_chunked_queries on `device` (the card unless the
    caller passes device="cpu"). A corpus tensor already on that device
    is used in place, with no copy (`.to(dev)` returns it); a numpy array
    or a tensor elsewhere is copied there, in its own dtype, on every
    call. A caller that searches one corpus several times places it once
    (pipelines/ance.py::place_corpus: bf16, padded for the methods that
    take n_real, as the kernel searches would per call otherwise).

    method='ivf': the clustered approximate search (ops/ivf.py, FAISS's
    IndexIVFFlat). A caller that searches one corpus several times passes
    a prebuilt `ivf_index`; otherwise a bf16 index is built here from the
    first n_real rows (all rows when n_real is 0), so no pad row is ever
    indexed. With exact_fp32 the search is exact, as in the JAX package.

    mesh: None, or a torch DeviceMesh of one device; more devices raise."""
    if mesh is not None and mesh.size() > 1:
        raise NotImplementedError(
            "sharded search over a mesh is not ported yet: ROADMAP.md "
            "Queue 1 item 11 (parallel/*)"
        )
    dev = resolve_device(device)
    if method == "ivf" and not exact_fp32:
        if ivf_index is None:
            corpus = torch.as_tensor(corpus)
            ivf_index = build_ivf_index(corpus[:n_real or corpus.shape[0]],
                                        dtype=torch.bfloat16, device=dev)
        return ivf_topk_chunked(queries, ivf_index, k, nprobe=ivf_nprobe,
                                q_chunk=q_chunk)
    if method == "ivf":
        method = "auto"  # exact_fp32 searches exactly
    corpus = torch.as_tensor(corpus).to(dev)
    return mips_topk_chunked_queries(
        queries, corpus, k, q_chunk=q_chunk, tile=tile,
        exact_fp32=exact_fp32, method=method, n_real=n_real,
    )
