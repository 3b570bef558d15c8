"""Search dispatch for mining and evaluation, and the sharded search over a
mesh: the counterpart of cocodr_tpu/parallel/topk.py.

The sharded search replaces the reference's per-rank knn, pickled
all_gather and argsort merge (reference ANCE/utils/eval_mrr.py:231-261):
each rank searches its shard of the corpus with the single-device
methods (the kernels on the card), lifts the ids into the global space,
and the ranks' [Q, k'] candidates are all-gathered over the data axis and
merged by one more top-k (`distributed_topk`), on the device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cocodr_tpu_torch.core.mesh import axis_group, data_rank, data_size
from cocodr_tpu_torch.ops._device import resolve_device
from cocodr_tpu_torch.ops.ivf import build_ivf_index, ivf_topk_chunked
from cocodr_tpu_torch.ops.mips import (
    clamp_q_chunk,
    mips_topk,
    mips_topk_blockmax,
    mips_topk_chunked_queries,
    mips_topk_refined,
    resolve_search_method,
)
from cocodr_tpu_torch.ops.mips_hier import (
    _pad_replicate,
    mips_topk_fast,
    mips_topk_hierarchical,
)

SHARD_ROW_MULTIPLE = 2048  # a shard's rows are padded to the sweeps' tile


def distributed_topk(local_vals, local_ids, k: int, group):
    """Merge every rank's candidates: local_vals [Q, k'] float32 and
    local_ids [Q, k'] GLOBAL ids are all-gathered over `group` (a process
    group or a DeviceMesh's data axis) and one more top-k taken -> (vals
    [Q, k], ids [Q, k]), the same on every rank. Equal scores keep rank
    order, then the order within a rank's list (lax.top_k takes the
    lowest index first)."""
    group = axis_group(group)
    W = dist.get_world_size(group)
    vals = [torch.empty_like(local_vals) for _ in range(W)]
    ids = [torch.empty_like(local_ids) for _ in range(W)]
    dist.all_gather(vals, local_vals.contiguous(), group=group)
    dist.all_gather(ids, local_ids.contiguous(), group=group)
    vals, ids = torch.cat(vals, dim=1), torch.cat(ids, dim=1)
    top, pos = torch.sort(vals, dim=1, descending=True, stable=True)
    pos = pos[:, :k]
    return top[:, :k], ids.gather(1, pos)


def sharded_mips_topk(queries, corpus_shard, shard_offset: int, k: int,
                      group, tile: int = 16384, exact_fp32: bool = False,
                      n_valid=None, method: str = "auto", k_local=None,
                      n_real: int = 0):
    """One rank's part of the sharded search: the top k_local of its shard
    by the single-device methods ('pallas': K2 + K3 on the card, 'fast':
    K2 packed + K3, then 'blockmax', 'refined', and 'naive' for the rest
    and for exact_fp32), hits at or past n_valid masked (-inf, id -1),
    ids lifted by shard_offset, then `distributed_topk` -> (vals, ids)
    [Q, k] on every rank.

    k_local (>= k): the caller passes k + pad, so that the copies of the
    last row that pad the final shard cannot push real hits out of its
    list before the mask. n_real: the shard has been replicate-padded to
    the sweeps' tile and its first n_real rows are its own (the kernel
    methods then pad nothing per call)."""
    rows = n_real or corpus_shard.shape[0]
    k_local = min(k if k_local is None else k_local, rows)
    method = resolve_search_method(method, exact_fp32=exact_fp32)
    if method == "pallas":
        vals, ids = mips_topk_hierarchical(queries, corpus_shard, k_local,
                                           n_real=n_real)
    elif method == "fast":
        vals, ids = mips_topk_fast(queries, corpus_shard, k_local,
                                   n_real=n_real)
    else:
        shard = corpus_shard[:rows]
        if method == "blockmax":
            bt = max(32, (min(tile * 4, 65536) // 32) * 32)
            vals, ids = mips_topk_blockmax(queries, shard, k_local, tile=bt)
        elif method == "refined":
            vals, ids = mips_topk_refined(queries, shard, k_local, tile=tile)
        else:  # 'naive', 'exact2' (as in the JAX package)
            vals, ids = mips_topk(queries, shard, k_local, tile=tile,
                                  exact_fp32=exact_fp32)
    vals = vals.float()
    ids = ids.long()
    if n_valid is not None:
        pad_hit = ids >= n_valid
        vals = vals.masked_fill(pad_hit, float("-inf"))
        ids = ids.masked_fill(pad_hit, -1)
    ids = torch.where(ids >= 0, ids + shard_offset, ids)
    return distributed_topk(vals, ids, k, group)


def place_shard(corpus, mesh, dtype, device, pad_to_tile: bool):
    """This rank's shard of a corpus [N, D] (numpy or tensor), the corpus
    first padded with copies of its last row to a multiple of the data
    axis, so that only the final shard carries padding -> (shard on
    `device` in `dtype`, shard_offset, n_valid, pad, n_real). pad_to_tile
    pads the shard itself to SHARD_ROW_MULTIPLE with copies of its last
    row, n_real then being its row count (the kernel methods' form)."""
    W, r = data_size(mesh), data_rank(mesh)
    N = corpus.shape[0]
    pad = (-N) % W
    shard = (N + pad) // W
    lo, hi = r * shard, min((r + 1) * shard, N)
    part = torch.as_tensor(corpus[lo:hi]).to(device, dtype)
    if hi - lo < shard:  # the final shard: copies of the corpus's last row
        last = torch.as_tensor(corpus[N - 1:N]).to(device, dtype)
        part = torch.cat([part, last.expand(shard - (hi - lo), -1)])
    n_valid = shard - pad if r == W - 1 else shard
    n_real = 0
    if pad_to_tile:
        n_real = shard
        part = _pad_replicate(part, SHARD_ROW_MULTIPLE)
    return part.contiguous(), r * shard, n_valid, pad, n_real


def mips_topk_sharded(queries, corpus, k: int, mesh, q_chunk: int = 4096,
                      tile: int = 16384, exact_fp32: bool = False,
                      method: str = "auto", device="cuda"):
    """The sharded search on the host's side: corpus rows [N, D] sharded
    over the mesh's data axis (each rank places only its own shard on
    `device`, in the corpus's dtype; for the kernel methods padded to
    their tile), queries [Q, D] searched in chunks of q_chunk by
    `sharded_mips_topk` -> host (vals [Q, k], ids [Q, k]) numpy arrays,
    the same on every rank."""
    dev = resolve_device(device)
    N = corpus.shape[0]
    k = min(k, N)
    method = resolve_search_method(method, exact_fp32=exact_fp32)
    shard, off, n_valid, pad, n_real = place_shard(
        corpus, mesh, torch.as_tensor(corpus[:1]).dtype, dev,
        method in ("pallas", "fast"))
    rows = n_real or shard.shape[0]
    if n_real and dev.type == "cuda":
        q_chunk = clamp_q_chunk(q_chunk, shard.shape[0], shard.shape[1],
                                device=dev)
    queries = torch.as_tensor(queries)
    out_v, out_i = [], []
    for s in range(0, queries.shape[0], q_chunk):
        qc = queries[s:s + q_chunk].to(dev)
        v, i = sharded_mips_topk(
            qc, shard, off, k, mesh, tile=min(tile, rows),
            exact_fp32=exact_fp32, n_valid=n_valid, method=method,
            k_local=k + pad, n_real=n_real)
        out_v.append(v.cpu().numpy())
        out_i.append(i.cpu().numpy())
    return np.concatenate(out_v), np.concatenate(out_i)


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

    mesh: a DeviceMesh (core/mesh.py) whose data axis is above 1 shards
    the search (`mips_topk_sharded`; the corpus is the unpadded rows and
    n_real is not used); a data axis of 1 searches on one device.

    method='ivf': the clustered approximate search (ops/ivf.py, FAISS's
    IndexIVFFlat). A caller that searches one corpus several times passes
    a prebuilt `ivf_index`; otherwise a bf16 index is built here from the
    first n_real rows (all rows when n_real is 0), so no pad row is ever
    indexed. With exact_fp32, or over a sharded mesh, the search is
    exact, as in the JAX package."""
    dev = resolve_device(device)
    sharded = data_size(mesh) > 1
    if method == "ivf" and not sharded and not exact_fp32:
        if ivf_index is None:
            corpus = torch.as_tensor(corpus)
            ivf_index = build_ivf_index(corpus[:n_real or corpus.shape[0]],
                                        dtype=torch.bfloat16, device=dev)
        return ivf_topk_chunked(queries, ivf_index, k, nprobe=ivf_nprobe,
                                q_chunk=q_chunk)
    if method == "ivf":
        method = "auto"  # exact_fp32 and sharded searches are exact
    if sharded:
        return mips_topk_sharded(queries, corpus, k, mesh, q_chunk=q_chunk,
                                 tile=tile, exact_fp32=exact_fp32,
                                 method=method, device=dev)
    corpus = torch.as_tensor(corpus).to(dev)
    return mips_topk_chunked_queries(
        queries, corpus, k, q_chunk=q_chunk, tile=tile,
        exact_fp32=exact_fp32, method=method, n_real=n_real,
    )
