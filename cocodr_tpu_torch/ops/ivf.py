"""IVF clustered approximate MIPS: the counterpart of cocodr_tpu/ops/ivf.py
(FAISS `IndexIVFFlat` with an inner-product quantizer), block-granular
and product-first:

  * Build: k-means centroids (ops/kmeans.py) over a sample of the corpus,
    every document assigned to the centroid of its largest inner product,
    each cluster's rows packed into fixed-size blocks of `block_size` rows
    ([n_blocks, m, D] on the device). A large cluster spans several
    blocks; the last block of each cluster is zero-padded and its pad
    rows carry id -1.
  * Probe: score the queries against the centroids and keep the top
    `nprobe` clusters of each.
  * Invert on the host: the [Q, nprobe] probe table becomes fixed-shape
    scoring tasks (a block, a group of `q_group` queries), by one sort
    over the Q * nprobe pairs and a loop over the probed centroids.
  * Score on the device: a batched product [T, g, D] x [T, m, D] ->
    [T, g, m] over bounded task slabs, pad rows masked to -inf, a top-k
    per (task, slot), then a gather of each query's candidate lists and a
    final top-k.

The JAX package has no Pallas kernel here (XLA einsums and lax.top_k), so
this is plain torch, like the port's other kernel-free searches: the
products are float32 products of the operands rounded to the blocks'
dtype (exact products of bf16 values, float32 sums), and the selections
are torch.topk where the JAX package calls lax.top_k (exact ties may
order differently). nprobe == n_clusters scans every block and equals the
flat exact search.

Differences from the JAX package, each where it shows:
- the JAX search runs its task slabs in one lax.scan to spare a host
  round trip a slab; PyTorch enqueues without waiting, so a host loop
  over the slabs does the same, and no shape is padded to a power of two
  (that padding kept XLA's compile cache warm);
- k-means draws its initial rows with RandomState, not threefry
  (ops/kmeans.py), so the two packages' indexes differ from the same
  seed; from the same centroids their layouts are equal;
- the build stages through the host by the card's own free memory
  (`_host_stage`), and the task slab's budget is the card's
  (`_task_slab`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cocodr_tpu_torch.ops._device import resolve_device, tf32
from cocodr_tpu_torch.ops.kmeans import kmeans

# the float32 gathered block operand of one task slab stays under this
SLAB_BYTES = 512 * (1 << 20)


def _ceil_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _pow2_bucket(n: int, floor: int = 16) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _assign_chunk(x, c):
    """Document -> cluster by inner product, the metric of the probe (FAISS's
    IP IVF): [n, D] x [C, D] -> [n] int64, ties to the first centroid."""
    with tf32(False):
        ip = x.float() @ c.t()
    return torch.argmax(ip, dim=1)


@dataclasses.dataclass
class IvfIndex:
    """Cluster-bucketed corpus: three tensors on the device, and the
    centroid -> blocks table on the host for the probe inversion."""

    centroids: torch.Tensor  # [C, D] float32
    blocks: torch.Tensor  # [n_blocks, m, D] in the index's dtype
    block_ids: torch.Tensor  # [n_blocks, m] int32, -1 = pad
    centroid_block_rows: np.ndarray  # [C, b_max] int32 block idx, -1 pad
    n_docs: int
    block_size: int

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_blocks(self) -> int:
        return self.blocks.shape[0]


def _host_stage(nbytes: int, dev: torch.device) -> bool:
    """Whether the build stages its block gather through the host. The
    device build holds the corpus and its blocks at once (~2.3x the
    corpus's bytes with the pads), so it stages when that would take more
    than half of the card's free memory, leaving the rest to the searches
    that follow. On the CPU there is nothing to spare by staging."""
    if dev.type != "cuda":
        return False
    free, _ = torch.cuda.mem_get_info(dev)
    return nbytes * 2.3 > free / 2


def build_ivf_index(
    corpus,
    n_clusters: Optional[int] = None,
    block_size: int = 512,
    train_sample: int = 262_144,
    kmeans_iters: int = 20,
    seed: int = 0,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> IvfIndex:
    """Cluster and bucket a corpus [N, D] (numpy or a tensor, on any
    device) into an IvfIndex on `device` (the card unless the caller
    passes device="cpu"), its blocks in `dtype` (default the corpus's).
    The k-means sample gather, the chunked assignment and the block gather
    run on the device unless `_host_stage` says the corpus and its blocks
    would not fit there together; the bucketing is integer work on the
    host over the [N] assignment. The default n_clusters ~ N / (2 *
    block_size) keeps the mean cluster at ~2 blocks."""
    dev = resolve_device(device)
    src = torch.as_tensor(corpus)
    if dtype is None:
        dtype = src.dtype
    n, d = src.shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    if _host_stage(n * d * itemsize, dev):
        host = src.cpu()  # a device corpus comes back once
        corpus_dev = None
    else:
        host = None
        corpus_dev = src.to(dev, dtype)
    if n_clusters is None:
        n_clusters = max(4, n // (2 * block_size))

    def rows(sel):
        """Corpus rows (a numpy index) in `dtype` on the device."""
        if corpus_dev is not None:
            return corpus_dev[torch.from_numpy(sel).to(dev)]
        return host[torch.from_numpy(sel)].to(dev, dtype)

    # k-means on a sample: each of its steps is an [S, C] product
    rng = np.random.RandomState(seed)
    if n > train_sample:
        sample = rows(np.sort(rng.choice(n, train_sample, replace=False)))
    elif corpus_dev is not None:
        sample = corpus_dev
    else:
        sample = host.to(dev, dtype)
    centroids, _ = kmeans(sample.float(), n_clusters, n_iter=kmeans_iters,
                          seed=seed, device=dev)
    centroids = centroids.float()
    del sample

    # the whole corpus assigned in chunks of a [chunk, C] float32 score
    # matrix of ~256 MB; a bf16 corpus's rounding only moves documents near
    # a boundary between clusters, and no result depends on the assignment
    chunk = max(8, (1 << 26) // max(n_clusters, 1))
    chunk = _ceil_to(min(chunk, n), 8)
    ids = np.empty(n, np.int32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        x = (corpus_dev[s:e] if corpus_dev is not None
             else host[s:e].to(dev, dtype))
        ids[s:e] = _assign_chunk(x, centroids).cpu().numpy()
    # host bucketing: a stable sort by cluster, split into fixed blocks
    order = np.argsort(ids, kind="stable").astype(np.int64)
    counts = np.bincount(ids[order], minlength=n_clusters)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    blocks_per_c = np.maximum(1, (counts + block_size - 1) // block_size)
    n_blocks = int(blocks_per_c.sum())
    b_max = int(blocks_per_c.max())
    m = block_size
    block_doc_ids = np.full((n_blocks, m), -1, np.int64)
    centroid_block_rows = np.full((n_clusters, b_max), -1, np.int32)
    b = 0
    for c in range(n_clusters):
        s, cnt = int(starts[c]), int(counts[c])
        for j in range(int(blocks_per_c[c])):
            take = order[s + j * m: s + min((j + 1) * m, cnt)]
            block_doc_ids[b, : len(take)] = take
            centroid_block_rows[c, j] = b
            b += 1
    # the block layout: a gather of the corpus rows, pad rows zeroed (and
    # masked to -inf at query time through block_ids)
    gather_ids = torch.from_numpy(
        np.where(block_doc_ids >= 0, block_doc_ids, 0).reshape(-1))
    pad = torch.from_numpy(block_doc_ids < 0)
    if corpus_dev is not None:
        blocks = corpus_dev[gather_ids.to(dev)].view(n_blocks, m, d)
        blocks.masked_fill_(pad.to(dev)[:, :, None], 0)
    else:
        blocks_h = host[gather_ids].view(n_blocks, m, d).to(dtype)
        blocks_h.masked_fill_(pad[:, :, None], 0)
        blocks = blocks_h.to(dev)
    return IvfIndex(
        centroids=centroids,
        blocks=blocks,
        block_ids=torch.from_numpy(block_doc_ids.astype(np.int32)).to(dev),
        centroid_block_rows=centroid_block_rows,
        n_docs=n,
        block_size=m,
    )


def _probe(queries, centroids, nprobe: int):
    """[Q, nprobe] ids of each query's best centroids by inner product."""
    with tf32(False):
        s = queries.float() @ centroids.t()
    return torch.topk(s, nprobe, dim=1).indices


def _invert_probes(
    probes: np.ndarray,  # [Q, nprobe] centroid ids
    centroid_block_rows: np.ndarray,  # [C, b_max]
    q_group: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Host inversion: probe table -> (task_block [T], task_queries [T, g],
    qmap [Q, L], T), where qmap lists each query's (task * g + slot)
    candidate rows (-1 pad).

    One stable sort groups the Q * nprobe probe pairs by centroid; the
    loop runs only over the probed centroids, with numpy segment work
    inside."""
    n_q, nprobe = probes.shape
    g = q_group
    flat_c = probes.ravel().astype(np.int64)
    flat_q = np.repeat(np.arange(n_q, dtype=np.int64), nprobe)
    order = np.argsort(flat_c, kind="stable")
    sq = flat_q[order]
    uniq, u_start, u_count = np.unique(
        flat_c[order], return_index=True, return_counts=True
    )

    task_block_parts, task_queries_parts = [], []
    entry_q_parts, entry_row_parts = [], []
    t0 = 0
    for c, s, cnt in zip(uniq, u_start, u_count):
        qs = sq[s: s + cnt]
        rows = centroid_block_rows[c]
        rows = rows[rows >= 0]
        b_c = len(rows)
        n_g = -(-int(cnt) // g)
        qs_pad = np.concatenate([qs, np.zeros(n_g * g - cnt, np.int64)])
        # task t0 + j*b_c + i scores group j against block rows[i]
        task_block_parts.append(np.tile(rows, n_g))
        task_queries_parts.append(
            np.repeat(qs_pad.reshape(n_g, g), b_c, axis=0)
        )
        # pair (query at rank r in this centroid) -> group j = r//g,
        # slot = r%g, candidate rows (t0 + j*b_c + [0..b_c))*g + slot
        r = np.arange(cnt)
        base = (t0 + (r // g) * b_c)[:, None] + np.arange(b_c)[None, :]
        entry_row_parts.append((base * g + (r % g)[:, None]).ravel())
        entry_q_parts.append(np.repeat(qs, b_c))
        t0 += n_g * b_c
    n_t = t0
    if n_t == 0:
        return (
            np.zeros(0, np.int32), np.zeros((0, g), np.int32),
            np.full((n_q, 1), -1, np.int32), 0,
        )
    task_block = np.concatenate(task_block_parts).astype(np.int32)
    task_queries = np.concatenate(task_queries_parts).astype(np.int32)
    entry_q = np.concatenate(entry_q_parts)
    entry_row = np.concatenate(entry_row_parts)
    # bucket entries by query -> qmap [Q, L]
    counts_q = np.bincount(entry_q, minlength=n_q)
    qmap = np.full((n_q, int(counts_q.max())), -1, np.int32)
    eorder = np.argsort(entry_q, kind="stable")
    eq, er = entry_q[eorder], entry_row[eorder]
    seg_start = np.concatenate([[0], np.cumsum(counts_q)[:-1]])
    pos = np.arange(len(eq)) - seg_start[eq]
    qmap[eq, pos] = er
    return task_block, task_queries, qmap, n_t


def _score_one_slab(queries, blocks, block_ids, task_block, task_queries,
                    k: int):
    """One task slab: gather its blocks, score, top-k per (task, slot) ->
    (vals, ids) [T_slab * g, kk]. queries: float32 values of the rounded
    queries; task_block [T] and task_queries [T, g] int64 on the device."""
    q = queries[task_queries]  # [T, g, D]
    d = blocks[task_block].float()  # [T, m, D]
    with tf32(blocks.dtype == torch.bfloat16):
        s = torch.bmm(q, d.transpose(1, 2))  # [T, g, m]
    ids = block_ids[task_block]  # [T, m]
    s.masked_fill_((ids < 0)[:, None, :], float("-inf"))
    kk = min(k, s.shape[-1])
    lv, li = torch.topk(s, kk, dim=-1)  # [T, g, kk]
    lids = ids[:, None, :].expand(s.shape).gather(-1, li)
    t, g = lv.shape[0], lv.shape[1]
    return lv.reshape(t * g, kk), lids.reshape(t * g, kk)


def _score_and_merge(queries, blocks, block_ids, task_block, task_queries,
                     qmap, k: int, slab: int):
    """Score the tasks slab by slab (each slab gathers one bounded block
    operand), then gather each query's candidate rows and take one final
    top-k -> (vals [Q, k] float32, ids [Q, k] int32)."""
    fv, fi = [], []
    for s in range(0, task_block.shape[0], slab):
        v, i = _score_one_slab(queries, blocks, block_ids,
                               task_block[s:s + slab],
                               task_queries[s:s + slab], k)
        fv.append(v)
        fi.append(i)
    flat_v, flat_i = torch.cat(fv), torch.cat(fi)
    safe = qmap.clamp_min(0)  # [Q, L]
    cv = flat_v[safe]  # [Q, L, kk]
    ci = flat_i[safe]
    cv.masked_fill_((qmap < 0)[:, :, None], float("-inf"))
    n_q = qmap.shape[0]
    cv = cv.reshape(n_q, -1)
    ci = ci.reshape(n_q, -1)
    vals, pos = torch.topk(cv, min(k, cv.shape[1]), dim=1)
    out_ids = ci.gather(1, pos)
    if vals.shape[1] < k:  # fewer probed candidates than k
        pad = k - vals.shape[1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=float("-inf"))
        out_ids = torch.nn.functional.pad(out_ids, (0, pad), value=-1)
    return vals, out_ids


def _task_slab(index: IvfIndex, budget_bytes: int = SLAB_BYTES) -> int:
    """Tasks a slab such that its gathered [T, m, D] block operand, in
    float32 for the product, stays under budget_bytes."""
    m, d = index.block_size, index.blocks.shape[-1]
    return max(64, budget_bytes // (m * d * 4))


def ivf_topk(
    queries,
    index: IvfIndex,
    k: int,
    nprobe: int = 32,
    q_group: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k over an IvfIndex on its device -> (vals [Q, k]
    float32, ids [Q, k] int32), ids -1 where fewer than k documents were
    probed. The probe table comes to the host (Q * nprobe ids), so the call
    waits for the queries; the scoring is enqueued and not waited for."""
    dev = index.blocks.device
    queries = torch.as_tensor(queries).to(dev)
    n_q = queries.shape[0]
    if n_q == 0:
        return (torch.zeros((0, k), dtype=torch.float32, device=dev),
                torch.zeros((0, k), dtype=torch.int32, device=dev))
    # larger groups -> fewer tasks -> fewer re-reads of a popular
    # centroid's blocks, but a small batch is not padded to a large group
    q_group = min(q_group, _pow2_bucket(n_q, floor=8))
    nprobe = min(nprobe, index.n_clusters)
    probes = _probe(queries, index.centroids, nprobe).cpu().numpy()
    task_block, task_queries, qmap, n_t = _invert_probes(
        probes, index.centroid_block_rows, q_group
    )
    if n_t == 0:
        return (torch.full((n_q, k), float("-inf"), device=dev),
                torch.full((n_q, k), -1, dtype=torch.int32, device=dev))
    vals, ids = _score_and_merge(
        queries.to(index.blocks.dtype).float(),
        index.blocks,
        index.block_ids,
        torch.from_numpy(task_block).to(dev, torch.int64),
        torch.from_numpy(task_queries).to(dev, torch.int64),
        torch.from_numpy(qmap).to(dev, torch.int64),
        k,
        _task_slab(index),
    )
    ids = torch.where(torch.isfinite(vals), ids, -1)
    return vals, ids


def ivf_topk_chunked(
    queries,
    index: IvfIndex,
    k: int,
    nprobe: int = 32,
    q_chunk: int = 4096,
    q_group: int = 64,
) -> Tuple[np.ndarray, np.ndarray]:
    """ivf_topk over query chunks (the mining pipelines search 100k+
    queries a round; each chunk's state stays bounded) -> host numpy
    (vals, ids)."""
    if len(queries) == 0:
        return (
            np.zeros((0, k), np.float32), np.zeros((0, k), np.int32)
        )
    vals, ids = [], []
    for s in range(0, len(queries), q_chunk):
        v, i = ivf_topk(
            queries[s: s + q_chunk], index, k,
            nprobe=nprobe, q_group=q_group,
        )
        vals.append(v.cpu().numpy())
        ids.append(i.cpu().numpy())
    return np.concatenate(vals), np.concatenate(ids)
