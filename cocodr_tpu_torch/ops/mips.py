"""Sort-based and block-max top-k MIPS, the rescore step, and the
search-method dispatch over query chunks.

Counterpart of cocodr_tpu/ops/mips.py: `_merge_topk`, `mips_topk` (the
sort-per-tile 'naive' search, also the exact_fp32 path), `rescore_topk`,
`mips_topk_refined`, `mips_topk_blockmax` (the block-max search without a
kernel), `SEARCH_METHODS`, `resolve_search_method`, `clamp_q_chunk` and
`mips_topk_chunked_queries`. These have no Pallas kernel in the JAX
package: their products are plain float32 matmuls of the operands rounded
to the multiply dtype (exact bf16 products, float32 sums), and their
selections are torch.topk where the JAX package calls lax.top_k (exact
ties may order differently).

Four differences from the JAX package, each where it shows:
- `resolve_search_method` maps 'auto' to 'pallas' on every device, and
  never turns a kernel method into 'blockmax': the port does not fall
  back, and a CPU tensor runs the same method through the kernels' plain
  versions (so it has no `refine` switch).
- `clamp_q_chunk` takes its device-memory budget from the card
  (`torch.cuda.mem_get_info`), not from a fixed 15e9-byte v5e budget.
- `mips_topk_chunked_queries` raises when n_real is given to a method
  that cannot honour it, where the JAX function drops it silently.
- `mips_topk` has no approximate mode: TPU PartialReduce
  (lax.approx_max_k, `approx`) has no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cocodr_tpu_torch.ops.mips_exact2 import mips_topk_exact2
from cocodr_tpu_torch.ops.mips_hier import (
    mips_topk_fast,
    mips_topk_hierarchical,
    scores,
)


def _merge_topk(run_vals, run_ids, new_vals, new_ids, k):
    """Merge two (vals, ids) candidate sets, keep the top k by value."""
    vals = torch.cat([run_vals, new_vals], dim=1)
    ids = torch.cat([run_ids, new_ids], dim=1)
    top, pos = torch.topk(vals, k, dim=1)
    return top, ids.gather(1, pos)


def mips_topk(queries, corpus, k: int, tile: int = 16384,
              exact_fp32: bool = False):
    """Exact top-k by a sweep over corpus tiles with a top-k per tile and
    a running merge -> (scores [Q, k] descending, ids [Q, k] int64).

    bf16 operands with float32 sums; exact_fp32=True multiplies in float32
    (bit-parity mode)."""
    N = corpus.shape[0]
    k = min(k, N)
    dtype = torch.float32 if exact_fp32 else torch.bfloat16
    vals = ids = None
    for t0 in range(0, N, tile):
        s = scores(queries, corpus[t0:t0 + tile], dtype)
        t_vals, t_pos = torch.topk(s, min(k, s.shape[1]), dim=1)
        t_ids = t_pos + t0
        if vals is None:
            vals, ids = t_vals, t_ids
        else:
            vals, ids = _merge_topk(vals, ids, t_vals, t_ids,
                                    min(k, vals.shape[1] + t_vals.shape[1]))
    return vals, ids


def rescore_topk(queries, corpus, cand_ids, k: int, dtype=torch.float32,
                 q_chunk: int = 128):
    """Rescore per-query candidate sets -> the final top-k.

    queries [Q, D]; cand_ids [Q, K'] corpus rows (-1 pads). dtype: the
    multiply dtype (bf16 to stay consistent with a bf16 sweep, float32 for
    exact final ordering); sums are float32. The candidate gather runs in
    query chunks to bound the [chunk, K', D] buffer."""
    out_v, out_i = [], []
    for s in range(0, queries.shape[0], q_chunk):
        qc = queries[s:s + q_chunk].to(dtype).float()
        cc = cand_ids[s:s + q_chunk].long()
        rows = corpus[cc.clamp_min(0)].to(dtype).float()  # [C, K', D]
        sc = torch.bmm(rows, qc[:, :, None])[:, :, 0]
        sc = sc.masked_fill(cc < 0, float("-inf"))
        v, pos = torch.topk(sc, k, dim=1)
        out_v.append(v)
        out_i.append(cc.gather(1, pos))
    return torch.cat(out_v), torch.cat(out_i)


def mips_topk_refined(queries, corpus, k: int, oversample: int = 2,
                      tile: int = 16384):
    """bf16 sweep keeping oversample*k candidates per query, then a float32
    rescore of the candidates for exact final ordering."""
    kk = min(oversample * k, corpus.shape[0])
    _, cand = mips_topk(queries, corpus, kk, tile=tile)
    return rescore_topk(queries, corpus, cand, min(k, kk))


def mips_topk_blockmax(queries, corpus, k: int, tile: int = 65536,
                       block: int = 32, rescore_chunk: int = 128):
    """Exact two-level top-k: per-block maxima of the bf16 scores over
    corpus tiles, one top-k over the maxima, and a bf16 rescore of the
    chosen blocks' rows. A block holding a top-k row has max >= the k-th
    score, and at most k blocks do, so the chosen blocks hold them all."""
    if tile % block:
        raise ValueError(f"tile={tile} must be a multiple of block={block}")
    Q = queries.shape[0]
    N = corpus.shape[0]
    k = min(k, N)
    parts = []
    for t0 in range(0, N, tile):
        s = scores(queries, corpus[t0:t0 + tile], torch.bfloat16)
        pad = (-s.shape[1]) % block  # rows past N score -inf
        if pad:
            s = F.pad(s, (0, pad), value=float("-inf"))
        parts.append(s.view(Q, -1, block).amax(-1))
    bm = torch.cat(parts, dim=1)  # [Q, ceil(N / block)]
    block_ids = torch.topk(bm, min(k, bm.shape[1]), dim=1).indices
    cand = (block_ids[:, :, None] * block
            + torch.arange(block, device=bm.device)).reshape(Q, -1)
    cand = cand.masked_fill(cand >= N, -1)
    return rescore_topk(queries, corpus, cand, k, dtype=torch.bfloat16,
                        q_chunk=rescore_chunk)


SEARCH_METHODS = (
    "auto", "pallas", "exact2", "fast", "blockmax", "refined", "naive",
)
# methods that take a replicate-padded corpus with its real row count
N_REAL_METHODS = ("pallas", "fast")


def resolve_search_method(method: str, exact_fp32: bool = False) -> str:
    """Validate; 'naive' under exact_fp32; 'auto' -> 'pallas' (the exact
    hierarchical kernel search) on every device."""
    # 'ivf' is refused here: it searches an index, not a flat corpus, and
    # its callers (parallel/topk.py, pipelines/ance.py) branch before this
    if method not in SEARCH_METHODS:
        raise ValueError(
            f"method must be one of {SEARCH_METHODS}, got {method!r}"
        )
    if exact_fp32:
        return "naive"
    return "pallas" if method == "auto" else method


def clamp_q_chunk(q_chunk: int, n_docs: int, dim: int,
                  hbm_budget: int | None = None, device=None) -> int:
    """Query-chunk clamp for the kernel searches: their per-query block
    maxima take ~n_docs/2 bytes per query beside the bf16 corpus
    (n_docs*dim*2 bytes). Clamp so corpus and maxima fit hbm_budget;
    multiples of 128, floor 128. hbm_budget=None reads the card (`device`,
    default the current one): its free bytes plus the corpus's, which is
    taken to be resident already. A caller without a card passes the
    budget."""
    if hbm_budget is None:
        if not torch.cuda.is_available():
            raise ValueError("no card to read a budget from: pass hbm_budget")
        free, _ = torch.cuda.mem_get_info(device)
        hbm_budget = free + n_docs * dim * 2
    free = hbm_budget - n_docs * dim * 2
    q_fit = int(free // max(n_docs // 2, 1))
    q_fit = max(128, (q_fit // 128) * 128)
    return min(q_chunk, q_fit)


def mips_topk_chunked_queries(queries, corpus, k: int, q_chunk: int = 4096,
                              oversample: int = 2, method: str = "auto",
                              n_real: int = 0, hbm_budget: int | None = None,
                              **kw):
    """Search over query chunks -> host (scores [Q, k], ids [Q, k])
    numpy arrays. Runs on the device the corpus tensor lies on.

    method:
      'auto'     - 'pallas' on every device;
      'pallas'   - exact hierarchical search (K2 + K3 + rescore);
      'exact2'   - exact argmax-certificate search (K9 + K3; falls back to
                   'pallas' when the certificate fails on the card);
      'fast'     - rescore-free block-argmax search (K2 packed + K3);
      'blockmax' - exact block-max search without a kernel;
      'refined'  - bf16 sweep + float32 candidate rescore;
      'naive'    - sort-per-tile sweep (also the exact_fp32 path).
    n_real (a replicate-padded corpus's real row count) is honoured by
    'pallas' and 'fast'; any other method raises on it. The kernel
    searches' chunk is clamped by clamp_q_chunk: on a card from its free
    memory, else only when hbm_budget is given."""
    method = resolve_search_method(method,
                                   exact_fp32=bool(kw.get("exact_fp32")))
    if n_real and method not in N_REAL_METHODS:
        raise ValueError(
            f"method {method!r} cannot honour n_real={n_real}: pass the "
            f"unpadded corpus, or use one of {N_REAL_METHODS}"
        )
    corpus = torch.as_tensor(corpus)
    queries = torch.as_tensor(queries, device=corpus.device)
    if method in ("pallas", "exact2", "fast") and (
            hbm_budget is not None or corpus.device.type == "cuda"):
        q_chunk = clamp_q_chunk(q_chunk, corpus.shape[0], corpus.shape[1],
                                hbm_budget, corpus.device)

    out_v, out_i = [], []
    for s in range(0, queries.shape[0], q_chunk):
        qc = queries[s:s + q_chunk]
        if method == "pallas":
            v, i = mips_topk_hierarchical(qc, corpus, k, n_real=n_real)
        elif method == "exact2":
            v, i = mips_topk_exact2(qc, corpus, k)
        elif method == "fast":
            v, i = mips_topk_fast(qc, corpus, k, n_real=n_real)
        elif method == "blockmax":
            v, i = mips_topk_blockmax(
                qc, corpus, k, tile=min(kw.get("tile", 16384) * 4, 65536))
        elif method == "refined":
            v, i = mips_topk_refined(qc, corpus, k, oversample=oversample,
                                     tile=kw.get("tile", 16384))
        else:  # 'naive'
            v, i = mips_topk(qc, corpus, k, **kw)
        out_v.append(v.cpu().numpy())
        out_i.append(i.cpu().numpy())
    return np.concatenate(out_v), np.concatenate(out_i)
