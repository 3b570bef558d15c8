"""In-training MS MARCO dev MRR evaluation: the counterpart of
cocodr_tpu/evals/mrr_eval.py (reference `passage_dist_eval` /
`compute_mrr`, ANCE/utils/eval_mrr.py:16-293, warmup/utils/eval_mrr.py:
166-261): encode dev queries and a dev passage set with the model as it
stands, search the top k on the card, score the official MRR@10. Two modes,
as in the reference: full ranking over the given passages, and reranking of
a per-query candidate list (a top1000.dev file).

The functions take the port's model module where the JAX ones take (model,
params), and leave it as it is (the encoders work on their own copies).
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from cocodr_tpu_torch.evals.msmarco import compute_mrr, quality_checks
from cocodr_tpu_torch.ops._device import resolve_device
from cocodr_tpu_torch.ops.mips import mips_topk_chunked_queries
from cocodr_tpu_torch.pipelines.encode import (
    EncodeConfig,
    Encoder,
    encode_cache,
)


def _embed_and_rank(model, query_cache, passage_cache, top_k, batch_size,
                    mesh, exact_fp32, device):
    """-> (query embeddings, passage embeddings, offset-space run of the
    top min(top_k, N) passages of every query)."""
    dev = resolve_device(device)
    ecfg = EncodeConfig(batch_size=batch_size)
    q_emb = encode_cache(
        Encoder(model, mesh=mesh, is_query=True, device=dev), query_cache,
        ecfg)
    p_emb = encode_cache(
        Encoder(model, mesh=mesh, is_query=False, device=dev), passage_cache,
        ecfg)
    k = min(top_k, p_emb.shape[0])
    _, top = mips_topk_chunked_queries(
        q_emb, torch.from_numpy(p_emb).to(dev), k, exact_fp32=exact_fp32)
    run = {q: [int(p) for p in row if p >= 0] for q, row in enumerate(top)}
    ok, msg = quality_checks(run)
    assert ok, msg
    return q_emb, p_emb, run


def full_ranking_mrr(model, query_cache, passage_cache,
                     qrels: Mapping[int, Sequence[int]], top_k: int = 10,
                     batch_size: int = 512, mesh=None,
                     exact_fp32: bool = False,
                     device="cuda") -> Dict[str, float]:
    """Full-corpus ranking MRR (qrels and run in offset space)."""
    _, _, run = _embed_and_rank(model, query_cache, passage_cache, top_k,
                                batch_size, mesh, exact_fp32, device)
    return compute_mrr(qrels, run)


def load_top_dev(path: str, qid2offset: Mapping, pid2offset: Mapping,
                 qid_col: int = 0, pid_col: int = 1) -> Dict[int, list]:
    """Parse the reference's top1000.dev candidate file (qid \\t pid \\t ...)
    into offset-space candidate lists (reference parse_top_dev,
    warmup/utils/eval_mrr.py:173-175). Unknown ids are skipped."""
    cands: Dict[int, list] = {}
    with open(path, encoding="utf8") as f:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            try:
                qid, pid = int(cols[qid_col]), int(cols[pid_col])
            except (ValueError, IndexError):
                continue
            if qid in qid2offset and pid in pid2offset:
                cands.setdefault(qid2offset[qid], []).append(pid2offset[pid])
    return cands


def combined_mrr(model, query_cache, passage_cache,
                 qrels: Mapping[int, Sequence[int]],
                 candidates: Mapping[int, Sequence[int]] = None,
                 top_k: int = 10, batch_size: int = 512, mesh=None,
                 exact_fp32: bool = False,
                 device="cuda") -> Dict[str, float]:
    """Full-ranking MRR plus, with candidates, reranking MRR from ONE
    embedding pass (the reference's combined_dist_eval computes both,
    warmup/utils/eval_mrr.py:186-229); rerank metrics are
    'rerank_'-prefixed."""
    q_emb, p_emb, run = _embed_and_rank(model, query_cache, passage_cache,
                                        top_k, batch_size, mesh, exact_fp32,
                                        device)
    out = dict(compute_mrr(qrels, run))
    if candidates:
        rr = rerank_mrr(q_emb, p_emb, candidates, qrels, top_k=top_k)
        out.update({f"rerank_{k}": v for k, v in rr.items()})
    return out


def rerank_mrr(query_emb: np.ndarray, passage_emb: np.ndarray,
               candidates: Mapping[int, Sequence[int]],
               qrels: Mapping[int, Sequence[int]],
               top_k: int = 10) -> Dict[str, float]:
    """Rerank per-query candidate lists (the reference's top1000-dev mode,
    warmup/utils/eval_mrr.py:166-229), float32 scores on the host."""
    run = {}
    for q, cands in candidates.items():
        cands = np.asarray(list(cands))
        scores = passage_emb[cands] @ query_emb[q]
        order = np.argsort(-scores, kind="stable")[:top_k]
        run[q] = [int(c) for c in cands[order]]
    return compute_mrr(qrels, run)
