"""Retrieval metrics with trec_eval semantics: the port's own copy of
cocodr_tpu/evals/metrics.py (pure Python, no torch), which replaces
pytrec_eval (reference evaluate/evaluation/evaluate_beir.py:105-194,
ANCE/drivers/run_ann_data_gen.py:573-621).

Definitions follow trec_eval (the C library under pytrec_eval):
- ndcg_cut_k : DCG = Σ rel_i / log2(i+1) with LINEAR graded gain, ideal DCG
               from the full sorted qrels list, cutoff k.
- map_cut_k  : AP truncated at k, normalized by total #relevant (rel>0).
- recall_k   : |relevant ∩ top-k| / |relevant|.
- recip_rank : 1 / rank of the first relevant result (no cutoff).
- hole_rate_k: fraction of top-k docs with NO qrel judgment (the reference
               computes this manually, evaluate_beir.py:127-141).

Inputs are plain dicts (run: qid -> ordered doc id list; qrels:
qid -> {docid: grade}) so the same scorer serves BEIR, MARCO dev and the
miner's in-training eval. Ranked lists must already be sorted by score desc
(ties resolved upstream by the deterministic top-k).
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence


def dcg(gains: Sequence[float]) -> float:
    return sum(g / math.log2(i + 2) for i, g in enumerate(gains))


def ndcg_at_k(ranked: Sequence, qrel: Mapping, k: int) -> float:
    gains = [qrel.get(d, 0) for d in ranked[:k]]
    ideal = sorted((g for g in qrel.values() if g > 0), reverse=True)[:k]
    idcg = dcg(ideal)
    if idcg == 0:
        return 0.0
    return dcg(gains) / idcg


def map_at_k(ranked: Sequence, qrel: Mapping, k: int) -> float:
    n_rel = sum(1 for g in qrel.values() if g > 0)
    if n_rel == 0:
        return 0.0
    hits, ap = 0, 0.0
    for i, d in enumerate(ranked[:k]):
        if qrel.get(d, 0) > 0:
            hits += 1
            ap += hits / (i + 1)
    return ap / n_rel


def recall_at_k(ranked: Sequence, qrel: Mapping, k: int) -> float:
    rel = {d for d, g in qrel.items() if g > 0}
    if not rel:
        return 0.0
    return len(rel.intersection(ranked[:k])) / len(rel)


def recip_rank(ranked: Sequence, qrel: Mapping, k: int = 0) -> float:
    limit = len(ranked) if k <= 0 else k
    for i, d in enumerate(ranked[:limit]):
        if qrel.get(d, 0) > 0:
            return 1.0 / (i + 1)
    return 0.0


def hole_rate_at_k(ranked: Sequence, qrel: Mapping, k: int) -> float:
    top = ranked[:k]
    if not top:
        return 0.0
    return sum(1 for d in top if d not in qrel) / len(top)


def evaluate_run(
    run: Mapping[object, Sequence],
    qrels: Mapping[object, Mapping],
    ndcg_k: int = 10,
    map_k: int = 10,
    recall_ks: Sequence[int] = (100,),
    hole_ks: Sequence[int] = (10,),
) -> Dict[str, float]:
    """Macro-averaged metrics over queries present in qrels (trec_eval
    averages over judged queries only, like the reference which intersects
    run and qrel ids)."""
    qids = [q for q in run if q in qrels]
    if not qids:
        raise ValueError("no overlapping query ids between run and qrels")
    out: Dict[str, float] = {}
    n = len(qids)
    out[f"ndcg_cut_{ndcg_k}"] = (
        sum(ndcg_at_k(run[q], qrels[q], ndcg_k) for q in qids) / n
    )
    out[f"map_cut_{map_k}"] = (
        sum(map_at_k(run[q], qrels[q], map_k) for q in qids) / n
    )
    out["recip_rank"] = sum(recip_rank(run[q], qrels[q]) for q in qids) / n
    for k in recall_ks:
        out[f"recall_{k}"] = (
            sum(recall_at_k(run[q], qrels[q], k) for q in qids) / n
        )
    for k in hole_ks:
        out[f"hole_rate_{k}"] = (
            sum(hole_rate_at_k(run[q], qrels[q], k) for q in qids) / n
        )
    # full-depth hole rate over the whole ranked list (the reference reports
    # both @10 and full, evaluate/evaluation/evaluate_beir.py:136-141)
    out["hole_rate_full"] = (
        sum(hole_rate_at_k(run[q], qrels[q], len(run[q])) for q in qids) / n
    )
    out["num_queries"] = float(n)
    return out


def run_from_topk(query_ids, doc_ids_matrix, id_map=None, skip_self=False,
                  dedupe=False):
    """Build a run dict from MIPS output.

    query_ids: [Q] external query ids; doc_ids_matrix: [Q, k] corpus offsets
    (or -1 padding); id_map: optional offset -> external doc id mapping;
    skip_self: drop a doc whose external id equals the query id (ArguAna
    self-match skip, reference evaluate_beir.py:143-145); dedupe: keep only
    the best-ranked hit per doc id — required for multi-chunk docs whose
    chunks are separate index entries (the reference's `seen_pid` sets,
    evaluate_beir.py:132-134, ANCE/drivers/run_ann_data_gen.py:201-204).
    """
    run = {}
    for qi, row in zip(query_ids, doc_ids_matrix):
        docs: List = []
        seen = set()
        for off in row:
            if off < 0:
                continue
            d = id_map[off] if id_map is not None else int(off)
            if skip_self and d == qi:
                continue
            if dedupe:
                if d in seen:
                    continue
                seen.add(d)
            docs.append(d)
        run[qi] = docs
    return run
