"""The numbers that decide `correct`: each compares what the program
produced with the reference's answer for the same inputs. Plain NumPy.

Every number here reads 0 when the two agree exactly and grows with the
disagreement; its limit is in limits/<cell>.json, set from the program's
readings over a dozen seeds and from the control's (PERF.md).
"""
from __future__ import annotations

import numpy as np


def row_rel_err(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per row ||got - ref|| / ||ref||; a row that is not finite reads inf."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.linalg.norm(got - ref, axis=1) / np.maximum(
        np.linalg.norm(ref, axis=1), 1e-30)
    return np.where(np.isfinite(got).all(1), err, np.inf)


def topk_gaps(got_scores, got_ids, ref_scores, id_scores, n_rows: int):
    """A top-k answer against the exact one -> (score gap, id gap), each the
    widest over queries and ranks, in units of the query's best exact
    score's magnitude.

    score gap: the returned scores, as sorted, against the exact top k's
    (a missed hit shows as a lower score at its rank).
    id gap: each returned score against the exact score of the id returned
    beside it (an id that is not its score's row shows); an id outside the
    corpus or given twice in one answer reads inf."""
    got_scores = np.asarray(got_scores, np.float64)
    ref_scores = np.asarray(ref_scores, np.float64)
    id_scores = np.asarray(id_scores, np.float64)
    scale = np.maximum(np.abs(ref_scores[:, :1]), 1e-30)
    score_gap = np.abs(got_scores - ref_scores) / scale
    id_gap = np.abs(got_scores - id_scores) / scale
    ids = np.asarray(got_ids)
    bad = (ids < 0) | (ids >= n_rows)
    s = np.sort(ids, axis=1)
    dup = np.zeros_like(bad)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    id_gap = np.where(bad.any(1, keepdims=True) | dup.any(1, keepdims=True),
                      np.inf, id_gap)
    score_gap = np.where(np.isfinite(got_scores), score_gap, np.inf)
    return float(score_gap.max()), float(id_gap.max())


def leaf_gaps(got: dict, ref: dict, keep) -> dict:
    """Each leaf's gap between two norms: |got[n] - ref[n]| over the larger
    of ref[n] and the median leaf's ref norm, for the leaves in `keep`; a
    norm that is not finite reads inf."""
    med = float(np.median([ref[n] for n in keep]))
    return {n: abs(float(got[n]) - float(ref[n]))
            / max(float(ref[n]), med, 1e-30)
            if np.isfinite(float(got[n])) else np.inf for n in keep}


def norm_gap(got: dict, ref: dict, keep) -> float:
    """The worst leaf's gap (leaf_gaps)."""
    return max(leaf_gaps(got, ref, keep).values())


def rel_gap(got, ref) -> float:
    """The widest |got - ref| / |ref| over paired values."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    gap = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)
    return float(np.where(np.isfinite(got), gap, np.inf).max())
