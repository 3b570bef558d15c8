"""The port's copies of the retrieval metrics (evals/metrics.py) and the MS
MARCO scorer (evals/msmarco.py) against the JAX package's: the hand cases
of tests/test_metrics.py and its randomized cross-validation through both
packages. Both are pure Python; results must be equal to 1e-12."""
import math

import numpy as np
import pytest

from cocodr_tpu.evals import metrics as jm
from cocodr_tpu.evals import msmarco as jmm
from cocodr_tpu_torch.evals import metrics as tm
from cocodr_tpu_torch.evals import msmarco as tmm

TOL = 1e-12


def both(name, *args, **kw):
    """name's value in the port, asserted equal to the JAX package's."""
    mod_t, mod_j = (tm, jm) if hasattr(tm, name) else (tmm, jmm)
    got = getattr(mod_t, name)(*args, **kw)
    want = getattr(mod_j, name)(*args, **kw)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            if isinstance(want[k], list):
                assert got[k] == want[k], k
            else:
                assert got[k] == pytest.approx(want[k], abs=TOL), k
    elif isinstance(want, tuple):
        assert got == want
    else:
        assert got == pytest.approx(want, abs=TOL)
    return got


def test_ndcg_hand_case():
    qrel = {"d1": 3, "d2": 1, "d5": 2}
    dcg = 1 / math.log2(2) + 0 + 3 / math.log2(4)
    idcg = 3 / math.log2(2) + 2 / math.log2(3) + 1 / math.log2(4)
    assert both("ndcg_at_k", ["d2", "d9", "d1"], qrel, 10) == pytest.approx(
        dcg / idcg)
    assert both("ndcg_at_k", ["d1", "d5", "d2"], qrel, 10) == pytest.approx(
        1.0)
    assert both("dcg", [3, 0, 1]) == pytest.approx(3 + 1 / math.log2(4))


def test_map_recall_rr():
    qrel = {"a": 1, "b": 1, "c": 1}
    ranked = ["x", "a", "y", "b"]
    assert both("map_at_k", ranked, qrel, 10) == pytest.approx(1 / 3)
    assert both("recall_at_k", ranked, qrel, 2) == pytest.approx(1 / 3)
    assert both("recall_at_k", ranked, qrel, 4) == pytest.approx(2 / 3)
    assert both("recip_rank", ranked, qrel) == pytest.approx(0.5)
    assert both("recip_rank", ["z", "w"], qrel) == 0.0
    assert both("recip_rank", ranked, qrel, 1) == 0.0


def test_hole_rate():
    qrel = {"a": 1, "b": 0}
    assert both("hole_rate_at_k", ["a", "b", "x", "y"], qrel,
                4) == pytest.approx(0.5)
    assert both("hole_rate_at_k", [], qrel, 4) == 0.0


def test_evaluate_run_macro_average():
    qrels = {1: {"a": 1}, 2: {"b": 2}}
    run = {1: ["a", "x"], 2: ["x", "b"], 3: ["zzz"]}
    m = both("evaluate_run", run, qrels, recall_ks=(1, 2), hole_ks=(1, 2))
    assert m["num_queries"] == 2
    assert m["recip_rank"] == pytest.approx(0.75)
    with pytest.raises(ValueError):
        tm.evaluate_run({9: ["a"]}, qrels)


def test_run_from_topk_self_skip_and_dedupe():
    ids = np.array([[0, 1, -1], [2, 0, 1]])
    id_map = {0: "q1", 1: "d1", 2: "d2"}
    run = both("run_from_topk", ["q1", "q2"], ids, id_map=id_map,
               skip_self=True)
    assert run == {"q1": ["d1"], "q2": ["d2", "q1", "d1"]}
    dup = np.array([[3, 3, 5, -1]])
    assert both("run_from_topk", [7], dup, dedupe=True) == {7: [3, 5]}
    assert both("run_from_topk", [7], dup) == {7: [3, 3, 5]}


def test_msmarco_mrr_and_partial_run():
    qrels = {1: [7], 2: [9], 3: [5]}
    run = {1: [7, 8], 2: [1, 2, 9], 3: [4] * 10}
    m = both("compute_mrr", qrels, run)
    assert m["MRR @10"] == pytest.approx((1.0 + 1 / 3) / 3)
    m = both("compute_mrr", {1: [7], 2: [9], 3: [5], 4: [2]},
             {1: [7], 3: [8, 5], 99: [1]})
    assert m["MRR @10"] == pytest.approx(1.5 / 4) and m["QueriesRanked"] == 3
    with pytest.raises(ValueError):
        tmm.compute_mrr({1: [7]}, {2: [7]})


def test_msmarco_quality_checks():
    assert both("quality_checks", {1: [7, 8]})[0]
    ok, msg = both("quality_checks", {1: [7, 7]})
    assert not ok and "multiple times" in msg
    assert both("quality_checks", {1: [7, 0, 0, 0]})[0]
    assert not both("quality_checks", {1: [7, 7, 0, 0]})[0]


def _np_metrics(ranked, qrel, k):
    """tests/test_metrics.py's independent array-style scorer."""
    g = np.array([float(qrel.get(d, 0.0)) for d in ranked[:k]])
    discounts = 1.0 / np.log2(np.arange(len(g)) + 2.0)
    ideal = np.sort([v for v in qrel.values() if v > 0])[::-1][:k]
    idcg = float((ideal / np.log2(np.arange(len(ideal)) + 2.0)).sum())
    ndcg = float((g * discounts).sum() / idcg) if idcg > 0 else 0.0
    rel_mask = g > 0
    n_rel = sum(1 for v in qrel.values() if v > 0)
    precs = np.cumsum(rel_mask) / (np.arange(len(g)) + 1.0)
    ap = float(precs[rel_mask].sum() / n_rel) if n_rel else 0.0
    rel_ids = {d for d, v in qrel.items() if v > 0}
    rec = (len(rel_ids & set(ranked[:k])) / len(rel_ids)) if rel_ids else 0.0
    rr = 0.0
    full_mask = np.array([qrel.get(d, 0.0) > 0 for d in ranked])
    if full_mask.any():
        rr = 1.0 / (int(np.argmax(full_mask)) + 1)
    judged = np.array([d in qrel for d in ranked[:k]])
    hole = float((~judged).mean()) if len(judged) else 0.0
    return ndcg, ap, rec, rr, hole


def test_metrics_randomized_cross_validation():
    """200 random graded cases: the port equals the JAX package and the
    independent scorer, 1e-12; the macro averages of evaluate_run over
    the same cases too."""
    rng = np.random.RandomState(7)
    run, qrels = {}, {}
    for case in range(200):
        n_docs = rng.randint(1, 40)
        docs = [f"d{i}" for i in range(n_docs)]
        judged = rng.choice(docs, size=rng.randint(0, n_docs + 1),
                            replace=False)
        qrel = {d: int(rng.randint(0, 4)) for d in judged}
        ranked = list(rng.permutation(docs)[: rng.randint(1, n_docs + 1)])
        k = int(rng.randint(1, 15))
        ndcg, ap, rec, rr, hole = _np_metrics(ranked, qrel, k)
        assert both("ndcg_at_k", ranked, qrel, k) == pytest.approx(ndcg,
                                                                   abs=TOL)
        assert both("map_at_k", ranked, qrel, k) == pytest.approx(ap, abs=TOL)
        assert both("recall_at_k", ranked, qrel, k) == pytest.approx(rec,
                                                                     abs=TOL)
        assert both("recip_rank", ranked, qrel) == pytest.approx(rr, abs=TOL)
        assert both("hole_rate_at_k", ranked, qrel, k) == pytest.approx(
            hole, abs=TOL)
        run[case], qrels[case] = ranked, qrel
    both("evaluate_run", run, qrels, ndcg_k=5, map_k=7, recall_ks=(3, 10),
         hole_ks=(1, 5))


@pytest.mark.parametrize("fault", [None, "dropped", "pushed_down"])
def test_chip_smoke_metrics_check_takes_only_near_tie_moves(fault):
    """chip_smoke.py's eval phase takes the card's row in place of the
    exact plain search's only where a relevant id moved by a near-tie
    (`near_tie_moves`), then holds the card's metrics equal to the plain
    run's so patched. Here: a relevant id trading places with a near-tied
    one (1e-6 apart, tol 1e-4) is such a move, and its row's metrics
    differ from the plain row's; two non-relevant ids trading places move
    nothing. A planted wrong id that drops a relevant id from the top k,
    or one put first that pushes a relevant id down a rank, raises."""
    import chip_smoke

    rng = np.random.RandomState(0)
    n_q, n_docs, k, tol = 4, 40, 10, 1e-4
    scores = rng.randn(n_q, n_docs).astype(np.float32)
    order = np.argsort(-scores, axis=1)
    scores[0, order[0, 1]] = scores[0, order[0, 0]] - 1e-6
    order = np.argsort(-scores, axis=1, kind="stable")
    plain = order[:, :k].copy()
    ref_v = np.take_along_axis(scores, plain, axis=1)
    rel = [[int(plain[0, 0])], [int(plain[1, 2])], [int(plain[2, 3])],
           [int(plain[3, 2])]]
    rel_scores = [scores[r, rel[r]].tolist() for r in range(n_q)]
    card = plain.copy()
    card[0, [0, 1]] = plain[0, [1, 0]]
    card[1, [5, 6]] = plain[1, [6, 5]]
    if fault == "dropped":
        card[2, 3] = order[2, k + 5]
    elif fault == "pushed_down":
        card[3] = np.concatenate([[order[3, k + 5]], plain[3, :k - 1]])
    if fault:
        with pytest.raises(AssertionError, match="off the exact search"):
            chip_smoke.near_tie_moves(plain, card, ref_v, rel, rel_scores,
                                      tol)
        return
    moved = chip_smoke.near_tie_moves(plain, card, ref_v, rel, rel_scores,
                                      tol)
    assert moved == [0]
    qids = [f"q{r}" for r in range(n_q)]
    qrels = {q: {f"d{d}": 1 for d in rel[r]} for r, q in enumerate(qids)}
    id_map = {d: f"d{d}" for d in range(n_docs)}

    def score(ids):
        return tm.evaluate_run(tm.run_from_topk(qids, ids, id_map=id_map),
                               qrels, recall_ks=(k,))

    patched = plain.copy()
    patched[moved] = card[moved]
    assert score(card) == score(patched)
    assert score(card)["ndcg_cut_10"] != score(plain)["ndcg_cut_10"]
