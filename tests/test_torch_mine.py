"""The port's ANCE mining (pipelines/ance.py: generate_negatives,
write_ann_data, place_corpus, mine, ance_round, checkpoint_params_loader,
train_loop, mine_loop, write_group_ndcg) against the JAX package's on the
CPU, on tiny towers whose weights are carried over by models/convert.py.

The towers' weights are drawn with std 0.2, not BERT's 0.02, where the
files must be byte-identical: at 0.02 the tiny tower gives every text
nearly the same embedding and either package's float32 rounding orders
the ties (tests/test_torch_eval.py::models). Tolerances: ann files byte
for byte, dev metrics and the ndcg JSON 1e-6, params after training 1e-4
(tests/test_torch_ance.py::test_train_on_ann_file_matches_jax gives the
trajectory's rounding floor), except where a test says otherwise."""
import dataclasses
import json
import os
import shutil
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.data import records as jrec
from cocodr_tpu.data import streams as jstreams
from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu.optim import lamb as jax_lamb
from cocodr_tpu.optim import warmup_linear as jax_warmup_linear
from cocodr_tpu.pipelines import ance as jance
from cocodr_tpu.pipelines.train_step import TrainStepConfig as JaxStepConfig
from cocodr_tpu.pipelines.train_step import build_train_step as jax_step
from cocodr_tpu.utils.misc import read_group_results as jax_read_groups
from cocodr_tpu.utils.train_state import TrainState as JaxTrainState
from cocodr_tpu_torch.data import records as trec
from cocodr_tpu_torch.data import streams as tstreams
from cocodr_tpu_torch.losses.dro import DroConfig, dro_greedy_init
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig
from cocodr_tpu_torch.models.dual_encoder import (
    MODEL_REGISTRY,
    DualEncoder,
    build_dual_encoder,
)
from cocodr_tpu_torch.optim import Lamb, warmup_linear
from cocodr_tpu_torch.pipelines import ance as tance
from cocodr_tpu_torch.pipelines import train_step as ts
from cocodr_tpu_torch.utils import train_state as tstate
from cocodr_tpu_torch.utils.misc import read_group_results

torch.set_num_threads(1)

TOL = dict(rel=1e-6, abs=1e-6)
HEAD_DIM = 16
LR, WARMUP, TOTAL = 1e-3, 2, 10


def models(model_type="rdot_nll_condenser", seed=0, std=0.2):
    """(flax model, its params, the port's model on the same weights), the
    weights drawn with std `std`."""
    jcfg = dataclasses.replace(JaxBertConfig.tiny(), initializer_range=std)
    jmodel = jax_build(model_type, jcfg, head_dim=HEAD_DIM)
    ones = jnp.ones((1, 8), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(seed), ones, ones)["params"]
    cfg = MODEL_REGISTRY[model_type](BertConfig.tiny(), head_dim=HEAD_DIM)
    model = DualEncoder(cfg)
    model.load_state_dict(convert.params_from_jax(jax.device_get(params),
                                                  cfg))
    return jmodel, params, model


def dataset(tmp_path, n_queries=16, groups=0):
    """tests/test_ance.py's planted task: query i is tokens [i, i + 30],
    its positive passage shares the first, 32 distractors share none. With
    groups, the second token is the query's group's, four times (the
    embeddings then cluster by group). -> (query path, passage path,
    positives, dev qrels)."""
    rng = np.random.RandomState(0)
    qp, pp = str(tmp_path / "train-query"), str(tmp_path / "passages")
    with trec.RecordWriter(qp, 8) as w:
        for i in range(n_queries):
            tail = [60 + i % groups] * 4 if groups else [40 + i]
            w.write([2, 10 + i] + tail + [3])
    with trec.RecordWriter(pp, 8) as w:
        for i in range(n_queries):
            w.write([2, 10 + i, 65, 3])
        for _ in range(n_queries * 2):
            w.write([2, int(rng.randint(70, 120)), int(rng.randint(70, 120)),
                     3])
    positives = {i: i for i in range(n_queries)}
    return qp, pp, positives, {i: {i: 1} for i in range(n_queries)}


def caches(paths, package):
    cls = trec.TokenCache if package == "port" else jrec.TokenCache
    return cls(paths[0]), cls(paths[1])


def mine_cfg(**kw):
    base = dict(topk_training=12, negative_sample=6, n_splits=2,
                dev_topk=10, batch_size=8, q_chunk=8, mips_tile=16,
                exact_fp32=True)
    base.update(kw)
    return base


def mine_both(tmp_path, jmodel, params, model, paths, cfg, n=0, **kw):
    """The JAX mine and the port's on the same caches and weights -> (JAX
    metrics, port metrics, JAX out dir, port out dir)."""
    positives, qrels = paths[2], paths[3]
    outs = []
    for package in ("jax", "port"):
        qc, pc = caches(paths, package)
        out = str(tmp_path / f"ann_{package}")
        if package == "jax":
            m = jance.mine(jmodel, params, pc, qc, positives, qc, qrels, out,
                           n, jance.MineConfig(**cfg), **kw)
        else:
            m = tance.mine(model, None, pc, qc, positives, qc, qrels, out, n,
                           tance.MineConfig(**cfg), device="cpu", **kw)
        outs.append((m, out))
    return outs[0][0], outs[1][0], outs[0][1], outs[1][1]


def read(path):
    with open(path, "rb") as f:
        return f.read()


def assert_ndcg_files_match(a, b, n=0):
    ja = json.loads(read(jance.ann_ndcg_path(a, n)))
    jb = json.loads(read(tance.ann_ndcg_path(b, n)))
    assert ja.keys() == jb.keys() and ja["checkpoint"] == jb["checkpoint"]
    for k in ("ndcg", "mrr"):
        assert jb[k] == pytest.approx(ja[k], **TOL), k


# --- negatives and the ann file -------------------------------------------

@pytest.mark.parametrize("select_topk", [True, False])
def test_generate_negatives_matches_jax(select_topk):
    """Rows with -1 padding, repeated ids, the positive at several ranks or
    absent, a query without a positive: equal negatives and MRRs, and the
    two RandomStates left in the same state."""
    rng = np.random.RandomState(5)
    top = rng.randint(0, 12, size=(9, 10))
    top[1, 6:] = -1
    top[2, :4] = 3
    top[3, 0] = 7
    qids = np.arange(9) + 100
    positives = {100 + q: q for q in range(8)}  # query 108 has none
    cfg = dict(negative_sample=4, select_topk=select_topk)
    rj, rt = np.random.RandomState(1), np.random.RandomState(1)
    want = jance.generate_negatives(top, qids, positives,
                                    jance.MineConfig(**cfg), rj)
    got = tance.generate_negatives(top, qids, positives,
                                   tance.MineConfig(**cfg), rt)
    assert got == want and 108 not in got[0]
    assert all(len(v) == len(set(v)) and -1 not in v for v in got[0].values())
    assert rj.randint(1 << 30) == rt.randint(1 << 30)


@pytest.mark.parametrize("clusters", [False, True])
def test_write_ann_data_byte_identical(tmp_path, clusters):
    """The same negatives, positives and RandomState seed: the same bytes,
    with and without the weight / group columns (weights missing for
    some queries take 1.0); the lines parse as ann lines."""
    rng = np.random.RandomState(2)
    negatives = {q: rng.choice(50, rng.randint(0, 13), replace=False).tolist()
                 for q in range(20)}
    positives = {q: 50 + q for q in range(20)}
    kw = {}
    if clusters:
        kw = dict(clusters={q: q % 4 for q in range(20)},
                  weights={q: 0.5 + q / 40 for q in range(0, 20, 2)})
    cfg = dict(n_splits=3)
    a, b = str(tmp_path / "j"), str(tmp_path / "t")
    jance.write_ann_data(a, negatives, positives, jance.MineConfig(**cfg),
                         np.random.RandomState(3), **kw)
    tance.write_ann_data(b, negatives, positives, tance.MineConfig(**cfg),
                         np.random.RandomState(3), **kw)
    assert read(a) == read(b) and read(b)
    assert not os.path.exists(b + ".tmp")
    for line in open(b):
        qid, pos, negs, w, g = tstreams.parse_ann_line(line)
        assert pos == positives[qid] and len(negs) == len(negatives[qid]) // 3
        assert g == (qid % 4 if clusters else 0)


# --- mine -------------------------------------------------------------------

@pytest.mark.parametrize("method,exact_fp32", [("auto", True),
                                               ("pallas", False)])
def test_mine_matches_jax(tmp_path, method, exact_fp32):
    """One round through both packages without clustering: byte-identical
    ann files, ndcg JSONs and every dev metric to 1e-6. exact_fp32
    searches float32 operands in both; 'pallas' is the JAX package's
    kernel-free exact search of bf16 operands on the CPU and the port's
    plain K2 + K3 + rescore of the same bf16 operands over its padded
    corpus."""
    paths = dataset(tmp_path)
    jmodel, params, model = models()
    cfg = mine_cfg(exact_fp32=exact_fp32, search_method=method)
    want, got, a, b = mine_both(tmp_path, jmodel, params, model, paths, cfg,
                                checkpoint_name="ck")
    assert read(jance.ann_data_path(a, 0)) == read(tance.ann_data_path(b, 0))
    assert_ndcg_files_match(a, b)
    metrics = {k: v for k, v in want.items() if not k.startswith("time_")}
    for k, v in metrics.items():
        assert got[k] == pytest.approx(v, **TOL), k
    assert {k for k in got if k.startswith("time_")} == {
        "time_corpus_encode", "time_corpus_to_device", "time_dev_eval",
        "time_train_encode", "time_train_search", "time_negatives",
        "time_cluster", "time_write", "time_total"}
    assert got["ndcg_cut_10"] > 0.3  # the planted passages rank high


def test_mine_clustered_matches_jax_up_to_a_label_permutation(tmp_path):
    """cluster_query=True over queries planted in 4 groups: the JAX and the
    port's k-means start from other draws, and the ann files equal each
    other line for line up to one permutation of the group column, which
    is the planted grouping."""
    paths = dataset(tmp_path, groups=4)
    jmodel, params, model = models(seed=2)
    cfg = mine_cfg(cluster_query=True, cluster_centroids=4, kmeans_iters=20,
                   kmeans_redo=3)
    _, _, a, b = mine_both(tmp_path, jmodel, params, model, paths, cfg)
    ja = read(jance.ann_data_path(a, 0)).decode().splitlines()
    tb = read(tance.ann_data_path(b, 0)).decode().splitlines()
    assert len(ja) == len(tb) > 0
    perm = {}
    for la, lb in zip(ja, tb):
        fa, fb = la.split("\t"), lb.split("\t")
        assert fa[:4] == fb[:4]
        assert perm.setdefault(fa[4], fb[4]) == fb[4]
        assert int(fb[4]) in range(4)
    assert len(set(perm.values())) == len(perm) == 4
    groups = {int(lb.split("\t")[0]): lb.split("\t")[4] for lb in tb}
    assert all(groups[q] == groups[q % 4] for q in groups)


def test_mine_chunk_rotation_and_emb_cache_across_packages(tmp_path,
                                                           monkeypatch):
    """tests/test_async_and_multichunk.py:99 through the port: with
    ann_chunk_factor 2 round 0 mines the first half of the queries and
    round 1 the second. The emb cache is the JAX package's: a JAX round
    reads the port's corpus_{checkpoint}.npy (and writes the same ann
    file), and a port round reads the JAX one's without encoding the
    corpus."""
    paths = dataset(tmp_path, n_queries=8)
    jmodel, params, model = models()
    emb = str(tmp_path / "embs")
    cfg = mine_cfg(emb_cache_dir=emb, ann_chunk_factor=2)
    qc, pc = caches(paths, "port")
    out = str(tmp_path / "ann")
    for n, want in ((0, {0, 1, 2, 3}), (1, {4, 5, 6, 7})):
        tance.mine(model, None, pc, qc, paths[2], qc, paths[3], out, n,
                   tance.MineConfig(**cfg), checkpoint_name="ck-1",
                   device="cpu")
        qids = {int(line.split("\t")[0])
                for line in open(tance.ann_data_path(out, n))}
        assert qids == want
    assert os.listdir(emb) == ["corpus_ck-1.npy"]
    jqc, jpc = caches(paths, "jax")
    jout = str(tmp_path / "ann_jax")
    jance.mine(jmodel, params, jpc, jqc, paths[2], jqc, paths[3], jout, 1,
               jance.MineConfig(**cfg), checkpoint_name="ck-1")
    assert read(jance.ann_data_path(jout, 1)) == read(
        tance.ann_data_path(out, 1))
    jance.mine(jmodel, params, jpc, jqc, paths[2], jqc, paths[3], jout, 2,
               jance.MineConfig(**cfg), checkpoint_name="ck-2")
    calls = []
    real = tance.encode_cache
    monkeypatch.setattr(tance, "encode_cache",
                        lambda enc, cache, *a, **k: calls.append(cache)
                        or real(enc, cache, *a, **k))
    tance.mine(model, None, pc, qc, paths[2], qc, paths[3], out, 2,
               tance.MineConfig(**cfg), checkpoint_name="ck-2", device="cpu")
    assert pc not in calls and len(calls) == 2  # dev and train queries only
    assert read(jance.ann_data_path(jout, 2)) == read(
        tance.ann_data_path(out, 2))


def test_mine_emb_cache_pruning(tmp_path):
    """tests/test_async_and_multichunk.py:217 through the port:
    emb_cache_keep 2 keeps the two newest corpus caches."""
    paths = dataset(tmp_path, n_queries=8)
    _, _, model = models()
    qc, pc = caches(paths, "port")
    emb = str(tmp_path / "embs")
    cfg = tance.MineConfig(**mine_cfg(emb_cache_dir=emb, emb_cache_keep=2))
    for i in range(3):
        tance.mine(model, None, pc, qc, paths[2], qc, paths[3],
                   str(tmp_path / "ann"), i, cfg, checkpoint_name=f"ck-{i}",
                   device="cpu")
        time.sleep(0.05)  # distinct mtimes for the LRU order
    assert sorted(os.listdir(emb)) == ["corpus_ck-1.npy", "corpus_ck-2.npy"]


@pytest.mark.parametrize("method,exact_fp32", [
    ("auto", False), ("pallas", False), ("fast", False), ("exact2", False),
    ("blockmax", False), ("refined", False), ("naive", False),
    ("pallas", True), ("ivf", False)])
def test_mine_places_the_corpus_once(tmp_path, monkeypatch, method,
                                     exact_fp32):
    """Both searches of a round get one tensor: bf16 (float32 with
    exact_fp32), replicate-padded to a multiple of 2,048 rows with n_real =
    the real count for the methods that honour n_real ('auto' = 'pallas',
    'fast'), unpadded with n_real 0 for the others ('ivf' builds its
    index from those unpadded rows, and both searches get that one
    index); no negative is a pad row."""
    paths = dataset(tmp_path)
    _, _, model = models()
    qc, pc = caches(paths, "port")
    seen = []
    real = tance.search_topk

    def spy(queries, corpus, k, **kw):
        seen.append((corpus, kw["n_real"]))
        indexes.append(kw["ivf_index"])
        return real(queries, corpus, k, **kw)

    indexes = []

    monkeypatch.setattr(tance, "search_topk", spy)
    out = str(tmp_path / "ann")
    tance.mine(model, None, pc, qc, paths[2], qc, paths[3], out, 0,
               tance.MineConfig(**mine_cfg(exact_fp32=exact_fp32,
                                           search_method=method)),
               device="cpu")
    (dev_c, dev_n), (train_c, train_n) = seen
    assert dev_c is train_c and dev_n == train_n
    n_docs = len(pc)
    padded = not exact_fp32 and method in ("auto", "pallas", "fast")
    assert dev_c.dtype == (torch.float32 if exact_fp32 else torch.bfloat16)
    if padded:
        assert dev_c.shape[0] % 2048 == 0 and dev_n == n_docs
        assert torch.equal(dev_c[n_docs:],
                           dev_c[n_docs - 1:n_docs].expand_as(
                               dev_c[n_docs:]))
    else:
        assert dev_c.shape[0] == n_docs and dev_n == 0
    if method == "ivf":
        assert indexes[0] is indexes[1] and indexes[0].n_docs == n_docs
        real_ids = indexes[0].block_ids[indexes[0].block_ids >= 0]
        assert sorted(real_ids.tolist()) == list(range(n_docs))
    else:
        assert indexes == [None, None]
    for line in open(tance.ann_data_path(out, 0)):
        _, pos, negs, _, _ = tstreams.parse_ann_line(line)
        assert negs and all(0 <= p < n_docs and p != pos for p in negs)


def test_mine_ivf_at_full_probe_equals_an_exact_mine(tmp_path):
    """One round by 'ivf' at full probe writes the ann file of the exact
    search of the same bf16 operands ('pallas') byte for byte, with the
    same dev metrics (1e-6); the weights' std 0.2 keeps scores apart."""
    paths = dataset(tmp_path, n_queries=24)
    _, _, model = models()
    qc, pc = caches(paths, "port")
    got = {}
    for method in ("ivf", "pallas"):
        out = str(tmp_path / method)
        got[method] = tance.mine(
            model, None, pc, qc, paths[2], qc, paths[3], out, 0,
            tance.MineConfig(**mine_cfg(exact_fp32=False,
                                        search_method=method,
                                        ivf_nprobe=1000)),
            device="cpu")
    assert (read(tance.ann_data_path(str(tmp_path / "ivf"), 0))
            == read(tance.ann_data_path(str(tmp_path / "pallas"), 0)))
    assert "time_ivf_build" in got["ivf"]
    assert "time_ivf_build" not in got["pallas"]
    for k, v in got["pallas"].items():
        if not k.startswith("time_"):
            assert got["ivf"][k] == pytest.approx(v, **TOL), k


def test_place_corpus_uses_a_placed_tensor_in_place():
    """A tensor already on the device in the right dtype and row count is
    returned as it is; a numpy float32 corpus is cast, padded rows copy the
    last real one."""
    rng = np.random.RandomState(0)
    emb = rng.randn(3000, 8).astype(np.float32)
    t, n = tance.place_corpus(emb, "pallas", device="cpu")
    assert t.shape == (4096, 8) and t.dtype == torch.bfloat16 and n == 3000
    assert torch.equal(t[:3000], torch.from_numpy(emb).to(torch.bfloat16))
    assert torch.equal(t[3000:], t[2999:3000].expand(1096, 8))
    assert tance.place_corpus(t, "pallas", device="cpu") == (t, 4096)
    again = tance.place_corpus(t[:2048], "fast", device="cpu")
    assert again[0].data_ptr() == t.data_ptr() and again[1] == 2048
    f32, n = tance.place_corpus(emb, "exact2", exact_fp32=True,
                                device="cpu")
    assert f32.data_ptr() == emb.__array_interface__["data"][0] and n == 0


# --- the loops --------------------------------------------------------------

def nll_states(seed=0, lr_schedule=True):
    """(JAX state, JAX nll step, port state, port nll step) on the std-0.2
    tiny towers, LAMB with warmup-linear LR, eps 1e-6."""
    jmodel, params, model = models(seed=seed)
    tx = jax_lamb(jax_warmup_linear(LR, WARMUP, TOTAL), eps=1e-6)
    jstate = JaxTrainState.create(params, tx)
    jstep = jax_step(jmodel, tx, JaxStepConfig(loss_kind="nll"))
    state = tstate.TrainState(model, Lamb(model.parameters(), warmup_linear(
        LR, WARMUP, TOTAL), eps=1e-6))
    return jmodel, jstate, jstep, state, ts.build_train_step()


def test_ance_round_twice_matches_jax(tmp_path):
    """Two ance_rounds with the nll step, dropout off: each round's ann
    file byte-identical (round 1 mines with the weights after round 0's
    steps, checkpoint name step-3), dev metrics 1e-6, and the params after
    both rounds 1e-4."""
    paths = dataset(tmp_path)
    jmodel, jstate, jstep, state, step = nll_states()
    cfg = mine_cfg()
    jqc, jpc = caches(paths, "jax")
    tqc, tpc = caches(paths, "port")
    for rnd in range(2):
        jstate, jm, jn = jance.ance_round(
            jstate, jstep, jmodel, jstreams.TripletBatcher(jqc, jpc), jpc,
            jqc, paths[2], jqc, paths[3], str(tmp_path / "j"), rnd,
            jance.MineConfig(**cfg), batch_size=8, steps_per_round=3,
            dropout_seed=None)
        state, tm, tn = tance.ance_round(
            state, step, tstreams.TripletBatcher(tqc, tpc), tpc, tqc,
            paths[2], tqc, paths[3], str(tmp_path / "t"), rnd,
            tance.MineConfig(**cfg), batch_size=8, steps_per_round=3,
            dropout_seed=None, device="cpu")
        assert tn == jn == 3
        assert read(jance.ann_data_path(str(tmp_path / "j"), rnd)) == read(
            tance.ann_data_path(str(tmp_path / "t"), rnd))
        assert_ndcg_files_match(str(tmp_path / "j"), str(tmp_path / "t"),
                                rnd)
        assert tm["ndcg_cut_10"] == pytest.approx(jm["ndcg_cut_10"], **TOL)
    meta = json.loads(read(tance.ann_ndcg_path(str(tmp_path / "t"), 1)))
    assert meta["checkpoint"] == "step-3" and state.step == 6
    want = convert.params_from_jax(jax.device_get(jstate.params),
                                   state.model.cfg)
    for name, w in want.items():
        np.testing.assert_allclose(state.model.state_dict()[name].numpy(),
                                   w.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_ance_loop_improves(tmp_path):
    """tests/test_ance.py:62 through the port: three time-multiplexed
    rounds of dro-greedy training on mined, clustered negatives from that
    test's initial weights (BERT's std 0.02, carried over); some later
    round's dev nDCG beats the untrained round 0's, none collapses, and
    the ann files follow the protocol. Dropout is off here: the packages
    draw other masks from one seed, and this toy task's rounds swing with
    the masks in both (round 1's nDCG over dropout seeds 6-21 spans
    0.77-0.95 in the JAX package and 0.77-0.97 in the port, means 0.879
    and 0.869; at seed 3 the JAX loop itself ends at 0.63); without
    dropout the port's rounds equal the JAX package's (0.8707, 0.9769,
    then k-means's other init moves round 2)."""
    paths = dataset(tmp_path)
    model = models(std=0.02)[2]
    dcfg = DroConfig(n_groups=4, eps=0.01)
    state = tstate.TrainState(
        model, Lamb(model.parameters(), warmup_linear(3e-4, 5, 400)),
        extra=dro_greedy_init(dcfg, device="cpu"))
    step = ts.build_train_step(ts.TrainStepConfig(loss_kind="dro-greedy",
                                                  dro=dcfg))
    qc, pc = caches(paths, "port")
    cfg = tance.MineConfig(**mine_cfg(
        topk_training=10, negative_sample=5, n_splits=1, cluster_query=True,
        cluster_centroids=4, kmeans_iters=10, kmeans_redo=1, batch_size=16,
        q_chunk=16))
    work = str(tmp_path / "ann")
    ndcgs = []
    for rnd in range(3):
        state, m, steps = tance.ance_round(
            state, step, tstreams.TripletBatcher(qc, pc), pc, qc, paths[2],
            qc, paths[3], work, rnd, cfg, batch_size=16, steps_per_round=12,
            dropout_seed=None, device="cpu")
        ndcgs.append(m["ndcg_cut_10"])
        assert steps > 0
    n, data_path, meta = tance.get_latest_ann_data(work)
    assert n == 2 and "ndcg" in meta and "checkpoint" in meta
    with open(data_path) as f:
        qid, pos, negs, w, g = tstreams.parse_ann_line(f.readline())
    assert 0 <= g < 4 and len(negs) >= 1
    assert max(ndcgs[1:]) > ndcgs[0], ndcgs
    assert min(ndcgs) >= 0.5, ndcgs


def test_async_producer_consumer(tmp_path):
    """tests/test_async_and_multichunk.py:54 through the port: mine_loop
    and train_loop coupled only through the filesystem. The first round
    mines from checkpoint-0, training writes checkpoint-3, whose weights
    the loader returns (equal to the state's), and the second round mines
    from it; an empty checkpoint dir yields the template's weights."""
    paths = dataset(tmp_path, n_queries=8)
    _, _, _, state, step = nll_states()
    qc, pc = caches(paths, "port")
    kw = dict(passage_cache=pc, train_query_cache=qc,
              train_positives=paths[2], dev_query_cache=qc,
              dev_qrels=paths[3],
              cfg=tance.MineConfig(**mine_cfg(n_splits=1)), device="cpu")
    ckpt, ann = str(tmp_path / "ckpts"), str(tmp_path / "ann")
    name, weights = tance.checkpoint_params_loader(ckpt, state)()
    assert name == "initial"
    assert all(torch.equal(weights[k], v)
               for k, v in state.model.state_dict().items())
    assert tance.checkpoint_params_loader(ckpt, state, initial=False)() is None
    tstate.save_checkpoint(ckpt, state)
    loader = tance.checkpoint_params_loader(ckpt, state)
    tance.mine_loop(state.model, loader, ann, poll_secs=0.01, max_rounds=1,
                    **kw)
    n, _, meta = tance.get_latest_ann_data(ann)
    assert n == 0 and meta["checkpoint"] == "checkpoint-0"
    state2 = tance.train_loop(
        state, step, tstreams.TripletBatcher(qc, pc), ann, ckpt,
        batch_size=8, poll_secs=0.01, max_ann_files=1, steps_per_file=3)
    assert state2.step == 3
    name, weights = loader()
    assert name == "checkpoint-3"
    assert weights.keys() == state2.model.state_dict().keys()
    assert all(torch.equal(weights[k], v)
               for k, v in state2.model.state_dict().items())
    tance.mine_loop(state.model, loader, ann, poll_secs=0.01, max_rounds=1,
                    **kw)
    n, _, meta = tance.get_latest_ann_data(ann)
    assert n == 1 and meta["checkpoint"] == name


def write_ann_round(work, n, n_queries=8, negs_per=4):
    """tests/test_lifecycle.py's ann round n: query q, positive q,
    negatives drawn from the other passages."""
    os.makedirs(work, exist_ok=True)
    rng = np.random.RandomState(n)
    with open(os.path.join(work, f"ann_training_data_{n}"), "w") as f:
        for q in range(n_queries):
            negs = ",".join(str(int(x)) for x in rng.choice(
                np.arange(n_queries, 3 * n_queries), negs_per, replace=False))
            f.write(f"{q}\t{q}\t{negs}\n")
    with open(os.path.join(work, f"ann_ndcg_{n}"), "w") as f:
        json.dump({"ndcg": 0.1 * (n + 1), "mrr": 0.2,
                   "checkpoint": f"ck{n}"}, f)


def test_train_loop_kill_and_restart_resumes_identically(tmp_path):
    """tests/test_lifecycle.py:112 through the port, dropout on: consume
    file 0, 'crash', restart from disk and consume file 1; the model and
    LAMB state equal the uninterrupted run's bit for bit. The metrics
    logger gets the mined ndcg and the file's steps."""
    from cocodr_tpu_torch.utils.logging import MetricsLogger

    qp, pp = str(tmp_path / "tq"), str(tmp_path / "tp")
    with trec.RecordWriter(qp, 8) as w:
        for i in range(8):
            w.write([2, 10 + i, 3])
    with trec.RecordWriter(pp, 8) as w:
        for i in range(24):
            w.write([2, 40 + i, 3])
    batcher = tstreams.TripletBatcher(trec.TokenCache(qp),
                                      trec.TokenCache(pp))
    step = ts.build_train_step()

    def fresh():
        model = build_dual_encoder("rdot_nll", BertConfig.tiny(),
                                   device="cpu")
        return tstate.TrainState(model, Lamb(model.parameters(), 1e-3))

    work, ck_a, ck_b = (str(tmp_path / d) for d in ("ann", "ck_a", "ck_b"))
    write_ann_round(work, 0)
    log = str(tmp_path / "m.jsonl")
    logger = MetricsLogger(jsonl_path=log)
    state_a = tance.train_loop(fresh(), step, batcher, work, ck_a,
                               batch_size=4, max_ann_files=1,
                               steps_per_file=2, resume=False,
                               poll_secs=0.01, metrics_logger=logger)
    logger.close()
    shutil.copytree(ck_a, ck_b)
    write_ann_round(work, 1)
    state_a2 = tance.train_loop(state_a, step, batcher, work, ck_a,
                                batch_size=4, max_ann_files=1,
                                steps_per_file=2, resume=False,
                                poll_secs=0.01)
    state_b2 = tance.train_loop(fresh(), step, batcher, work, ck_b,
                                batch_size=4, max_ann_files=1,
                                steps_per_file=2, resume=True,
                                poll_secs=0.01)
    assert state_a2.step == state_b2.step == 4
    for (k, a), b in zip(state_a2.model.state_dict().items(),
                         state_b2.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa = state_a2.optimizer.state_dict()["state"]
    sb = state_b2.optimizer.state_dict()["state"]
    for i in sa:
        for k in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][k]),
                               torch.as_tensor(sb[i][k])), (i, k)
    assert tance._read_progress(ck_b) == 1
    recs = [json.loads(line) for line in open(log)]
    assert recs == [{"step": 0, "ance/dev_ndcg": 0.1, "ance/dev_mrr": 0.2},
                    {"step": 2, "ance/ann_file": 0.0, "ance/steps": 2.0}]


def test_train_loop_logs_dro_state_and_group_curves(tmp_path):
    """With a DroState the file's record carries dro_state_summary's
    scalars, and the mined record the newest group ndcg of each BEIR task
    found (write_group_ndcg's files); the JAX reader reads those files
    alike."""
    from cocodr_tpu_torch.utils.logging import MetricsLogger

    qp, pp = str(tmp_path / "tq"), str(tmp_path / "tp")
    with trec.RecordWriter(qp, 8) as w:
        for i in range(8):
            w.write([2, 10 + i, 3])
    with trec.RecordWriter(pp, 8) as w:
        for i in range(24):
            w.write([2, 40 + i, 3])
    groups = str(tmp_path / "groups")
    tance.write_group_ndcg(groups, "scifact", 0, 0.7, checkpoint="a")
    tance.write_group_ndcg(groups, "scifact", 2, 0.72, checkpoint="b")
    tance.write_group_ndcg(groups, "fiqa", 1, 0.3)
    assert read_group_results(groups) == jax_read_groups(groups) == {
        "scifact": {"ndcg": 0.72, "checkpoint": "b"},
        "fiqa": {"ndcg": 0.3, "checkpoint": ""}}
    model = build_dual_encoder("rdot_nll", BertConfig.tiny(), device="cpu")
    dcfg = DroConfig(n_groups=4)
    state = tstate.TrainState(model, Lamb(model.parameters(), 1e-3),
                              extra=dro_greedy_init(dcfg, device="cpu"))
    work = str(tmp_path / "ann")
    write_ann_round(work, 0)
    log = str(tmp_path / "m.jsonl")
    logger = MetricsLogger(jsonl_path=log)
    tance.train_loop(
        state, ts.build_train_step(ts.TrainStepConfig(
            loss_kind="dro-greedy", dro=dcfg)),
        tstreams.TripletBatcher(trec.TokenCache(qp), trec.TokenCache(pp)),
        work, str(tmp_path / "ck"), batch_size=4, max_ann_files=1,
        steps_per_file=1, metrics_logger=logger, group_result_dir=groups)
    logger.close()
    mined, trained = [json.loads(line) for line in open(log)]
    assert mined["ance/ann_ndcg_group_scifact"] == 0.72
    assert mined["ance/ann_ndcg_group_fiqa"] == 0.3
    assert {"ance/dro_h_min", "ance/dro_h_max", "ance/dro_h_entropy",
            "ance/dro_loss_ema_mean"} <= trained.keys()


@pytest.mark.parametrize("n_q,n_docs,dim,k", [
    (700, 2048, 768, 200),  # no super level, two rescore chunks
    (9, 40_000, 32, 10),  # the super level: two selections a chunk
    (20, 5000, 16, 100)])  # pad rows, a chunk of 8 and its tail
def test_chip_smoke_counts_k3_as_the_search_launches(monkeypatch, n_q,
                                                     n_docs, dim, k):
    """chip_smoke.py's pallas_k3_launches against the K3 calls that a
    'pallas' search_topk over a placed corpus makes on the CPU (its plain
    version counted here as the wrapper counts launches on the card)."""
    import chip_smoke
    from cocodr_tpu_torch.ops import mips_hier
    from cocodr_tpu_torch.parallel.topk import search_topk

    calls = []
    real = mips_hier.topk_reference
    monkeypatch.setattr(mips_hier, "topk_reference",
                        lambda *a: calls.append(1) or real(*a))
    rng = np.random.RandomState(0)
    corpus, n_real = tance.place_corpus(
        rng.randn(n_docs, dim).astype(np.float32), device="cpu")
    q_chunk = 8 if n_q == 20 else 4096
    search_topk(rng.randn(n_q, dim).astype(np.float32), corpus, k,
                q_chunk=q_chunk, n_real=n_real, device="cpu")
    assert len(calls) == chip_smoke.pallas_k3_launches(
        n_q, q_chunk, *corpus.shape, n_real, k)
