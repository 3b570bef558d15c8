"""Multi-chunk documents (`rdot_nll_multi_chunk`, documents of several
chunks of chunk_len tokens, one vector a chunk) in the port against the
JAX package on the CPU, float32, at chunk_len 8: `_multi_chunk_emb`,
`chunk_max_score` and `triplet_nll_multichunk`; the 'nll_multichunk'
trajectory and the chunked iDRO step (the JAX lane step);
`encode_cache_multivector`; `eval_beir` and `mine` over a multi-chunk
corpus, the `_mv` emb cache included. Tolerances: 2e-5 in a forward,
1e-5 in trajectories, 1e-6 in metrics (float32 sums in another order);
ann files byte for byte."""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.data import records as jrec
from cocodr_tpu.losses import DroConfig as JaxDroConfig
from cocodr_tpu.losses import idro_init as jax_idro_init
from cocodr_tpu.losses.nll import triplet_nll_multichunk as jax_nll_mc
from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu.models.dual_encoder import chunk_max_score as jax_cms
from cocodr_tpu.optim import lamb as jax_lamb
from cocodr_tpu.optim import warmup_linear as jax_warmup_linear
from cocodr_tpu.pipelines import ance as jance
from cocodr_tpu.pipelines import encode as jenc
from cocodr_tpu.pipelines import eval_beir as jeb
from cocodr_tpu.pipelines.train_step import TrainStepConfig as JaxStepConfig
from cocodr_tpu.pipelines.train_step import build_train_step as jax_step
from cocodr_tpu.utils.train_state import TrainState as JaxTrainState
from cocodr_tpu_torch.data import records as trec
from cocodr_tpu_torch.losses.dro import DroConfig, idro_init
from cocodr_tpu_torch.losses.nll import triplet_nll_multichunk
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig
from cocodr_tpu_torch.models.dual_encoder import (
    MODEL_REGISTRY,
    DualEncoder,
    chunk_max_score,
)
from cocodr_tpu_torch.optim import Lamb, warmup_linear
from cocodr_tpu_torch.pipelines import ance as tance
from cocodr_tpu_torch.pipelines import encode as tenc
from cocodr_tpu_torch.pipelines import eval_beir as teb
from cocodr_tpu_torch.pipelines import train_step as ts
from cocodr_tpu_torch.utils import train_state as tstate

transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)

FWD = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-5, atol=1e-5)
METRIC = dict(rel=1e-6, abs=1e-6)
L, C, G, B, SQ, VOCAB, HEAD_DIM = 8, 3, 4, 8, 6, 128, 16
LR, WARMUP, TOTAL = 1e-3, 3, 10


def models(seed=0, std=0.02, roberta=False):
    """(flax rdot_nll_multi_chunk model at base_len L, its params, the
    port's model on the same weights, its config). std 0.2 where a search
    must not meet ties (tests/test_torch_eval.py::models)."""
    jcfg = dataclasses.replace(JaxBertConfig.tiny(), initializer_range=std)
    cfg = BertConfig.tiny()
    if roberta:
        rob = dict(position_style="roberta", pad_token_id=1,
                   type_vocab_size=1, layer_norm_eps=1e-5)
        jcfg = dataclasses.replace(jcfg, **rob)
        cfg = dataclasses.replace(cfg, **rob)
    jmodel = jax_build("rdot_nll_multi_chunk", jcfg, base_len=L,
                       head_dim=HEAD_DIM)
    ones = jnp.ones((1, L), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(seed), ones, ones)["params"]
    mcfg = MODEL_REGISTRY["rdot_nll_multi_chunk"](cfg, base_len=L,
                                                  head_dim=HEAD_DIM)
    model = DualEncoder(mcfg)
    model.load_state_dict(convert.params_from_jax(jax.device_get(params),
                                                  mcfg))
    return jmodel, params, model, mcfg


def docs(rng, n, lens=None):
    """[n, C * L] documents of random lengths (some chunks all padding,
    one document a single token) and their masks."""
    if lens is None:
        lens = rng.randint(1, C * L + 1, size=n)
        lens[0] = 1
    ids = rng.randint(3, VOCAB, size=(n, C * L)).astype(np.int32)
    mask = (np.arange(C * L)[None, :] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


def chunk_mask(mask):
    return mask.reshape(mask.shape[0], C, L).sum(-1) > 0


@pytest.mark.parametrize("roberta", [False, True])
def test_multi_chunk_emb_matches_flax(roberta):
    """body_emb over documents wider than chunk_len folds the chunks into
    the batch -> [B, C, D] equal to flax's (2e-5), all-pad chunks
    included; a document of one chunk's width gives [B, D], and the query
    tower [B, D]."""
    jmodel, params, model, _ = models(roberta=roberta)
    rng = np.random.RandomState(1)
    ids, mask = docs(rng, 5)
    for a, m in ((ids, mask), (ids[:, :L], mask[:, :L])):
        for tower in ("body_emb", "query_emb"):
            want = jmodel.apply({"params": params}, jnp.asarray(a),
                                jnp.asarray(m), method=getattr(jmodel, tower))
            with torch.no_grad():
                got = getattr(model.eval(), tower)(torch.from_numpy(a).long(),
                                                   torch.from_numpy(m))
            wide = tower == "body_emb" and a.shape[1] > L
            assert got.shape == ((5, C, HEAD_DIM) if wide else (5, HEAD_DIM))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_chunk_max_score_and_loss_match_jax():
    """chunk_max_score (float32 sums, -9999 on padded chunks) and
    triplet_nll_multichunk's loss, accuracy and logits equal the JAX
    functions' (1e-6), and so do the loss's gradients by q and by each
    document's chunks (jax.grad)."""
    rng = np.random.RandomState(2)
    q = rng.randn(B, HEAD_DIM).astype(np.float32)
    pos, neg = (rng.randn(B, C, HEAD_DIM).astype(np.float32)
                for _ in range(2))
    pm, nm = (rng.rand(B, C) < 0.6 for _ in range(2))
    pm[:, 0] = nm[:, 0] = True
    pm[1] = [True, False, False]
    s = chunk_max_score(torch.from_numpy(q), torch.from_numpy(pos),
                        torch.from_numpy(pm))
    np.testing.assert_allclose(s.numpy(), np.asarray(jax_cms(q, pos, pm)),
                               rtol=1e-6, atol=1e-6)

    def jax_loss(q, a, b):
        return jax_nll_mc(q, a, pm, b, nm)[0].sum()

    want = jax_nll_mc(q, pos, pm, neg, nm)
    want_g = jax.grad(jax_loss, argnums=(0, 1, 2))(q, pos, neg)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, pos, neg)]
    got = triplet_nll_multichunk(t[0], t[1], torch.from_numpy(pm), t[2],
                                 torch.from_numpy(nm))
    got[0].sum().backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-6)
    for x, w in zip(t, want_g):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def batches(n, seed=0, groups=False):
    """Queries of SQ tokens and documents of C chunks, with per-sample
    weights (and groups)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = {}
        ids = rng.randint(1, VOCAB, size=(B, SQ)).astype(np.int32)
        lens = rng.randint(SQ // 2, SQ + 1, size=B)
        b["q_mask"] = (np.arange(SQ)[None, :] < lens[:, None]).astype(np.int32)
        b["q_ids"] = ids * b["q_mask"]
        for k in ("pos", "neg"):
            b[f"{k}_ids"], b[f"{k}_mask"] = docs(rng, B)
        b["weights"] = rng.uniform(0.5, 1.5, size=B).astype(np.float32)
        if groups:
            b["groups"] = rng.randint(0, G, size=B).astype(np.int32)
        out.append(b)
    return out


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def states(kind, seed=0, **step_kw):
    """(JAX state and step, port state and step, the port's config)."""
    jmodel, params, model, mcfg = models(seed)
    dro = kind in ts.DRO_KINDS
    tx = jax_lamb(jax_warmup_linear(LR, WARMUP, TOTAL), eps=1e-6)
    jstate = JaxTrainState.create(
        params, tx, extra=jax_idro_init(JaxDroConfig(n_groups=G))
        if dro else None)
    jstep = jax_step(jmodel, tx, JaxStepConfig(
        loss_kind=kind, dro=JaxDroConfig(n_groups=G) if dro else None,
        **step_kw))
    state = tstate.TrainState(
        model, Lamb(model.parameters(), warmup_linear(LR, WARMUP, TOTAL),
                    eps=1e-6),
        extra=idro_init(DroConfig(n_groups=G), device="cpu") if dro else None)
    step = ts.build_train_step(ts.TrainStepConfig(
        loss_kind=kind, dro=DroConfig(n_groups=G) if dro else None,
        **step_kw))
    return jstate, jstep, state, step, mcfg


def assert_params_match(jax_params, model, cfg):
    want = convert.params_from_jax(jax.device_get(jax_params), cfg)
    got = model.state_dict()
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), **TOL,
                                   err_msg=name)


def test_nll_multichunk_trajectory_matches_jax():
    """10 steps of 'nll_multichunk' (tests/test_train_step.py:119's kind:
    per-sample weights, documents with all-pad chunks, dropout off): the
    losses and accuracies, and the final params (1e-5); they move. Tokens
    under a zero mask change nothing (the padded-chunk invariance of that
    test)."""
    jstate, jstep, state, step, cfg = states("nll_multichunk")
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    jl, tl = [], []
    for b in batches(10):
        jstate, m = jstep(jstate, to_jax(b))
        loss, acc = step(state, to_torch(b))
        jl.append(float(m["loss"]))
        tl.append(float(loss))
        assert float(acc) == float(m["acc"])
    np.testing.assert_allclose(tl, jl, **TOL)
    assert_params_match(jstate.params, state.model, cfg)
    moved = max((state.model.state_dict()[k] - v).abs().max().item()
                for k, v in start.items())
    assert moved > 1e-3
    b = batches(1, seed=3)[0]
    garbage = dict(b, pos_ids=np.where(b["pos_mask"] > 0, b["pos_ids"], 7))
    with torch.no_grad():
        a = ts.nll_loss(state.model, to_torch(b))[0]
        g = ts.nll_loss(state.model, to_torch(garbage))[0]
    assert torch.equal(a, g)


def test_chunked_idro_matches_jax_lane_step():
    """iDRO over multi-chunk documents: the JAX package sends a chunk_len
    model to its lane step (bf16 rows); the port's routes there too and
    scores the per-sample losses by the best real chunk. 3 steps at K = 1
    of 2 (tests/test_train_step.py:341's case): robust losses, group
    statistics, h_fun and the final params (1e-5)."""
    jstate, jstep, state, step, cfg = states("idro", idro_last_k_layers=1)
    assert ts.lane_group_pass(state.model, ts.TrainStepConfig())
    for b in batches(3, seed=4, groups=True):
        jstate, jm = jstep(jstate, to_jax(b))
        m = step(state, to_torch(b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **TOL)
        assert float(m["acc"]) == float(jm["acc"])
        for k in ("group_losses", "group_counts"):
            np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                       **TOL)
        np.testing.assert_allclose(state.extra.h_fun.numpy(),
                                   np.asarray(jstate.extra.h_fun), **TOL)
    assert_params_match(jstate.params, state.model, cfg)
    params = list(state.model.parameters())
    assert all(p.grad is not None for p in params)


@pytest.mark.parametrize("kind", ["nll", "dro-greedy"])
def test_single_vector_kinds_refuse_chunked_documents(kind):
    """'nll' and 'dro-greedy' on multi-chunk documents raise ValueError
    (the JAX step would feed [B, C, D] into the single-vector NLL), and
    the model is left as it was."""
    _, _, state, step, _ = states(kind)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    b = batches(1, groups=True)[0]
    with pytest.raises(ValueError, match="multi-chunk"):
        step(state, to_torch(b))
    assert state.step == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def write_docs(path, lengths, seed=0):
    rng = np.random.RandomState(seed)
    with trec.RecordWriter(path, C * L) as w:
        for n in lengths:
            w.write([2] + rng.randint(5, VOCAB, size=n - 1).tolist())
    return path


def test_encode_cache_multivector_matches_jax(tmp_path):
    """13 records of 1..24 tokens at batch 4 (a ragged last batch padded
    by repeating its final index): one row a chunk whose first mask slot
    is 1, rows equal the JAX function's (2e-5), row2doc equal; the rows
    are the documents' chunks in order. tests/test_async_and_multichunk.
    py:124's two records give row2doc [0, 0, 1]."""
    jmodel, params, model, _ = models(seed=1)
    lengths = [1, 8, 9, 24, 16, 17, 3, 12, 23, 8, 2, 15, 20]
    path = write_docs(str(tmp_path / "docs"), lengths)
    ecfg = tenc.EncodeConfig(batch_size=4)
    emb, row2doc = tenc.encode_cache_multivector(
        tenc.Encoder(model, is_query=False, device="cpu"),
        trec.TokenCache(path), ecfg, chunk_len=L)
    want, want_rows = jenc.encode_cache_multivector(
        jenc.Encoder(jmodel, params, is_query=False), jrec.TokenCache(path),
        jenc.EncodeConfig(batch_size=4), chunk_len=L)
    np.testing.assert_array_equal(row2doc, want_rows)
    assert row2doc.dtype == want_rows.dtype
    np.testing.assert_array_equal(
        row2doc, np.repeat(np.arange(13), [-(-n // L) for n in lengths]))
    assert emb.dtype == np.float32 and emb.shape == (len(row2doc), HEAD_DIM)
    np.testing.assert_allclose(emb, want, **FWD)

    with trec.RecordWriter(str(tmp_path / "two"), 2 * L) as w:
        w.write([2, 5, 6, 3, 2, 7, 8, 3, 2, 5, 7, 3])
        w.write([2, 5, 6, 3])
    _, rows = tenc.encode_cache_multivector(
        tenc.Encoder(model, device="cpu"), trec.TokenCache(str(tmp_path /
                                                              "two")),
        tenc.EncodeConfig(batch_size=2), chunk_len=L)
    np.testing.assert_array_equal(rows, [0, 0, 1])


WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa"]


def write_task(root, n_docs=20):
    """tests/test_eval_pipeline.py's planted task with longer documents
    (doc i repeats word i % 10 up to 17 times, so some reach a second
    chunk)."""
    data = root / "task"
    (data / "qrels").mkdir(parents=True)
    with open(data / "corpus.jsonl", "w") as f:
        for i in range(n_docs):
            text = " ".join([WORDS[i % 10]] * (3 + i % 15)
                            + [WORDS[(i * 3) % 10]] * (i % 3))
            f.write(json.dumps({"_id": f"d{i}", "title": "",
                                "text": text}) + "\n")
    with open(data / "queries.jsonl", "w") as f:
        for j, w in enumerate(WORDS):
            f.write(json.dumps({"_id": f"q{j}", "text": w}) + "\n")
    with open(data / "qrels" / "test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for j in range(10):
            for i in range(n_docs):
                if i % 10 == j:
                    f.write(f"q{j}\td{i}\t1\n")
    return str(data)


def test_eval_beir_multichunk_matches_jax(tmp_path):
    """eval_beir over documents of 2 chunks of 8 (tests/test_eval_pipeline.
    py:101's case): the corpus indexed one row a real chunk, rows mapped
    to documents and deduped; the metrics equal the JAX eval's (1e-6).
    length_buckets is ignored with the JAX package's warning."""
    vocab = "[PAD] [UNK] [CLS] [SEP] [MASK]".split() + WORDS
    (tmp_path / "vocab.txt").write_text("\n".join(vocab))
    tok = transformers.BertTokenizerFast(
        vocab_file=str(tmp_path / "vocab.txt"), do_lower_case=True)
    data = write_task(tmp_path)
    jmodel, params, model, _ = models(std=0.2)
    kw = dict(task="synthetic-mc", batch_size=8, top_k=20, mips_tile=16,
              q_chunk=4, query_len=8, doc_len=2 * L, exact_fp32=True)
    want = jeb.eval_beir(jmodel, params, data, str(tmp_path / "j"), tok,
                         **kw)
    got = teb.eval_beir(model, data, str(tmp_path / "t"), tok, device="cpu",
                        **kw)
    assert got["num_queries"] == 10
    for k in want:
        assert got[k] == pytest.approx(want[k], **METRIC), k
    with pytest.warns(UserWarning, match="length_buckets is ignored"):
        buck = teb.eval_beir(model, data, str(tmp_path / "t"), tok,
                             device="cpu", length_buckets=(8, 16), **kw)
    assert buck == got


def mine_dataset(tmp_path, n_q=8):
    """Queries [2, 10 + i, 40 + i, 3]; passage i (the positive of query i)
    holds 10 + i in its first chunk and 40 + i in its second; 16
    distractors of 3..16 tokens."""
    rng = np.random.RandomState(0)
    qp, pp = str(tmp_path / "q"), str(tmp_path / "p")
    with trec.RecordWriter(qp, 8) as w:
        for i in range(n_q):
            w.write([2, 10 + i, 40 + i, 3])
    with trec.RecordWriter(pp, 2 * L) as w:
        for i in range(n_q):
            w.write([2, 10 + i, 65, 66, 67, 68, 69, 3, 2, 40 + i, 3])
        for _ in range(2 * n_q):
            w.write([2] + rng.randint(70, 120, size=rng.randint(2, 16))
                    .tolist())
    return qp, pp, {i: i for i in range(n_q)}, {i: {i: 1}
                                                for i in range(n_q)}


def test_mine_multichunk_matches_jax(tmp_path, monkeypatch):
    """One mining round over a multi-chunk corpus in each package
    (tests/test_async_and_multichunk.py:180's case): the ann files equal
    byte for byte, their negatives are document ids (< 24) and not the
    positive; the ndcg JSON and dev metrics 1e-6. Both write the emb cache
    as corpus_ck-1_mv.npy and its .rows.npy map, rows 2e-5 and map equal;
    a second port round on the JAX package's cache reads it and writes the
    same ann file."""
    jmodel, params, model, _ = models(std=0.2)
    qp, pp, positives, qrels = mine_dataset(tmp_path)
    cfg = dict(topk_training=20, negative_sample=6, n_splits=2, dev_topk=10,
               batch_size=4, q_chunk=4, mips_tile=16, exact_fp32=True)
    out = {}
    for pkg, mod, cache in (("jax", jance, jrec.TokenCache),
                            ("port", tance, trec.TokenCache)):
        pc, qc = cache(pp), cache(qp)
        emb_dir = str(tmp_path / f"emb_{pkg}")
        args = (pc, qc, positives, qc, qrels, str(tmp_path / pkg), 0,
                mod.MineConfig(emb_cache_dir=emb_dir, **cfg))
        if pkg == "jax":
            m = jance.mine(jmodel, params, *args, checkpoint_name="ck-1")
        else:
            m = tance.mine(model, None, *args, checkpoint_name="ck-1",
                           device="cpu")
        out[pkg] = (m, str(tmp_path / pkg), emb_dir)
    (jm, jdir, jemb), (tm, tdir, temb) = out["jax"], out["port"]
    ann = "ann_training_data_0"
    with open(os.path.join(jdir, ann), "rb") as a, \
            open(os.path.join(tdir, ann), "rb") as b:
        assert a.read() == b.read()
    lines = open(os.path.join(tdir, ann)).read().splitlines()
    assert lines
    for line in lines:
        qid, pos, negs = line.split("\t")[:3]
        negs = [int(x) for x in negs.split(",")]
        assert all(0 <= n < 24 for n in negs) and int(pos) not in negs
    for k, v in jm.items():
        if not k.startswith("time_"):
            assert tm[k] == pytest.approx(v, **METRIC), k
    for f in ("corpus_ck-1_mv.npy", "corpus_ck-1_mv.rows.npy"):
        a, b = np.load(os.path.join(jemb, f)), np.load(os.path.join(temb, f))
        np.testing.assert_allclose(b, a, **FWD)
    jn = json.load(open(jance.ann_ndcg_path(jdir, 0)))
    tn = json.load(open(tance.ann_ndcg_path(tdir, 0)))
    assert tn["ndcg"] == pytest.approx(jn["ndcg"], **METRIC)
    assert tn["mrr"] == pytest.approx(jn["mrr"], **METRIC)

    shutil.rmtree(temb)
    shutil.copytree(jemb, temb)
    monkeypatch.setattr(tance, "encode_cache_multivector", None)  # unused
    tance.mine(model, None, trec.TokenCache(pp), trec.TokenCache(qp),
               positives, trec.TokenCache(qp), qrels, str(tmp_path / "p2"), 0,
               tance.MineConfig(emb_cache_dir=temb, **cfg),
               checkpoint_name="ck-1", device="cpu")
    with open(os.path.join(jdir, ann), "rb") as a, \
            open(os.path.join(tmp_path / "p2", ann), "rb") as b:
        assert a.read() == b.read()
