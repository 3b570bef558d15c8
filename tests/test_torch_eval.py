"""The port's evaluation path against the JAX package's on the CPU: BEIR
tokenization (data/preprocess.py) byte for byte, `eval_beir` on converted
weights (pipelines/eval_beir.py), `load_top_dev` / `combined_mrr` /
`full_ranking_mrr` (evals/mrr_eval.py), and the rule that an eval leaves a
model under training as it was (pipelines/encode.py::Encoder)."""
import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.data import records as jrec
from cocodr_tpu.evals import mrr_eval as jmrr
from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu.pipelines import eval_beir as jeb
from cocodr_tpu_torch.data import records as trec
from cocodr_tpu_torch.evals import mrr_eval as tmrr
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig
from cocodr_tpu_torch.models.dual_encoder import MODEL_REGISTRY, DualEncoder
from cocodr_tpu_torch.pipelines import eval_beir as teb

transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)

TOL = dict(rel=1e-6, abs=1e-6)
WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa"]


@pytest.fixture()
def tokenizer(tmp_path):
    vocab = "[PAD] [UNK] [CLS] [SEP] [MASK]".split() + WORDS
    vp = tmp_path / "vocab.txt"
    vp.write_text("\n".join(vocab))
    return transformers.BertTokenizerFast(vocab_file=str(vp),
                                          do_lower_case=True)


def write_task(root, n_docs=30, titles=False, noisy=False):
    """tests/test_eval_pipeline.py's planted task: doc i repeats word i % 10,
    query j is word j and its relevant docs are those of word j. titles
    gives every other doc a title; noisy adds robust04's characters."""
    data = root / "task"
    (data / "qrels").mkdir(parents=True)
    with open(data / "corpus.jsonl", "w") as f:
        for i in range(n_docs):
            w = WORDS[i % len(WORDS)]
            text = " ".join([w] * (3 + i % 7))
            if noisy:
                text = f"{text} #{i}; {w.upper()}=(x)!"
            title = f"Title {WORDS[(i + 3) % 10]}" if titles and i % 2 else ""
            f.write(json.dumps({"_id": f"d{i}", "title": title,
                                "text": text}) + "\n")
    with open(data / "queries.jsonl", "w") as f:
        for j, w in enumerate(WORDS):
            f.write(json.dumps({"_id": f"q{j}", "text": f"{w}?= {w}"}) + "\n")
        f.write(json.dumps({"_id": "unjudged", "text": "beta"}) + "\n")
    with open(data / "qrels" / "test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for j in range(len(WORDS)):
            for i in range(n_docs):
                if i % len(WORDS) == j:
                    f.write(f"q{j}\td{i}\t{1 + i % 2}\n")
    return str(data)


def models(model_type="rdot_nll_condenser", seed=0):
    """(flax model, its params, the port's model on the same weights). The
    weights are drawn with std 0.2, not BERT's 0.02: at 0.02 the tiny
    tower gives every text nearly the same embedding (scores 1e-6 apart,
    exact ties in float32), and either package's float32 rounding picks
    the order; at 0.2 adjacent scores are >= 6e-5 apart."""
    jcfg = dataclasses.replace(JaxBertConfig.tiny(), initializer_range=0.2)
    jmodel = jax_build(model_type, jcfg, head_dim=16)
    ones = jnp.ones((1, 8), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(seed), ones, ones)["params"]
    cfg = MODEL_REGISTRY[model_type](BertConfig.tiny(), head_dim=16)
    model = DualEncoder(cfg)
    model.load_state_dict(convert.params_from_jax(jax.device_get(params),
                                                  cfg))
    return jmodel, params, model


def assert_same_files(a, b):
    for suffix in ("", "_meta"):
        with open(a + suffix, "rb") as fa, open(b + suffix, "rb") as fb:
            assert fa.read() == fb.read(), a + suffix


@pytest.mark.parametrize("task,titles,noisy", [
    ("synthetic", False, False), ("synthetic", True, False),
    ("robust04", True, True), ("scifact", False, True)])
def test_prepare_records_byte_identical(tmp_path, tokenizer, task, titles,
                                        noisy):
    """Record files, id maps and qrels equal the JAX package's byte for
    byte (titles joined and never cleaned, robust04's cleaning, the
    long-doc length of scifact, unjudged queries dropped); the port reads
    the JAX files and the JAX package the port's."""
    data = write_task(tmp_path, titles=titles, noisy=noisy)
    want = jeb.prepare_beir_task(data, str(tmp_path / "jax"), tokenizer,
                                 jeb.BeirEvalConfig.for_task(task))
    got = teb.prepare_beir_task(data, str(tmp_path / "port"), tokenizer,
                                teb.BeirEvalConfig.for_task(task))
    assert got[2:] == want[2:]
    assert "unjudged" not in got[3]
    for path_t, path_j in zip(got[:2], want[:2]):
        assert_same_files(path_t, path_j)
        for ext in (".docid2offset.pickle", ".qid2offset.pickle"):
            try:
                m = trec.load_id_map(path_t + ext)
            except FileNotFoundError:
                continue
            assert m == jrec.load_id_map(path_j + ext)
        a, b = trec.TokenCache(path_j), jrec.TokenCache(path_t)
        np.testing.assert_array_equal(a.batch(np.arange(len(a)))[1],
                                      b.batch(np.arange(len(b)))[1])
    assert trec.TokenCache(got[0]).max_len == (256 if task in (
        "robust04", "scifact") else 128)


def test_parallel_writer_is_byte_identical(tmp_path, tokenizer):
    """n_workers 2 (fork workers, part files concatenated) writes the bytes
    of n_workers 1 and leaves no part file behind."""
    data = write_task(tmp_path, n_docs=41)
    cfg = teb.BeirEvalConfig.for_task("synthetic")
    one = teb.prepare_beir_task(data, str(tmp_path / "w1"), tokenizer, cfg)
    two = teb.prepare_beir_task(data, str(tmp_path / "w2"), tokenizer, cfg,
                                n_workers=2)
    assert one[2:] == two[2:]
    assert_same_files(one[0], two[0])
    assert not list((tmp_path / "w2").glob("*.part*"))


def jax_eval(jmodel, params, data, work, tokenizer, **kw):
    return jeb.eval_beir(jmodel, params, data, work, tokenizer, **kw)


@pytest.mark.parametrize("method,exact_fp32", [
    ("refined", False), ("pallas", False), ("auto", True)])
def test_eval_beir_matches_jax(tmp_path, tokenizer, method, exact_fp32):
    """tests/test_eval_pipeline.py:54's end-to-end case through both
    packages: every metric equal to 1e-6, and the planted docs all found
    (recall@100 1). The JAX package maps 'auto' to 'refined' on the CPU
    (a bf16 sweep, a float32 rescore) and 'pallas' to its kernel-free
    exact search of bf16 operands; the port's 'pallas' takes the kernels'
    plain versions, of the same bf16 operands; exact_fp32 searches float32
    operands in both."""
    data = write_task(tmp_path)
    jmodel, params, model = models()
    kw = dict(task="synthetic", batch_size=8, top_k=30, mips_tile=16,
              q_chunk=4, query_len=8, doc_len=12, exact_fp32=exact_fp32,
              search_method=method)
    want = jax_eval(jmodel, params, data, str(tmp_path / "j"), tokenizer,
                    **kw)
    got = teb.eval_beir(model, data, str(tmp_path / "t"), tokenizer,
                        device="cpu", **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], **TOL), k
    assert got["num_queries"] == 10 and got["recall_100"] == 1.0
    assert got["ndcg_cut_10"] > 0.5  # the planted docs rank high


def test_eval_beir_idempotent_prepare_and_buckets(tmp_path, tokenizer):
    """tests/test_eval_pipeline.py:90 and :135 through the port: a second
    prepare reads the files back; length buckets change no metric; both
    equal the JAX package's bucketed run."""
    data = write_task(tmp_path, n_docs=20)
    cfg = teb.BeirEvalConfig.for_task("synthetic")
    a = teb.prepare_beir_task(data, str(tmp_path / "w"), tokenizer, cfg)
    b = teb.prepare_beir_task(data, str(tmp_path / "w"), tokenizer, cfg)
    assert a[2] == b[2] and a[3] == b[3]
    jmodel, params, model = models("rdot_nll", seed=1)
    kw = dict(task="synthetic", batch_size=8, top_k=20, mips_tile=16,
              q_chunk=4, query_len=8, doc_len=12, exact_fp32=True)
    plain = teb.eval_beir(model, data, str(tmp_path / "w1"), tokenizer,
                          device="cpu", **kw)
    buck = teb.eval_beir(model, data, str(tmp_path / "w2"), tokenizer,
                         device="cpu", length_buckets=(8, 12), **kw)
    want = jax_eval(jmodel, params, data, str(tmp_path / "j"), tokenizer,
                    length_buckets=(8, 12), **kw)
    for k in want:
        assert plain[k] == buck[k], k
        assert buck[k] == pytest.approx(want[k], **TOL), k


def test_eval_beir_names_what_waits(tmp_path, tokenizer):
    """ivf, which raised here until ops/ivf.py was ported, evaluates: at
    full probe its metrics equal the exact 'pallas' search's (1e-6; the
    weights' std 0.2 keeps scores apart). Multi-chunk models (item 3)
    now evaluate: over records wider than chunk_len the corpus is one row
    a chunk, deduped to documents (held against the JAX eval in
    tests/test_torch_multichunk.py); a corpus of one chunk's width
    evaluates as single vectors, equal to rdot_nll on the same weights."""
    data = write_task(tmp_path, n_docs=10)
    _, _, model = models()
    kw = dict(device="cpu", batch_size=8, top_k=10, q_chunk=4,
              query_len=8, doc_len=12)
    ivf = teb.eval_beir(model, data, str(tmp_path / "w"), tokenizer,
                        search_method="ivf", ivf_nprobe=1000, **kw)
    flat = teb.eval_beir(model, data, str(tmp_path / "w"), tokenizer,
                         search_method="pallas", **kw)
    assert ivf.keys() == flat.keys()
    for k in flat:
        assert ivf[k] == pytest.approx(flat[k], **TOL), k
    _, _, plain = models("rdot_nll")
    chunked = DualEncoder(MODEL_REGISTRY["rdot_nll_multi_chunk"](
        BertConfig.tiny(), base_len=8, head_dim=16))
    chunked.load_state_dict(plain.state_dict())
    kw = dict(device="cpu", batch_size=8, top_k=10, mips_tile=16, q_chunk=4,
              query_len=8, exact_fp32=True)
    wide = teb.eval_beir(chunked, data, str(tmp_path / "w16"), tokenizer,
                         doc_len=16, **kw)
    assert wide["num_queries"] == 10
    assert (teb.eval_beir(chunked, data, str(tmp_path / "w8"), tokenizer,
                          doc_len=8, **kw)
            == teb.eval_beir(plain, data, str(tmp_path / "w8p"), tokenizer,
                             doc_len=8, **kw))


def _mrr_caches(tmp_path):
    rng = np.random.RandomState(0)
    qp, pp = str(tmp_path / "q"), str(tmp_path / "p")
    with trec.RecordWriter(qp, 8) as w:
        for _ in range(6):
            w.write([2] + rng.randint(5, 14, size=3).tolist() + [3])
    with trec.RecordWriter(pp, 8) as w:
        for _ in range(14):
            w.write([2] + rng.randint(5, 14, size=4).tolist() + [3])
    return qp, pp


def test_top_dev_and_combined_mrr_match_jax(tmp_path):
    """tests/test_eval_pipeline.py's top1000.dev case through both
    packages: the same candidate lists; full-ranking and rerank MRR equal
    to 1e-6; with every passage a candidate, rerank equals full ranking."""
    qp, pp = _mrr_caches(tmp_path)
    qid2off = {100 + i: i for i in range(6)}
    pid2off = {700 + i: i for i in range(14)}
    top = str(tmp_path / "top1000.dev")
    with open(top, "w") as f:
        for qid in qid2off:
            for pid in range(700, 707):
                f.write(f"{qid}\t{pid}\tquery text\tpassage text\n")
        f.write("999\t700\tunknown qid skipped\nnot\ta number\n")
    cands = tmrr.load_top_dev(top, qid2off, pid2off)
    assert cands == jmrr.load_top_dev(top, qid2off, pid2off)
    jmodel, params, model = models()
    qrels = {q: [q * 2] for q in range(6)}
    jqc, jpc = jrec.TokenCache(qp), jrec.TokenCache(pp)
    tqc, tpc = trec.TokenCache(qp), trec.TokenCache(pp)
    for c in (cands, {q: list(range(14)) for q in range(6)}):
        want = jmrr.combined_mrr(jmodel, params, jqc, jpc, qrels,
                                 candidates=c, top_k=10, batch_size=4)
        got = tmrr.combined_mrr(model, tqc, tpc, qrels, candidates=c,
                                top_k=10, batch_size=4, device="cpu")
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], **TOL), k
    assert got["rerank_MRR @10"] == pytest.approx(got["MRR @10"], abs=1e-9)
    full = tmrr.full_ranking_mrr(model, tqc, tpc, qrels, top_k=10,
                                 batch_size=4, device="cpu")
    assert full == pytest.approx(jmrr.full_ranking_mrr(
        jmodel, params, jqc, jpc, qrels, top_k=10, batch_size=4), **TOL)


def test_eval_leaves_a_model_under_training_unchanged(tmp_path, tokenizer):
    """eval_beir and full_ranking_mrr on state.model of a TrainState with a
    bf16 compute dtype: every parameter and LAMB moment stays bit-equal
    and float32, requires_grad and train mode stay; the next train step
    equals the step of a state that was never evaluated."""
    from cocodr_tpu_torch.optim import Lamb
    from cocodr_tpu_torch.pipelines.train_step import build_train_step
    from cocodr_tpu_torch.utils.train_state import TrainState

    def state():
        cfg = MODEL_REGISTRY["rdot_nll_condenser"](
            BertConfig.tiny(dtype=torch.bfloat16))
        torch.manual_seed(0)
        model = DualEncoder(cfg).train()
        return TrainState(model, Lamb(model.parameters(), lambda c: 1e-3))

    rng = np.random.RandomState(3)
    batch = {}
    for k, S in (("q", 6), ("pos", 10), ("neg", 10)):
        batch[f"{k}_ids"] = torch.from_numpy(rng.randint(5, 15, (4, S)))
        batch[f"{k}_mask"] = torch.ones(4, S, dtype=torch.long)
    step = build_train_step()
    evaluated, fresh = state(), state()
    step(evaluated, batch)  # LAMB moments exist before the eval
    step(fresh, batch)
    evaluated.model.train()  # a dropout step leaves it so
    before = {k: v.clone() for k, v in evaluated.model.state_dict().items()}
    moments = {id(p): {k: v.clone() for k, v in s.items()}
               for p, s in evaluated.optimizer.state.items()}

    data = write_task(tmp_path, n_docs=10)
    teb.eval_beir(evaluated.model, data, str(tmp_path / "w"), tokenizer,
                  device="cpu", batch_size=4, top_k=10, query_len=8,
                  doc_len=12)
    qp, pp = _mrr_caches(tmp_path)
    tmrr.full_ranking_mrr(evaluated.model, trec.TokenCache(qp),
                          trec.TokenCache(pp), {0: [1]}, batch_size=4,
                          device="cpu")
    assert evaluated.model.training
    for name, p in evaluated.model.named_parameters():
        assert p.dtype == torch.float32 and p.requires_grad, name
        assert torch.equal(p, before[name]), name
    for p, s in evaluated.optimizer.state.items():
        for k, v in s.items():
            assert v.dtype == torch.float32
            assert torch.equal(v, moments[id(p)][k])
    loss_e, _ = step(evaluated, batch)
    loss_f, _ = step(fresh, batch)
    assert torch.equal(loss_e, loss_f)
    for (name, a), b in zip(evaluated.model.state_dict().items(),
                            fresh.model.state_dict().values()):
        assert torch.equal(a, b), name
