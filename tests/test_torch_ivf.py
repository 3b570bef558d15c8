"""The port's IVF search (ops/ivf.py) against the JAX package's on the
CPU: tests/test_ivf.py's ten tests through the port, the index layout
bit-equal to the JAX build's from the same centroids, `_invert_probes`
bit-equal, `ivf_topk` against the JAX one on one index, the host-staged
build, slab boundaries, and IVF through search_topk and RetrievalService.

Tolerances: the two packages' scores are float32 sums of the same exact
products (bf16 or float32 operands) in another order, so they agree
within 1e-5 relative; ids may swap only between near-ties, within 1e-4 x
max |score| (as the other search tests and chip_smoke.py hold them)."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu.ops import ivf as jivf
from cocodr_tpu.parallel.topk import search_topk as jax_search_topk
from cocodr_tpu.pipelines.serve import RetrievalService as JaxService
from cocodr_tpu.pipelines.serve import ServeConfig as JaxServeConfig
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig
from cocodr_tpu_torch.models.dual_encoder import DualEncoder, MODEL_REGISTRY
from cocodr_tpu_torch.ops import ivf as tivf
from cocodr_tpu_torch.parallel.topk import search_topk
from cocodr_tpu_torch.pipelines.serve import RetrievalService, ServeConfig

torch.set_num_threads(1)

SCORE_RTOL = 1e-5
NEAR_TIE = 1e-4


def build_ivf_index(corpus, **kw):
    return tivf.build_ivf_index(corpus, device="cpu", **kw)


def ivf_topk(queries, index, k, **kw):
    v, i = tivf.ivf_topk(torch.from_numpy(np.asarray(queries)), index, k,
                         **kw)
    return v.numpy(), i.numpy()


def _clustered(n, d, n_centers, seed=0, scale=0.3):
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_centers, d).astype(np.float32)
    docs = (centers[rng.randint(0, n_centers, n)]
            + scale * rng.randn(n, d)).astype(np.float32)
    return centers, docs, rng


def _numpy_topk(queries, corpus, k):
    s = queries.astype(np.float64) @ corpus.astype(np.float64).T
    idx = np.argsort(-s, axis=1)[:, :k]
    return np.take_along_axis(s, idx, axis=1), idx


def same_up_to_near_ties(vt, it, vj, ij, rtol=SCORE_RTOL, near=NEAR_TIE):
    """Scores within rtol; an id in one list and not the other only where
    its score lies within near x max |score| of the k-th (it may order
    either way), -1 ids in the same places."""
    vt, it, vj, ij = map(np.asarray, (vt, it, vj, ij))
    assert vt.shape == vj.shape and it.shape == ij.shape
    finite = np.isfinite(vj)
    np.testing.assert_array_equal(np.isfinite(vt), finite)
    np.testing.assert_array_equal(it == -1, ij == -1)
    np.testing.assert_allclose(vt[finite], vj[finite], rtol=rtol, atol=rtol)
    tol = near * max(1.0, np.abs(vj[finite]).max())
    moved = 0
    for row in range(vt.shape[0]):
        a, b = set(it[row].tolist()), set(ij[row].tolist())
        kth = vj[row][finite[row]][-1]
        for doc in a ^ b:
            src_i, src_v = (it, vt) if doc in a else (ij, vj)
            pos = np.where(src_i[row] == doc)[0][0]
            assert abs(src_v[row, pos] - kth) <= tol, (row, doc)
            moved += 1
    return moved


@pytest.fixture()
def jax_centroids(monkeypatch):
    """Make the port's build take the JAX build's centroids: returns a
    function (corpus, **build kwargs) -> (JAX index, port index)."""
    def both(corpus, dtype=None, **kw):
        jdtype = None if dtype is None else jnp.bfloat16
        jidx = jivf.build_ivf_index(corpus, dtype=jdtype, **kw)
        cents = torch.from_numpy(np.array(jidx.centroids))
        seen = []

        def fake(x, n_clusters, **kkw):
            seen.append((tuple(x.shape), n_clusters, kkw["n_iter"],
                         kkw["seed"]))
            return cents, None

        monkeypatch.setattr(tivf, "kmeans", fake)
        tidx = build_ivf_index(corpus, dtype=dtype, **kw)
        monkeypatch.undo()
        assert seen and seen[0][1] == jidx.n_clusters
        return jidx, tidx

    return both


def assert_same_layout(jidx, tidx):
    np.testing.assert_array_equal(tidx.block_ids.numpy(),
                                  np.asarray(jidx.block_ids))
    np.testing.assert_array_equal(tidx.centroid_block_rows,
                                  jidx.centroid_block_rows)
    np.testing.assert_array_equal(
        tidx.blocks.float().numpy(),
        np.asarray(jidx.blocks).astype(np.float32))
    assert tidx.block_ids.dtype == torch.int32
    assert (tidx.n_docs, tidx.block_size) == (jidx.n_docs, jidx.block_size)


# --- tests/test_ivf.py through the port ------------------------------------

def test_full_probe_is_exact():
    """nprobe == n_clusters scans every block -> must equal brute force."""
    centers, corpus, rng = _clustered(3000, 32, 16)
    queries = (centers[rng.randint(0, 16, 64)]
               + 0.3 * rng.randn(64, 32)).astype(np.float32)
    idx = build_ivf_index(corpus, n_clusters=24, block_size=64,
                          kmeans_iters=8)
    ev, ei = _numpy_topk(queries, corpus, 50)
    v, i = ivf_topk(queries, idx, 50, nprobe=24)
    for q in range(64):
        assert set(i[q]) == set(ei[q])
    np.testing.assert_allclose(v, ev, rtol=1e-4, atol=1e-4)


def test_small_nprobe_recall_on_clustered_data():
    centers, corpus, rng = _clustered(8000, 48, 64)
    queries = (centers[rng.randint(0, 64, 64)]
               + 0.3 * rng.randn(64, 48)).astype(np.float32)
    idx = build_ivf_index(corpus, n_clusters=64, block_size=128,
                          kmeans_iters=10)
    _, ei = _numpy_topk(queries, corpus, 20)
    _, i = ivf_topk(queries, idx, 20, nprobe=8)
    recall = np.mean([len(set(i[q]) & set(ei[q])) / 20 for q in range(64)])
    assert recall > 0.9, recall


def test_oversized_cluster_spans_blocks():
    """One dominant cluster >> block_size: its docs must all stay
    findable (block splitting, not truncation)."""
    rng = np.random.RandomState(1)
    center = rng.randn(16).astype(np.float32)
    big = (center + 0.05 * rng.randn(500, 16)).astype(np.float32)
    rest = rng.randn(100, 16).astype(np.float32) * 0.01
    corpus = np.concatenate([big, rest])
    idx = build_ivf_index(corpus, n_clusters=4, block_size=64,
                          kmeans_iters=10)
    assert idx.n_blocks >= 8  # 500-doc cluster alone needs 8 blocks
    queries = center[None, :] + 0.05 * rng.randn(4, 16).astype(np.float32)
    _, ei = _numpy_topk(queries, corpus, 100)
    _, i = ivf_topk(queries, idx, 100, nprobe=4)
    for q in range(4):
        assert set(i[q]) == set(ei[q])


def test_pad_rows_never_returned():
    """All-negative corpus scores: a zero pad row scores 0 and would win
    every query if the -inf mask were missing."""
    rng = np.random.RandomState(2)
    d = 8
    corpus = -np.abs(rng.randn(100, d)).astype(np.float32) - 0.5
    queries = np.abs(rng.randn(10, d)).astype(np.float32) + 0.5
    idx = build_ivf_index(corpus, n_clusters=16, block_size=32,
                          kmeans_iters=8)
    assert (idx.block_ids.numpy() < 0).any()  # pad rows exist
    v, i = ivf_topk(queries, idx, 10, nprobe=16)
    assert (i >= 0).all() and (i < 100).all()
    assert (v < 0).all()  # every returned score is a real (negative) one


def test_underfilled_probe_pads_with_minus_one():
    """k larger than the number of docs actually probed: tail ids are -1,
    their scores -inf, and the JAX search pads the same places."""
    rng = np.random.RandomState(3)
    corpus = rng.randn(60, 8).astype(np.float32)
    queries = rng.randn(5, 8).astype(np.float32)
    idx = build_ivf_index(corpus, n_clusters=12, block_size=8,
                          kmeans_iters=8)
    v, i = ivf_topk(queries, idx, 50, nprobe=1)
    assert (i == -1).any()
    assert np.isneginf(v[i == -1]).all()
    real = i[i >= 0]
    assert (real < 60).all()
    assert i.dtype == np.int32 and v.dtype == np.float32


def test_search_topk_dispatches_ivf():
    """search_topk(method='ivf') builds an index inline and at full probe
    equals the flat search of the same bf16 operands (the port's 'pallas'),
    up to near-ties, and the JAX search_topk's ivf up to near-ties."""
    centers, corpus, rng = _clustered(2000, 32, 8, seed=5)
    queries = (centers[rng.randint(0, 8, 16)]
               + 0.3 * rng.randn(16, 32)).astype(np.float32)
    _, ei = _numpy_topk(queries, corpus, 10)
    v, i = search_topk(queries, corpus, 10, method="ivf", ivf_nprobe=10_000,
                       device="cpu")  # clamped to n_clusters
    overlap = np.mean([len(set(i[q]) & set(ei[q])) / 10 for q in range(16)])
    assert overlap >= 0.95, overlap
    ve, ie = search_topk(queries, corpus, 10, method="pallas", device="cpu")
    same_up_to_near_ties(v, i, ve, ie)
    vj, ij = jax_search_topk(queries, corpus, 10, method="ivf",
                             ivf_nprobe=10_000)
    same_up_to_near_ties(v, i, vj, ij)


def test_index_covers_every_doc_once():
    _, corpus, _ = _clustered(1000, 16, 8, seed=4)
    idx = build_ivf_index(corpus, n_clusters=8, block_size=64)
    ids = idx.block_ids.numpy()
    real = ids[ids >= 0]
    assert sorted(real.tolist()) == list(range(1000))
    blocks = idx.blocks.numpy()
    flat_ids = ids.reshape(-1)
    flat_vecs = blocks.reshape(-1, 16)
    sel = flat_ids >= 0
    np.testing.assert_allclose(flat_vecs[sel], corpus[flat_ids[sel]])
    assert not flat_vecs[~sel].any()  # pad rows zeroed


def test_empty_query_batch():
    """Zero queries return empty [0, k] results."""
    _, corpus, _ = _clustered(500, 16, 4)
    idx = build_ivf_index(corpus, n_clusters=4, block_size=64,
                          kmeans_iters=4)
    v, i = ivf_topk(np.zeros((0, 16), np.float32), idx, 10)
    assert v.shape == (0, 10) and i.shape == (0, 10)
    v, i = tivf.ivf_topk_chunked(np.zeros((0, 16), np.float32), idx, 10)
    assert v.shape == (0, 10) and i.shape == (0, 10)


def test_recall_on_unnormalized_embeddings():
    """MIPS recall on unnormalized vectors (the rdot regime): with the
    inner-product assignment, small-nprobe recall stays high."""
    rng = np.random.RandomState(5)
    n, d = 8000, 48
    centers = rng.randn(32, d).astype(np.float32)
    docs = (centers[rng.randint(0, 32, n)]
            + 0.3 * rng.randn(n, d)).astype(np.float32)
    hot = rng.rand(n) < 0.05
    docs[hot] *= rng.uniform(3.0, 6.0, size=(hot.sum(), 1)).astype(np.float32)
    queries = (centers[rng.randint(0, 32, 64)]
               + 0.3 * rng.randn(64, d)).astype(np.float32)
    idx = build_ivf_index(docs, n_clusters=64, block_size=128,
                          kmeans_iters=10)
    _, ei = _numpy_topk(queries, docs, 20)
    _, i = ivf_topk(queries, idx, 20, nprobe=8)
    recall = np.mean([len(set(i[q]) & set(ei[q])) / 20 for q in range(64)])
    assert recall > 0.85, recall


@pytest.mark.parametrize("slab", [1, 7, 64])
def test_slab_boundaries_match_single_call(monkeypatch, slab):
    """Task slabs of any size give the results of one slab bit for bit."""
    centers, corpus, rng = _clustered(4000, 32, 24)
    queries = (centers[rng.randint(0, 24, 96)]
               + 0.3 * rng.randn(96, 32)).astype(np.float32)
    idx = build_ivf_index(corpus, n_clusters=24, block_size=64,
                          kmeans_iters=6, dtype=torch.bfloat16)
    monkeypatch.setattr(tivf, "_task_slab", lambda *a, **k: 1 << 30)
    v1, i1 = ivf_topk(queries, idx, 25, nprobe=24)
    monkeypatch.setattr(tivf, "_task_slab", lambda *a, **k: slab)
    v2, i2 = ivf_topk(queries, idx, 25, nprobe=24)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(i1, i2)


# --- against the JAX package ------------------------------------------------

@pytest.mark.parametrize("case", ["f32", "bf16", "sampled", "one_cluster"])
def test_layout_bit_equal_to_jax_from_the_same_centroids(jax_centroids,
                                                         case):
    """From the JAX build's centroids, the assignment, bucketing, block ids,
    the centroid -> blocks table and the blocks (pad rows zeroed) equal
    the JAX build's bit for bit; the k-means gets the JAX sample's shape,
    iterations and seed."""
    _, corpus, _ = _clustered(1500, 24, 12, seed=7)
    kw = dict(n_clusters=16, block_size=32, kmeans_iters=5, seed=3)
    if case == "bf16":
        kw["dtype"] = torch.bfloat16
    elif case == "sampled":  # k-means on a sample of the rows
        kw.update(train_sample=700, dtype=torch.bfloat16)
    elif case == "one_cluster":  # one cluster spans many blocks
        corpus = corpus[:300] * 0.01 + 5.0
        kw.update(n_clusters=4, block_size=16)
    jidx, tidx = jax_centroids(corpus, **kw)
    assert_same_layout(jidx, tidx)


@pytest.mark.parametrize("shape", [(1, 4, 9), (40, 6, 30), (200, 16, 24),
                                   (77, 3, 5)])
def test_invert_probes_bit_equal_to_jax(shape):
    """Random probe tables (many queries on a few centroids, so centroids
    repeat across rows, Q = 1, groups that split a centroid's queries)
    -> the same tasks, task queries, qmap and task count."""
    n_q, nprobe, n_c = shape
    rng = np.random.RandomState(n_q)
    probes = np.stack([rng.choice(n_c, nprobe, replace=False)
                       for _ in range(n_q)]).astype(np.int32)
    blocks_per_c = rng.randint(1, 4, n_c)
    rows = np.full((n_c, blocks_per_c.max()), -1, np.int32)
    b = 0
    for c in range(n_c):
        rows[c, :blocks_per_c[c]] = np.arange(b, b + blocks_per_c[c])
        b += blocks_per_c[c]
    for g in (1, 8, 64):
        want = jivf._invert_probes(probes, rows, g)
        got = tivf._invert_probes(probes, rows, g)
        assert got[3] == want[3]
        for a, w in zip(got[:3], want[:3]):
            assert a.dtype == w.dtype
            np.testing.assert_array_equal(a, w)


@pytest.mark.parametrize("dtype,nprobe,k", [("bf16", 6, 40), ("bf16", 24, 50),
                                            ("f32", 3, 20), ("bf16", 1, 300)])
def test_ivf_topk_matches_jax_on_one_index(jax_centroids, dtype, nprobe, k):
    """The port's ivf_topk on the layout of the JAX index: ids equal up to
    near-ties, scores within 1e-5 relative, -1 pads in the same places
    (k = 300 exceeds what one probe holds)."""
    centers, corpus, rng = _clustered(3000, 32, 16, seed=9)
    queries = (centers[rng.randint(0, 16, 70)]
               + 0.3 * rng.randn(70, 32)).astype(np.float32)
    tdtype = torch.bfloat16 if dtype == "bf16" else None
    jidx, tidx = jax_centroids(corpus, n_clusters=24, block_size=64,
                               kmeans_iters=4, dtype=tdtype)
    jv, ji = jivf.ivf_topk(queries, jidx, k, nprobe=nprobe)
    tv, ti = ivf_topk(queries, tidx, k, nprobe=nprobe)
    same_up_to_near_ties(tv, ti, np.asarray(jv), np.asarray(ji))
    cv, ci = tivf.ivf_topk_chunked(queries, tidx, k, nprobe=nprobe,
                                   q_chunk=16)
    same_up_to_near_ties(cv, ci, tv, ti)


def test_host_staged_build_equals_device_build(monkeypatch):
    """Staging the block gather through the host gives the same index."""
    _, corpus, _ = _clustered(1200, 16, 8, seed=11)
    kw = dict(n_clusters=10, block_size=32, kmeans_iters=5,
              dtype=torch.bfloat16, train_sample=600)
    a = build_ivf_index(torch.from_numpy(corpus), **kw)
    staged = []
    monkeypatch.setattr(tivf, "_host_stage",
                        lambda nbytes, dev: staged.append(nbytes) or True)
    b = build_ivf_index(torch.from_numpy(corpus), **kw)
    assert staged == [1200 * 16 * 2]
    assert torch.equal(a.centroids, b.centroids)
    assert torch.equal(a.blocks, b.blocks)
    assert torch.equal(a.block_ids, b.block_ids)
    np.testing.assert_array_equal(a.centroid_block_rows,
                                  b.centroid_block_rows)


def test_host_stage_rule_reads_the_cards_free_memory(monkeypatch):
    """The device build stages when 2.3 x the corpus's bytes exceeds half
    of the card's free memory; the CPU never stages."""
    assert not tivf._host_stage(1 << 40, torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (46 * 10 ** 9, 80 * 10 ** 9))
    cuda = torch.device("cuda")
    assert not tivf._host_stage(10 * 10 ** 9, cuda)  # 23e9 <= 23e9
    assert tivf._host_stage(10 * 10 ** 9 + 1, cuda)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tivf.build_ivf_index(np.zeros((8, 4), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        search_topk(np.zeros((2, 4), np.float32),
                    np.zeros((8, 4), np.float32), 2, method="ivf")


def test_search_topk_ivf_takes_a_prebuilt_index_and_n_real(monkeypatch):
    """A prebuilt index is searched as it is (no build); without one, the
    build sees the first n_real rows only, so pad rows are never indexed
    nor returned."""
    centers, corpus, rng = _clustered(600, 16, 4, seed=12)
    queries = rng.randn(8, 16).astype(np.float32)
    idx = build_ivf_index(corpus, n_clusters=6, block_size=32,
                          dtype=torch.bfloat16)
    built = []
    real_build = tivf.build_ivf_index

    def spy(c, **kw):
        built.append(tuple(c.shape))
        return real_build(c, **kw)

    import cocodr_tpu_torch.parallel.topk as ptopk

    monkeypatch.setattr(ptopk, "build_ivf_index", spy)
    v1, i1 = search_topk(queries, None, 5, method="ivf", ivf_index=idx,
                         ivf_nprobe=6, device="cpu")
    assert built == []
    v0, i0 = ivf_topk(queries, idx, 5, nprobe=6)
    np.testing.assert_array_equal(i1, i0)
    big = np.concatenate([corpus, np.full((100, 16), 50.0, np.float32)])
    _, ip = search_topk(queries, big, 5, method="ivf", ivf_nprobe=100,
                        n_real=600, device="cpu")
    assert built == [(600, 16)]
    assert (ip >= 0).all() and (ip < 600).all()


# --- IVF through the serving path ------------------------------------------

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]


def tokenizer(texts, padding="max_length", truncation=True, max_length=8,
              return_tensors="np"):
    """numpy stand-in with the HuggingFace call signature."""
    ids = np.zeros((len(texts), max_length), np.int64)
    mask = np.zeros_like(ids)
    for i, text in enumerate(texts):
        words = [5 + WORDS.index(w) for w in text.split()]
        toks = [2] + words[:max_length - 2]
        toks.append(3)
        ids[i, :len(toks)] = toks
        mask[i, :len(toks)] = 1
    return {"input_ids": ids, "attention_mask": mask}


@pytest.fixture(scope="module")
def tower():
    jcfg = dataclasses.replace(JaxBertConfig.tiny(), intermediate_size=128)
    jmodel = jax_build("rdot_nll_condenser", jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32),
                         jnp.ones((1, 8), jnp.int32))["params"]
    cfg = MODEL_REGISTRY["rdot_nll_condenser"](
        BertConfig.tiny(intermediate_size=128))
    model = DualEncoder(cfg)
    model.load_state_dict(convert.params_from_jax(jax.device_get(params), cfg))
    corpus = np.random.RandomState(0).randn(600, 32).astype(np.float32)
    return jmodel, params, model, corpus


QUERIES = ["alpha beta", "gamma", "delta alpha gamma", "zeta epsilon",
           "beta beta beta", "epsilon"]


def test_retrieval_service_ivf_matches_exact(tower):
    """tests/test_serve.py's IVF service test through the port: at full
    probe the IVF service ranks as the default exact service (same encode,
    clustered index instead of the flat corpus), up to near-ties; it holds
    no flat corpus; search_stream goes through the IVF path too."""
    _, _, model, corpus = tower
    kw = dict(top_k=5, max_query_len=8, max_batch=8)
    exact = RetrievalService(model, tokenizer, corpus,
                             cfg=ServeConfig(**kw), device="cpu")
    ivf = RetrievalService(
        model, tokenizer, corpus, device="cpu",
        cfg=ServeConfig(ivf=True, ivf_nprobe=10_000, ivf_clusters=8,
                        ivf_block_size=64, **kw))
    assert ivf.ivf_index is not None and ivf.corpus is None
    assert ivf.ivf_index.blocks.dtype == torch.bfloat16
    assert ivf.ivf_index.n_clusters == 8
    ev, ei = exact.search(QUERIES)
    iv, ii = ivf.search(QUERIES)
    same_up_to_near_ties(iv, ii, ev, ei)
    out = list(ivf.search_stream([QUERIES[:2], QUERIES[2:]], depth=2))
    assert len(out) == 2
    np.testing.assert_array_equal(np.concatenate([v for v, _ in out]), iv)
    assert [r for _, ids in out for r in ids] == ii


def test_retrieval_service_ivf_matches_jax_service(tower):
    """The IVF service against the JAX IVF service on the same weights and
    corpus, both at full probe: the same ranking up to near-ties. The two
    services' indexes come from different k-means draws, which full probe
    makes irrelevant. Tolerance 1e-3, as tests/test_torch_serve.py holds
    the services: the float32 towers agree to ~1e-5, which moves a bf16
    rounding of the query now and then."""
    jmodel, params, model, corpus = tower
    kw = dict(top_k=5, max_query_len=8, max_batch=8, ivf=True,
              ivf_nprobe=10_000, ivf_clusters=8, ivf_block_size=64)
    jsvc = JaxService(jmodel, params, tokenizer, corpus,
                      cfg=JaxServeConfig(**kw))
    svc = RetrievalService(model, tokenizer, corpus, cfg=ServeConfig(**kw),
                           device="cpu")
    jv, ji = jsvc.search(QUERIES)
    tv, ti = svc.search(QUERIES)
    same_up_to_near_ties(tv, ti, np.asarray(jv), np.asarray(ji))
