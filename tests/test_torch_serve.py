"""RetrievalService: the port on the CPU against the JAX service (which
searches with the exact blockmax path off the TPU), on the same tiny model
weights, corpus, queries and tokenizer. The approximate modes are held
against the JAX package's search functions applied to the JAX tower's
query embeddings: off the TPU its service runs the exact blockmax search
for every mode."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu.ops.pallas_mips import mips_topk_fast as jax_fast
from cocodr_tpu.ops.pallas_mips import mips_topk_int8 as jax_int8
from cocodr_tpu.pipelines.serve import RetrievalService as JaxService
from cocodr_tpu.pipelines.serve import ServeConfig as JaxServeConfig
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig
from cocodr_tpu_torch.models.dual_encoder import DualEncoder, MODEL_REGISTRY
from cocodr_tpu_torch.pipelines.serve import RetrievalService, ServeConfig

torch.set_num_threads(1)

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa", "lambda", "mu"]
QUERIES = [" ".join(WORDS[(i * 5 + j * 3) % len(WORDS)]
                    for j in range(1 + i % 5)) for i in range(11)]


def tokenizer(texts, padding="max_length", truncation=True, max_length=8,
              return_tensors="np"):
    """numpy stand-in with the HuggingFace call signature: [CLS]=2,
    [SEP]=3, word ids 5.., [PAD]=0."""
    ids = np.zeros((len(texts), max_length), np.int64)
    mask = np.zeros_like(ids)
    for i, text in enumerate(texts):
        toks = [2] + [5 + WORDS.index(w) for w in text.split()][:max_length - 2]
        toks.append(3)
        ids[i, :len(toks)] = toks
        mask[i, :len(toks)] = 1
    return {"input_ids": ids, "attention_mask": mask}


@pytest.fixture(scope="module")
def tower():
    """The JAX tower and its params, the port's tower with the same
    weights, and the corpus."""
    jcfg = dataclasses.replace(JaxBertConfig.tiny(), intermediate_size=128)
    jmodel = jax_build("rdot_nll_condenser", jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32),
                         jnp.ones((1, 8), jnp.int32))["params"]
    rng = np.random.RandomState(0)
    corpus = rng.randn(300, 32).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    cfg = MODEL_REGISTRY["rdot_nll_condenser"](
        BertConfig.tiny(intermediate_size=128))
    model = DualEncoder(cfg)
    model.load_state_dict(convert.params_from_jax(jax.device_get(params), cfg))
    return jmodel, params, model, corpus


DOC_IDS = [f"d{i}" for i in range(300)]


def _port_service(tower, **modes):
    return RetrievalService(tower[2], tokenizer, tower[3], doc_ids=DOC_IDS,
                            cfg=ServeConfig(top_k=5, max_query_len=8,
                                            max_batch=8, **modes),
                            device="cpu")


@pytest.fixture(scope="module")
def services(tower):
    jmodel, params, _, corpus = tower
    jsvc = JaxService(jmodel, params, tokenizer, corpus, doc_ids=DOC_IDS,
                      cfg=JaxServeConfig(top_k=5, max_query_len=8,
                                         max_batch=8))
    return jsvc, _port_service(tower)


def test_search_matches_jax_service(services):
    jsvc, tsvc = services
    jv, ji = jsvc.search(QUERIES)
    tv, ti = tsvc.search(QUERIES)
    assert ti == ji  # external ids, in rank order
    # float32 towers agree to ~1e-5; both score bf16 operands in float32
    np.testing.assert_allclose(tv, jv, atol=1e-3, rtol=1e-3)


def test_single_query_and_top_k_override(services):
    jsvc, tsvc = services
    jv, ji = jsvc.search(QUERIES[:1], top_k=3)
    tv, ti = tsvc.search(QUERIES[:1], top_k=3)
    assert tv.shape == (1, 3) and ti == ji


@pytest.mark.parametrize("max_batch", [4, 8, 64])
def test_buckets_match_jax(services, max_batch):
    jsvc, tsvc = services
    old = jsvc.cfg.max_batch, tsvc.cfg.max_batch
    jsvc.cfg.max_batch = tsvc.cfg.max_batch = max_batch
    try:
        for nq in (1, 3, 8, 9, 17, 64, 65, 130):
            assert tsvc._bucket(nq) == jsvc._bucket(nq), nq
    finally:
        jsvc.cfg.max_batch, tsvc.cfg.max_batch = old


def test_search_stream_equals_search(services):
    _, tsvc = services
    batches = [QUERIES[:3], QUERIES[3:9], QUERIES[9:]]
    streamed = list(tsvc.search_stream(batches, depth=2))
    assert len(streamed) == 3
    for batch, (v, ids) in zip(batches, streamed):
        v1, ids1 = tsvc.search(batch)
        assert ids == ids1
        np.testing.assert_array_equal(v, v1)


def test_dispatch_collect_many_and_row_ids(services):
    _, tsvc = services
    pend = [tsvc.dispatch(QUERIES[:2], 4), tsvc.dispatch(QUERIES[2:5], 4)]
    out = tsvc.collect_many(pend)
    assert [v.shape for v, _ in out] == [(2, 4), (3, 4)]
    assert all(i.startswith("d") for _, ids in out for row in ids for i in row)
    tsvc.doc_ids, saved = None, tsvc.doc_ids
    try:
        _, ids = tsvc.search(QUERIES[:2])
        assert all(isinstance(i, int) and 0 <= i < 300 for r in ids for i in r)
    finally:
        tsvc.doc_ids = saved


@pytest.mark.parametrize("mode", ["ivf", "mesh"])
def test_modes_not_ported_raise(tower, mode):
    """A mesh raised here, naming its ROADMAP.md item, until the
    multi-device slice: over a world of one process the sharded service
    (its shard padded to the sweeps' tile, distributed_topk's merge)
    answers as the plain one, scores and external ids equal, in the
    default and the fast_search modes (W = 2 and 4:
    tests/test_torch_sharded_search.py). ivf, which raised here until
    ops/ivf.py was ported, now serves: at full probe its ids equal the
    JAX default service's (an exact search of bf16 operands) up to
    near-ties, tolerance 1e-3 as in test_search_matches_jax_service, with
    no flat corpus held."""
    if mode == "mesh":
        import torch_mesh_workers as workers

        for fast in (False, True):
            want = _port_service(tower, fast_search=fast).search(QUERIES)
            with workers.world_of_one() as mesh:
                got = RetrievalService(
                    tower[2], tokenizer, tower[3], doc_ids=DOC_IDS,
                    cfg=ServeConfig(top_k=5, max_query_len=8, max_batch=8,
                                    fast_search=fast),
                    mesh=mesh, device="cpu").search(QUERIES)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
        return
    jmodel, params, _, corpus = tower
    jsvc = JaxService(jmodel, params, tokenizer, corpus, doc_ids=DOC_IDS,
                      cfg=JaxServeConfig(top_k=5, max_query_len=8,
                                         max_batch=8))
    svc = _port_service(tower, ivf=True, ivf_nprobe=1000, ivf_clusters=4,
                        ivf_block_size=32)
    assert svc.corpus is None and svc.ivf_index.n_docs == 300
    jv, ji = jsvc.search(QUERIES)
    tv, ti = svc.search(QUERIES)
    _same_ranking(tv, ti, jv, ji, tol=1e-3)


def _jax_query_emb(tower, texts):
    jmodel, params = tower[0], tower[1]
    tok = tokenizer(texts, max_length=8)
    return jmodel.apply({"params": params}, jnp.asarray(tok["input_ids"]),
                        jnp.asarray(tok["attention_mask"]),
                        method=jmodel.query_emb)


def _same_ranking(tv, ti, jv, ji, tol):
    """Scores within tol; external ids equal, except where two scores
    within tol of each other may swap (the towers agree to ~1e-5)."""
    np.testing.assert_allclose(tv, jv, atol=tol, rtol=tol)
    for row in range(len(ti)):
        for a, b, va in zip(ti[row], ji[row], tv[row]):
            if a != b:
                near = np.abs(tv[row] - va) <= 2 * tol
                assert near.sum() >= 2, (row, a, b)


@pytest.mark.parametrize("mode", ["fast_search", "quantize_int8"])
def test_approximate_modes_match_jax_functions(tower, mode):
    """fast_search against the JAX mips_topk_fast, quantize_int8 against
    the JAX quantize_corpus_int8 + mips_topk_int8 (both in interpret
    mode), on the JAX tower's query embeddings. Tolerance 1e-3: the
    float32 towers agree to ~1e-5, which moves a bf16 or int8 rounding of
    the query now and then."""
    svc = _port_service(tower, **{mode: True})
    tv, ti = svc.search(QUERIES)
    emb = _jax_query_emb(tower, QUERIES)
    corpus = jnp.asarray(tower[3])
    if mode == "fast_search":
        jv, ji = jax_fast(emb, corpus, 5, interpret=True)
    else:
        from cocodr_tpu.ops.pallas_mips import quantize_corpus_int8

        jv, ji = jax_int8(emb, *quantize_corpus_int8(corpus), 5,
                          interpret=True)
    ji = [[DOC_IDS[i] for i in row] for row in np.asarray(ji)]
    _same_ranking(tv, ti, np.asarray(jv), ji, tol=1e-3)


def test_quantize_int8_holds_the_jax_services_corpus(tower):
    """The int8 corpus (padded with replicas of its last row) and the
    per-dimension scales are bit-equal to the JAX service's."""
    jmodel, params, _, corpus = tower
    jsvc = JaxService(jmodel, params, tokenizer, corpus, doc_ids=DOC_IDS,
                      cfg=JaxServeConfig(top_k=5, max_query_len=8,
                                         max_batch=8, quantize_int8=True))
    svc = _port_service(tower, quantize_int8=True, fast_search=True)
    assert svc.corpus.dtype == torch.int8 and svc.corpus.shape[0] == 2048
    np.testing.assert_array_equal(svc.corpus[:300].numpy(),
                                  np.asarray(jsvc.corpus))
    np.testing.assert_array_equal(svc.corpus[300:].numpy(),
                                  np.broadcast_to(np.asarray(jsvc.corpus)[-1:],
                                                  (2048 - 300, 32)))
    np.testing.assert_array_equal(svc.dim_scale.numpy(),
                                  np.asarray(jsvc.dim_scale))


def test_exact_fp32_matches_jax_service(tower):
    """exact_fp32 wins over the other modes, as in the JAX service, whose
    exact_fp32 search (mips_topk in float32) is the same off the TPU.
    Tolerance 1e-3 as in test_search_matches_jax_service."""
    jmodel, params, _, corpus = tower
    jsvc = JaxService(jmodel, params, tokenizer, corpus, doc_ids=DOC_IDS,
                      cfg=JaxServeConfig(top_k=5, max_query_len=8,
                                         max_batch=8, exact_fp32=True))
    svc = _port_service(tower, exact_fp32=True, fast_search=True,
                        quantize_int8=True, ivf=True)
    assert svc.corpus.dtype == torch.float32 and svc.corpus.shape[0] == 300
    jv, ji = jsvc.search(QUERIES)
    tv, ti = svc.search(QUERIES)
    _same_ranking(tv, ti, jv, ji, tol=1e-3)


def test_int8_encode_service_matches_jax_service(tower):
    """A matmul_int8 query tower (the JAX `serve --int8-encode`) behind the
    default search, against the JAX service with the same int8 tower and
    weights. Tolerance 1e-3 as in test_search_matches_jax_service; the
    int8 towers agree to ~1e-6."""
    _, params, _, corpus = tower
    jcfg = dataclasses.replace(JaxBertConfig.tiny(), intermediate_size=128,
                               matmul_int8=True)
    jmodel = jax_build("rdot_nll_condenser", jcfg)
    jsvc = JaxService(jmodel, params, tokenizer, corpus, doc_ids=DOC_IDS,
                      cfg=JaxServeConfig(top_k=5, max_query_len=8,
                                         max_batch=8))
    cfg = MODEL_REGISTRY["rdot_nll_condenser"](
        BertConfig.tiny(intermediate_size=128, matmul_int8=True))
    model = DualEncoder(cfg)
    model.load_state_dict(convert.params_from_jax(jax.device_get(params),
                                                  cfg))
    svc = RetrievalService(model, tokenizer, corpus, doc_ids=DOC_IDS,
                           cfg=ServeConfig(top_k=5, max_query_len=8,
                                           max_batch=8), device="cpu")
    jv, ji = jsvc.search(QUERIES)
    tv, ti = svc.search(QUERIES)
    _same_ranking(tv, ti, jv, ji, tol=1e-3)


def test_int8_service_quantizes_float32_weights(tower):
    """With bf16 compute the service holds its matmul weights in bf16, but
    a matmul_int8 tower's FFN weights stay float32: its query embeddings
    equal those of an uncast copy of the tower (which quantizes its
    float32 weights per call, as the JAX package does), and differ from a
    tower whose FFN weights were rounded to bf16 first."""
    state = tower[2].state_dict()
    cfg = MODEL_REGISTRY["rdot_nll_condenser"](
        BertConfig.tiny(intermediate_size=128, matmul_int8=True,
                        dtype=torch.bfloat16))

    def fresh():
        model = DualEncoder(cfg).eval()
        model.load_state_dict(state)
        return model

    svc = RetrievalService(fresh(), tokenizer, tower[3],
                           cfg=ServeConfig(top_k=5, max_query_len=8,
                                           max_batch=8), device="cpu")
    ffn_w = svc.model.encoder.encoder.layer[0].intermediate.dense.weight
    assert ffn_w.dtype == torch.float32
    rounded = fresh()
    for layer in rounded.encoder.encoder.layer:
        for lin in (layer.intermediate.dense, layer.output.dense):
            lin.weight.data = lin.weight.data.to(torch.bfloat16).float()
    ids, mask = svc._tokenize(QUERIES[:8])
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.inference_mode():
        got = svc.model.query_emb(ids, mask)
        assert torch.equal(got, fresh().query_emb(ids, mask))
        assert not torch.equal(got, rounded.query_emb(ids, mask))
