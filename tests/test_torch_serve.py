"""RetrievalService: the port on the CPU against the JAX service (which
searches with the exact blockmax path off the TPU), on the same tiny model
weights, corpus, queries and tokenizer."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
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
def services():
    jcfg = dataclasses.replace(JaxBertConfig.tiny(), intermediate_size=128)
    jmodel = jax_build("rdot_nll_condenser", jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32),
                         jnp.ones((1, 8), jnp.int32))["params"]
    rng = np.random.RandomState(0)
    corpus = rng.randn(300, 32).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    doc_ids = [f"d{i}" for i in range(300)]
    jsvc = JaxService(jmodel, params, tokenizer, corpus, doc_ids=doc_ids,
                      cfg=JaxServeConfig(top_k=5, max_query_len=8,
                                         max_batch=8))
    cfg = MODEL_REGISTRY["rdot_nll_condenser"](
        BertConfig.tiny(intermediate_size=128))
    model = DualEncoder(cfg)
    model.load_state_dict(convert.params_from_jax(jax.device_get(params), cfg))
    tsvc = RetrievalService(model, tokenizer, corpus, doc_ids=doc_ids,
                            cfg=ServeConfig(top_k=5, max_query_len=8,
                                            max_batch=8),
                            device="cpu")
    return jsvc, tsvc


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


@pytest.mark.parametrize(
    "mode", ["exact_fp32", "fast_search", "quantize_int8", "ivf", "mesh"])
def test_modes_not_ported_raise(mode):
    cfg = ServeConfig()
    kw = {}
    if mode == "mesh":
        kw["mesh"] = object()
    else:
        setattr(cfg, mode, True)
    model = DualEncoder(MODEL_REGISTRY["rdot_nll_condenser"](BertConfig.tiny()))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        RetrievalService(model, tokenizer, np.zeros((4, 32), np.float32),
                         cfg=cfg, device="cpu", **kw)
