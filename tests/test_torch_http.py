"""The port's HTTP front end (pipelines/http_serve.py) on the CPU: the
JAX package's tests/test_serve.py HTTP tests through the port (dynamic
batching with answers equal to `RetrievalService.search`, a group split
across batches, 413, 503), the 400, 404, 411 and 504 answers, the
port's server against the JAX server on the same weights, and the
Batcher under thread stress. Answers of one
service equal its `search` exactly in ids and within 1e-5 in scores (the
JSON carries the same float32 values as Python floats)."""
import dataclasses
import http.client
import json
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu.pipelines import http_serve as jhttp
from cocodr_tpu.pipelines.serve import RetrievalService as JaxService
from cocodr_tpu.pipelines.serve import ServeConfig as JaxServeConfig
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig
from cocodr_tpu_torch.models.dual_encoder import DualEncoder, MODEL_REGISTRY
from cocodr_tpu_torch.pipelines.http_serve import (
    Batcher,
    QueueFullError,
    make_server,
)
from cocodr_tpu_torch.pipelines.serve import RetrievalService, ServeConfig

torch.set_num_threads(1)

VOCAB = 50


def tokenizer(texts, padding="max_length", truncation=True, max_length=16,
              return_tensors="np"):
    """Stand-in with the HuggingFace call signature: words "w{i}" are ids
    5 + i, [CLS] = 2, [SEP] = 3, [UNK] = 1, [PAD] = 0."""
    ids = np.zeros((len(texts), max_length), np.int64)
    mask = np.zeros_like(ids)
    for r, text in enumerate(texts):
        words = [5 + int(w[1:]) if w[1:].isdigit() and int(w[1:]) < VOCAB
                 else 1 for w in text.split()]
        toks = [2] + words[:max_length - 2] + [3]
        ids[r, :len(toks)] = toks
        mask[r, :len(toks)] = 1
    return {"input_ids": ids, "attention_mask": mask}


@pytest.fixture(scope="module")
def towers():
    jcfg = dataclasses.replace(JaxBertConfig.tiny(), initializer_range=0.2)
    jmodel = jax_build("rdot_nll_condenser", jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32),
                         jnp.ones((1, 8), jnp.int32))["params"]
    cfg = MODEL_REGISTRY["rdot_nll_condenser"](BertConfig.tiny())
    model = DualEncoder(cfg)
    model.load_state_dict(convert.params_from_jax(jax.device_get(params), cfg))
    corpus = np.random.default_rng(0).standard_normal((128, 32)).astype(
        np.float32)
    return jmodel, params, model, corpus


DOC_IDS = [f"d{i}" for i in range(128)]


@pytest.fixture(scope="module")
def svc(towers):
    return RetrievalService(towers[2], tokenizer, towers[3], doc_ids=DOC_IDS,
                            cfg=ServeConfig(top_k=5, max_batch=8,
                                            max_query_len=16),
                            device="cpu")


class Server:
    """make_server on a free port, served from a thread, closed after."""

    def __init__(self, service, make=make_server, **kw):
        self.server, self.batcher = make(service, port=0, **kw)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def request(self, method, path, body=None, headers=None, raw=None):
        c = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            if raw is not None:
                c.putrequest(method, path)
                for k, v in raw.items():
                    c.putheader(k, v)
                c.endheaders()
            else:
                c.request(method, path,
                          body=None if body is None else json.dumps(body),
                          headers=headers or {})
            r = c.getresponse()
            return r.status, json.loads(r.read()), r
        finally:
            c.close()

    def close(self):
        self.server.shutdown()
        self.batcher.stop()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


QUERIES = [f"w{i} w{(i * 3) % 50}" for i in range(12)]


def test_http_server_dynamic_batching(svc):
    """Concurrent requests coalesce into fewer dispatches than requests
    and return exactly what `search` returns."""
    ref_vals, ref_ids = svc.search(QUERIES)
    srv = Server(svc, window_s=0.05)
    try:
        status, health, _ = srv.request("GET", "/healthz")
        assert status == 200 and health["ok"] and health["n_docs"] == 128
        results = [None] * len(QUERIES)

        def fire(i):
            results[i] = srv.request("POST", "/search",
                                     {"query": QUERIES[i], "k": 5})

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(QUERIES))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for i, (status, res, _) in enumerate(results):
            assert status == 200
            got = res["hits"]
            assert [h["id"] for h in got] == list(ref_ids[i])
            np.testing.assert_allclose([h["score"] for h in got],
                                       ref_vals[i], rtol=1e-5)
        # 12 requests, max_batch 8, a 50 ms window: fewer dispatches
        assert srv.batcher.batches < srv.batcher.requests == 12
        status, multi, _ = srv.request("POST", "/search",
                                       {"queries": QUERIES[:3], "k": 2})
        assert status == 200 and len(multi["hits"]) == 3
        assert all(len(h) == 2 for h in multi["hits"])
        assert [h["id"] for h in multi["hits"][0]] == list(ref_ids[0][:2])
        # k above top_k (up to 1000) is searched at that k
        status, wide, _ = srv.request("POST", "/search",
                                      {"query": QUERIES[0], "k": 20})
        _, ref20 = svc.search(QUERIES[:1], top_k=20)
        assert status == 200 and [h["id"] for h in wide["hits"]] == ref20[0]
    finally:
        srv.close()


def test_http_batcher_splits_group_across_batches(svc):
    """A query group larger than max_batch spans several dispatches and
    comes back in order."""
    queries = [f"w{i} w{(i * 7) % 50}" for i in range(20)]
    ref_vals, ref_ids = svc.search(queries)
    b = Batcher(svc, window_s=0.01, depth=2)
    try:
        hits = b.submit_many(queries, 5, timeout=120)
        assert len(hits) == 20
        for i, row in enumerate(hits):
            assert [h["id"] for h in row] == list(ref_ids[i])
            np.testing.assert_allclose([h["score"] for h in row],
                                       ref_vals[i], rtol=1e-5)
        assert b.batches >= 3 and b.requests == 20  # ceil(20 / 8)
    finally:
        b.stop()


def test_http_server_rejects_oversized_body(svc):
    """Content-Length above the cap -> 413 before the body is read; a
    normal request still works afterwards."""
    srv = Server(svc, max_body_bytes=1024)
    try:
        big = {"query": "w1 " * 4000, "k": 5}
        status, res, _ = srv.request("POST", "/search", big)
        assert status == 413 and "exceeds" in res["error"]
        status, res, _ = srv.request("POST", "/search",
                                     {"query": "w1", "k": 3})
        assert status == 200 and len(res["hits"]) == 3
    finally:
        srv.close()


class Blocked:
    """Service stand-in whose dispatch does not return for `seconds`."""

    def __init__(self, cfg, seconds):
        self.cfg, self.seconds, self.n_docs = cfg, seconds, 0
        self.release = threading.Event()

    def dispatch(self, texts, k):
        self.release.wait(self.seconds)
        raise RuntimeError("released")

    def collect_many(self, pendings):  # never reached
        raise AssertionError


def test_http_batcher_saturated_queue_returns_503(svc):
    """A full bounded request queue gives QueueFullError, and the server
    answers 503 with Retry-After."""
    blocked = Blocked(svc.cfg, 30)
    b = Batcher(blocked, window_s=0.01, depth=1, queue_max=2)

    def _fill():
        try:
            b.submit_many(["a"] * 12, 3, timeout=0.1)
        except (QueueFullError, TimeoutError):
            pass

    t = threading.Thread(target=_fill, daemon=True)
    try:
        t.start()
        time.sleep(0.5)
        with pytest.raises(QueueFullError):
            b.submit_many(["z"] * 4, 3, timeout=1.0)
    finally:
        blocked.release.set()
        b.stop()
        t.join(timeout=10)
    srv = Server(Blocked(svc.cfg, 30), queue_max=2)
    try:
        status, res, r = srv.request("POST", "/search",
                                     {"queries": ["w1"] * 3, "k": 2})
        assert status == 503 and r.getheader("Retry-After") == "1"
    finally:
        srv.batcher.service.release.set()
        srv.close()


def test_http_server_times_out_with_504(svc):
    """A search that does not come back within the request timeout is
    answered 504."""
    blocked = Blocked(svc.cfg, 30)
    srv = Server(blocked, request_timeout_s=0.2)
    try:
        status, res, _ = srv.request("POST", "/search", {"query": "w1"})
        assert status == 504 and "timed out" in res["error"]
    finally:
        blocked.release.set()
        srv.close()


@pytest.mark.parametrize("case", ["bad_json", "not_object", "no_query",
                                  "k_zero", "k_too_big", "k_str",
                                  "queries_not_list"])
def test_http_server_answers_400(svc, case):
    srv = Server(svc)
    body = {"bad_json": None, "not_object": [1, 2], "no_query": {"k": 3},
            "k_zero": {"query": "w1", "k": 0},
            "k_too_big": {"query": "w1", "k": 1001},
            "k_str": {"query": "w1", "k": "3"},
            "queries_not_list": {"queries": "w1 w2"}}[case]
    try:
        if case == "bad_json":
            c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
            c.request("POST", "/search", body=b"{not json")
            r = c.getresponse()
            status, res = r.status, json.loads(r.read())
            c.close()
        else:
            status, res, _ = srv.request("POST", "/search", body)
        assert status == 400 and res["error"]
    finally:
        srv.close()


def test_http_server_answers_404_and_411(svc):
    srv = Server(svc)
    try:
        assert srv.request("GET", "/nope")[0] == 404
        assert srv.request("POST", "/other", {"query": "w1"})[0] == 404
        status, res, _ = srv.request("POST", "/search",
                                     raw={"Content-Length": "abc"})
        assert status == 411 and "Content-Length" in res["error"]
    finally:
        srv.close()


def test_http_server_matches_the_jax_server(towers, svc):
    """The port's server and the JAX server, each over its package's
    service on the same weights and corpus, answer the same ids (scores
    within 1e-3: the float32 towers agree to ~1e-5, which moves a bf16
    rounding of the query now and then, as tests/test_torch_serve.py
    holds the services)."""
    jmodel, params, _, corpus = towers
    jsvc = JaxService(jmodel, params, tokenizer, corpus, doc_ids=DOC_IDS,
                      cfg=JaxServeConfig(top_k=5, max_batch=8,
                                         max_query_len=16))
    jsvc.search(QUERIES[:1])  # compile
    port, jax_srv = Server(svc), Server(jsvc, make=jhttp.make_server)
    try:
        body = {"queries": QUERIES, "k": 5}
        s1, got, _ = port.request("POST", "/search", body)
        s2, want, _ = jax_srv.request("POST", "/search", body)
        assert s1 == s2 == 200
        for a, b in zip(got["hits"], want["hits"]):
            assert [h["id"] for h in a] == [h["id"] for h in b]
            np.testing.assert_allclose([h["score"] for h in a],
                                       [h["score"] for h in b], rtol=1e-3,
                                       atol=1e-3)
    finally:
        port.close()
        jax_srv.close()


def test_http_serves_the_ivf_service(towers):
    """The front end over an IVF service (ServeConfig.ivf) answers what
    the service's `search` answers."""
    svc = RetrievalService(towers[2], tokenizer, towers[3], doc_ids=DOC_IDS,
                           cfg=ServeConfig(top_k=5, max_batch=8,
                                           max_query_len=16, ivf=True,
                                           ivf_clusters=4, ivf_nprobe=2,
                                           ivf_block_size=16),
                           device="cpu")
    ref_vals, ref_ids = svc.search(QUERIES)
    srv = Server(svc, window_s=0.05)
    try:
        status, res, _ = srv.request("POST", "/search",
                                     {"queries": QUERIES, "k": 5})
        assert status == 200
        for i, row in enumerate(res["hits"]):
            assert [h["id"] for h in row] == list(ref_ids[i])
            np.testing.assert_allclose([h["score"] for h in row],
                                       ref_vals[i], rtol=1e-5)
    finally:
        srv.close()


class EchoService:
    """A service stand-in whose answers name the text they answer: id
    f"{text}:{j}" at rank j, score -j."""

    def __init__(self, max_batch):
        self.cfg = ServeConfig(top_k=5, max_batch=max_batch)
        self.n_docs = 0

    def dispatch(self, texts, k):
        return list(texts), k

    def collect_many(self, pendings):
        return [(np.tile(-np.arange(k, dtype=np.float32), (len(t), 1)),
                 [[f"{x}:{j}" for j in range(k)] for x in t])
                for t, k in pendings]


class GatedEcho(EchoService):
    """EchoService whose dispatch waits for `gate` to open."""

    def __init__(self, max_batch):
        super().__init__(max_batch)
        self.gate = threading.Event()

    def dispatch(self, texts, k):
        self.gate.wait(30)
        return super().dispatch(texts, k)


def test_batcher_stop_serves_queued_requests():
    """stop() with groups still queued behind a blocked dispatch: each of
    them is answered (none waits out its timeout), the waiting count
    returns to 0, and a group submitted after stop is refused at once."""
    svc = GatedEcho(max_batch=4)
    b = Batcher(svc, window_s=0.0, depth=1)
    answers, errors = {}, []

    def client(c):
        try:
            answers[c] = b.submit_many([f"q{c}a", f"q{c}b"], 3, timeout=30)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in threads:
        t.start()
    deadline = time.time() + 30
    while b.requests + b._waiting < 16:  # every group admitted
        assert time.time() < deadline
        time.sleep(0.001)
    assert b._waiting >= 12  # the first batch holds at most 4 queries
    threading.Timer(0.1, svc.gate.set).start()  # opens while stop() waits
    t0 = time.time()
    b.stop()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert time.time() - t0 < 5
    assert not errors, errors
    assert sorted(answers) == list(range(8)) and b._waiting == 0
    for c, hits in answers.items():
        assert [[h["id"] for h in row] for row in hits] == [
            [f"q{c}{s}:{j}" for j in range(3)] for s in "ab"]
    t0 = time.time()
    with pytest.raises(RuntimeError, match="stopping"):
        b.submit_many(["late"], 3, timeout=30)
    assert time.time() - t0 < 1


def test_batcher_under_thread_stress():
    """More client threads than cores, a short switch interval, groups of
    1-12 texts that split across batches of 8: every text gets its own
    answer at its own k, every admitted query is dispatched once, and the
    waiting count returns to 0."""
    import sys

    b = Batcher(EchoService(max_batch=8), window_s=0.001, depth=2,
                queue_max=64)
    errors, total = [], []
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def client(c):
        rng = np.random.default_rng(c)
        for r in range(25):
            texts = [f"c{c}r{r}q{i}" for i in range(rng.integers(1, 13))]
            k = int(rng.integers(1, 6))
            try:
                hits = b.submit_many(texts, k, timeout=60)
            except QueueFullError:
                continue
            total.append(len(texts))
            for text, row in zip(texts, hits):
                if [h["id"] for h in row] != [f"{text}:{j}"
                                              for j in range(k)]:
                    errors.append((text, row))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(32)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(saved)
        b.stop()
    assert not errors, errors[:3]
    assert b.requests == sum(total) and b._waiting == 0
    assert b.batches >= sum(total) / 8
