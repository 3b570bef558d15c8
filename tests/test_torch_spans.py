"""The span recorder (utils/logging.py::span) and the spans the port places
at its layer boundaries: nothing is recorded without a profiler; under one,
a span is logged on the profiler's clock, traced on the profiling thread,
logged alone on other threads, nested by parent and grouped by unit; the
log is bounded. CPU only, one thread for torch."""
import json
import threading
import time

import numpy as np
import pytest
import torch

from cocodr_tpu_torch.data.coco_spans import span_batches
from cocodr_tpu_torch.data.prefetch import prefetch
from cocodr_tpu_torch.data.records import RecordWriter, TokenCache
from cocodr_tpu_torch.models.bert import BertConfig
from cocodr_tpu_torch.models.condenser import CoCondenserForPretraining
from cocodr_tpu_torch.models.dual_encoder import (
    DualEncoder,
    DualEncoderConfig,
)
from cocodr_tpu_torch.ops.mips import mips_topk_chunked_queries
from cocodr_tpu_torch.pipelines.coco import CocoConfig, build_coco_train_step
from cocodr_tpu_torch.pipelines.encode import (
    EncodeConfig,
    Encoder,
    encode_cache,
)
from cocodr_tpu_torch.utils import logging as tlog
from cocodr_tpu_torch.utils.train_state import TrainState

TINY = BertConfig(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                  num_attention_heads=2, intermediate_size=32,
                  max_position_embeddings=32)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def kineto_ranges(prof) -> dict:
    """name -> [(start ns, end ns)] of a stopped profile's events."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        out.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def logged_since(t0, names=None):
    return [s for s in tlog.recorded_spans(t0)
            if names is None or s.name in names]


def test_nothing_is_recorded_without_a_profiler(monkeypatch):
    """No profiler: span() hands back one shared no-op, opens no
    record_function and logs nothing; the same holds on a thread."""
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    last = tlog._log[-1] if tlog._log else None
    with tlog.span("cocodr.test.a", unit=1) as a:
        with tlog.span("cocodr.test.b"):
            pass
    worker = threading.Thread(target=lambda: tlog.span("cocodr.test.c"))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert a is None and tlog.span("x") is tlog.span("y")
    assert opened == [] and (tlog._log[-1] if tlog._log else None) is last


def test_main_thread_span_in_trace_and_log():
    """Under torch.profiler a span on the profiling thread is a
    record_function range of the trace and a record of the log (which
    holds the range), their starts and ends within 1 ms; repeated spans are counted
    apart. A span before them takes the process's one-time lookup of the
    profiler's operators (~1 ms on a busy CPU)."""
    t0 = time.time_ns()
    with profiled() as prof:
        with tlog.span("cocodr.test.first"):
            pass
        for unit in range(2):
            with tlog.span("cocodr.test.main", unit=unit):
                torch.ones(32, 32).matmul(torch.ones(32, 32))
    logged = logged_since(t0, {"cocodr.test.main"})
    traced = sorted(kineto_ranges(prof)["cocodr.test.main"])
    assert [s.unit for s in logged] == [0, 1] and len(traced) == 2
    for s, (start, end) in zip(logged, traced):
        assert s.thread == threading.get_ident() and s.parent is None
        assert s.start_ns <= s.end_ns
        assert abs(s.start_ns - start) < 1e6 and abs(s.end_ns - end) < 1e6


def test_thread_span_logged_not_traced():
    """A thread started inside the profile: its span is logged with the
    thread's own id, and torch.profiler's thread-local trace has none."""
    seen = {}

    def work():
        seen["id"] = threading.get_ident()
        with tlog.span("cocodr.test.thread", unit=5):
            torch.ones(8).sum()

    with profiled() as prof:
        t0 = time.time_ns()
        worker = threading.Thread(target=work)
        worker.start()
        worker.join(timeout=60)
    assert not worker.is_alive()
    (s,) = logged_since(t0, {"cocodr.test.thread"})
    assert s.thread == seen["id"] != threading.get_ident() and s.unit == 5
    assert "cocodr.test.thread" not in kineto_ranges(prof)


def test_parents_nest_and_units_inherit():
    """The enclosing span on the same thread is the parent; a span without
    a unit takes its parent's; one left by an exception is not logged and
    leaves the nesting as it was."""
    t0 = time.time_ns()
    with profiled():
        with tlog.span("cocodr.test.outer", unit=7):
            with tlog.span("cocodr.test.inner"):
                with tlog.span("cocodr.test.leaf", unit=9):
                    pass
            with pytest.raises(KeyError):
                with tlog.span("cocodr.test.raised"):
                    raise KeyError("x")
            with tlog.span("cocodr.test.after"):
                pass
    got = {s.name: s for s in logged_since(t0)}
    assert set(got) == {"cocodr.test.outer", "cocodr.test.inner",
                        "cocodr.test.leaf", "cocodr.test.after"}
    assert got["cocodr.test.outer"].parent is None
    assert got["cocodr.test.inner"].parent == "cocodr.test.outer"
    assert got["cocodr.test.leaf"].parent == "cocodr.test.inner"
    assert got["cocodr.test.after"].parent == "cocodr.test.outer"
    assert [got[n].unit for n in ("cocodr.test.outer", "cocodr.test.inner",
                                  "cocodr.test.leaf")] == [7, 7, 9]
    outer, leaf = got["cocodr.test.outer"], got["cocodr.test.leaf"]
    assert outer.start_ns <= leaf.start_ns <= leaf.end_ns <= outer.end_ns


class _Collator:
    """collate_spans of data/coco_collator.py's shape, on doc numbers."""

    def collate_spans(self, docs):
        return {"docs": np.asarray([d["n"] for d in docs])}


def test_prefetch_spans_share_the_item_number(tmp_path):
    """PrefetchIterator: each item's produce span (producer thread) and
    wait span (consumer) carry its number as unit; the collator's span
    runs inside the produce span and takes its unit; the end of the
    stream logs neither."""
    path = tmp_path / "spans.jsonl"
    path.write_text("".join(json.dumps({"n": i, "spans": [[1], [2]]}) + "\n"
                            for i in range(8)))
    t0 = time.time_ns()
    with profiled():
        got = [b["docs"] for b in prefetch(
            span_batches([str(path)], _Collator(), 2), depth=2,
            device_put=False)]
    assert len(got) == 4
    spans = logged_since(t0, {"cocodr.feed.produce", "cocodr.feed.wait",
                              "cocodr.coco.collate"})
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    produce, wait = by["cocodr.feed.produce"], by["cocodr.feed.wait"]
    assert sorted(s.unit for s in produce) == [0, 1, 2, 3]
    assert sorted(s.unit for s in wait) == [0, 1, 2, 3]
    assert all(s.thread == threading.get_ident() for s in wait)
    assert len({s.thread for s in produce}) == 1
    assert produce[0].thread != threading.get_ident()
    collate = by["cocodr.coco.collate"]
    assert sorted(s.unit for s in collate) == [0, 1, 2, 3]
    assert all(s.parent == "cocodr.feed.produce" for s in collate)
    for s in produce:  # an item is produced before it is taken
        (w,) = [x for x in wait if x.unit == s.unit]
        assert s.end_ns <= w.end_ns


def test_the_log_is_bounded():
    """Past SPAN_LOG_LIMIT records the oldest go first."""
    def many(n):
        for i in range(n):
            with tlog.span("cocodr.test.many", unit=i):
                pass

    t0 = time.time_ns()
    n = tlog.SPAN_LOG_LIMIT + 10
    with profiled():
        worker = threading.Thread(target=many, args=(n,))  # not traced
        worker.start()
        worker.join(timeout=120)
    assert not worker.is_alive()
    assert len(tlog._log) == tlog.SPAN_LOG_LIMIT
    units = [s.unit for s in logged_since(t0, {"cocodr.test.many"})]
    assert units == list(range(10, n))


def test_encode_loop_spans(tmp_path):
    """encode_cache: per batch one produce and one wait span (units 0..),
    one dispatch and one collect span on the calling thread."""
    rng = np.random.default_rng(0)
    with RecordWriter(str(tmp_path / "r"), 12) as w:
        for n in rng.integers(3, 13, 20):
            w.write(rng.integers(5, 64, n).astype(np.int32))
    torch.manual_seed(0)
    enc = Encoder(DualEncoder(DualEncoderConfig.rdot_nll_condenser(TINY)),
                  device="cpu")
    t0 = time.time_ns()
    with profiled():
        out = encode_cache(enc, TokenCache(str(tmp_path / "r")),
                           EncodeConfig(batch_size=8))
    assert out.shape == (20, 16)
    names = {}
    for s in logged_since(t0):
        names.setdefault(s.name, []).append(s)
    assert sorted(s.unit for s in names["cocodr.feed.produce"]) == [0, 1, 2]
    assert sorted(s.unit for s in names["cocodr.feed.wait"]) == [0, 1, 2]
    for name in ("cocodr.encode.dispatch", "cocodr.encode.collect"):
        assert len(names[name]) == 3
        assert all(s.thread == threading.get_ident() for s in names[name])


def test_search_spans():
    """mips_topk_chunked_queries by the hierarchical search: one search
    span holding the plan and a chunk span a query chunk, each chunk
    holding its sweep, selection, rescoring and copy to the host."""
    g = torch.Generator().manual_seed(0)
    corpus = torch.randn(3000, 16, generator=g)
    queries = torch.randn(300, 16, generator=g)
    t0 = time.time_ns()
    with profiled():
        v, i = mips_topk_chunked_queries(queries, corpus, 5, q_chunk=128,
                                         method="pallas",
                                         hbm_budget=1 << 30)
    assert v.shape == (300, 5)
    parents = {}
    for s in logged_since(t0):
        if s.name.startswith("cocodr.search"):
            parents.setdefault(s.name, []).append(s.parent)
    assert parents == {
        "cocodr.search": [None],
        "cocodr.search.plan": ["cocodr.search"],
        "cocodr.search.chunk": ["cocodr.search"] * 3,
        "cocodr.search.sweep": ["cocodr.search.chunk"] * 3,
        "cocodr.search.select": ["cocodr.search.chunk"] * 3,
        "cocodr.search.rescore": ["cocodr.search.chunk"] * 3,
        "cocodr.search.to_host": ["cocodr.search.chunk"] * 3,
    }


@pytest.mark.parametrize("cache_chunk_size", [0, 2])
def test_coco_step_spans(cache_chunk_size):
    """Both forms of the COCO step: one step span whose unit is the step
    number before it, holding one update span of the same unit."""
    torch.manual_seed(0)
    model = CoCondenserForPretraining(TINY, n_head_layers=1, skip_from=1)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))
    step = build_coco_train_step(CocoConfig(cache_chunk_size=cache_chunk_size))
    ids = torch.randint(5, 64, (4, 8), generator=torch.Generator()
                        .manual_seed(1))
    labels = torch.full_like(ids, -100)
    labels[:, 2] = ids[:, 2]
    batch = {"input_ids": ids, "attention_mask": torch.ones_like(ids),
             "labels": labels}
    t0 = time.time_ns()
    with profiled():
        for _ in range(2):
            step(state, batch)
    got = [(s.name, s.parent, s.unit) for s in logged_since(t0)
           if s.name.startswith("cocodr.coco.")]
    assert got == [("cocodr.coco.update", "cocodr.coco.step", 0),
                   ("cocodr.coco.step", None, 0),
                   ("cocodr.coco.update", "cocodr.coco.step", 1),
                   ("cocodr.coco.step", None, 1)]
