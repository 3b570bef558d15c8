"""The readers of the program's spans (portbench/spans.py and the metrics of
source `program_span`): read from traced CPU runs of the tiny cells, their
arithmetic on made-up spans, None where the span is absent or the program
records none, and (on a card) the spans' clock against the device trace's."""
import bisect
import math
import statistics
import time

import pytest
import torch

from portbench import harness, spans
from portbench.tests import helpers

MS_METRICS = {"tiny.encode": ["issue_ms.encode", "gather_ms.encode"],
              "tiny.search": ["issue_ms.search"],
              "tiny.coco": ["collate_ms.train", "feed_wait_ms.train",
                            "issue_ms.train", "update_ms.train"]}
IDLE_METRICS = ["issue_idle_share.search", "feed_idle_share.train",
                "step_idle_share.train"]
MOVES = {"tiny.encode": "encode_docs_per_s", "tiny.search": "search_qps",
         "tiny.coco": "train_tokens_per_s"}


def with_span_metrics(manifest: dict) -> dict:
    """The tiny manifest with each cell's span metrics listed for it."""
    out = dict(manifest, per_layer=list(manifest["per_layer"]))
    for cell, names in MS_METRICS.items():
        out["per_layer"] += [{"name": n, "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "tests",
                              "moves": MOVES[cell], "workloads": [cell]}
                             for n in names]
    return out


@pytest.mark.parametrize("cell", sorted(MS_METRICS))
def test_traced_tiny_cells_read_every_span_metric(cell):
    line = harness.run_cell(with_span_metrics(helpers.manifest()), cell, 7,
                            0.3, True, device="cpu",
                            traffic_dir=helpers.DATA,
                            limits_dir=helpers.DATA)
    assert line["correct"] is True
    for name in MS_METRICS[cell]:
        v = line["metrics"][name]["value"]
        assert math.isfinite(v) and v >= 0, (name, v)


def record(name, start_us, end_us, thread=1, unit=None):
    from cocodr_tpu_torch.utils.logging import Span

    return Span(name, thread, start_us * 1000, end_us * 1000, None, unit)


def made_up(monkeypatch, records, device_ops=(), counts=None):
    """A traced window 0-1000 us over `records` in place of the program's
    log; device ops (name, start us, duration us)."""
    from cocodr_tpu_torch.utils import logging as tlog

    def recorded_spans(start_ns=0, end_ns=None):
        return [s for s in records if s.end_ns >= start_ns
                and (end_ns is None or s.start_ns <= end_ns)]

    monkeypatch.setattr(tlog, "recorded_spans", recorded_spans)
    ops = [(n, s * 1000, d * 1000) for n, s, d in device_ops]
    return harness.TraceRun(ops, [], (0, 1_000_000), {}, counts or {})


def test_readers_on_made_up_spans(monkeypatch):
    """Spans clipped to the window, mean times, the search's time outside
    its copies to the host over its queries, and idle shares as the overlap
    of the spans with the device's idle gaps."""
    us = 1e-3  # ms
    recs = [record("cocodr.encode.dispatch", -50, 100),  # clipped to 0-100
            record("cocodr.encode.dispatch", 200, 300),
            record("cocodr.coco.step", 100, 500, unit=3),
            record("cocodr.feed.wait", 500, 700, unit=4),
            record("cocodr.coco.step", 700, 1200, unit=4),  # to 1000
            record("cocodr.search", 0, 600),
            record("cocodr.search.to_host", 400, 500),
            record("cocodr.search.to_host", 550, 650)]
    # the device runs 0-200 and 600-800: idle 200-600 and 800-1000
    run = made_up(monkeypatch, recs, [("k", 0, 200), ("k", 600, 200)],
                  counts={"queries": 8192})

    def read(name):
        return harness.load_reader(name).read(run)

    assert read("issue_ms.encode") == pytest.approx(100 * us)
    assert read("issue_ms.train") == pytest.approx(350 * us)
    assert read("feed_wait_ms.train") == pytest.approx(200 * us)
    # 0-400 and 500-550 outside the copies, per 4,096 queries
    assert read("issue_ms.search") == pytest.approx(450 * us / 2)
    # idle 200-400 of 0-400 and 500-550: 250 us of the 1000 us window
    assert read("issue_idle_share.search") == pytest.approx(25.0)
    # steps 100-500 and 700-1000 meet the gaps at 200-500 and 800-1000
    assert read("step_idle_share.train") == pytest.approx(50.0)
    # the wait 500-700 meets the gap 500-600
    assert read("feed_idle_share.train") == pytest.approx(10.0)
    assert read("step_idle_share.train") + read("feed_idle_share.train") \
        <= harness.load_reader("idle_share.train").read(run) + 1e-9


def test_a_renamed_or_missing_span_reads_none(monkeypatch):
    """A span under another name, or a program without the recorder (a
    tree older than it), reads None and raises nothing; a span present
    but of no time reads 0."""
    run = made_up(monkeypatch, [record("cocodr.encode.dispatched", 0, 100),
                                record("cocodr.coco.step", 10, 10)],
                  [("k", 0, 100)], counts={"queries": 4096})
    for name in sum(MS_METRICS.values(), []) + IDLE_METRICS:
        if name not in ("issue_ms.train", "step_idle_share.train"):
            assert harness.load_reader(name).read(run) is None, name
    assert harness.load_reader("issue_ms.train").read(run) == 0.0
    assert harness.load_reader("step_idle_share.train").read(run) == 0.0
    from cocodr_tpu_torch.utils import logging as tlog

    monkeypatch.delattr(tlog, "recorded_spans")
    assert spans.spans(run, "cocodr.coco.step") == []
    assert harness.load_reader("issue_ms.train").read(run) is None


def test_interval_arithmetic():
    assert spans.union([(5, 7), (0, 2), (1, 3), (7, 8), (9, 9)]) == [
        (0, 3), (5, 8)]
    assert spans.subtract([(0, 10), (20, 30)], [(2, 3), (8, 22), (25, 26)]) \
        == [(0, 2), (3, 8), (22, 25), (26, 30)]
    assert spans.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10


@pytest.mark.card
def test_span_clock_matches_the_device_trace(tmp_path):
    """bert-base.encode traced for 3 s: the spans' clock is the device
    trace's. A `cocodr.encode.collect` span (the wait on a batch's event,
    recorded after the copy of its embeddings to the host) longer than
    1 ms holds the end of a device-to-host copy of the trace, the one it
    waited for, and such spans end a median of at most 1 ms after it. Not each of them: after the wait the host
    takes the interpreter lock back from the prefetch thread, which may
    hold it for its switch interval (5 ms); one span of 491 ended 6.8 ms
    after its copy in a 20 s window on an H100, the trace's own range of
    that span too. The encode cell's span metrics read numbers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = harness.load_json(harness.BENCHMARK)
    files = harness.cell_files(bench, harness.find_cell(bench,
                                                        "bert-base.encode"))
    ctx = harness.Ctx(files, 20231, 3.0, True, "cuda:0", str(tmp_path),
                      time.perf_counter())
    try:
        harness.load_driver(files.traffic["driver"]).run(ctx)
    finally:
        ctx.close()
    run = ctx.trace_run
    copies = sorted(s + d for n, s, d in run.device_ops
                    if n.startswith("Memcpy DtoH"))
    waits = [(s, e) for s, e in spans.spans(run, "cocodr.encode.collect")
             if e - s > 1_000_000]
    assert copies and waits
    after = []
    for s, e in waits:
        # the last copy to end before the span did, up to 0.2 ms of the
        # clocks' disagreement (kineto's host and device clocks agreed to
        # 4 us there, the log's ends with kineto's ranges to 0.17 ms)
        i = bisect.bisect_right(copies, e + 200_000)
        assert i and copies[i - 1] >= s, (s, e)
        after.append(e - copies[i - 1])
    assert statistics.median(after) <= 1_000_000, sorted(after)
    for name in ("issue_ms.encode", "gather_ms.encode"):
        assert harness.load_reader(name).read(run) > 0, name
