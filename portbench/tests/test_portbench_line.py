"""The result line's shape, the trace readers on a made-up trace, the
import check, and run.py's refusals on a machine without a card."""
import ast
import json
import subprocess
import sys
import types

import pytest

from portbench import harness
from portbench.tests import helpers

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_line_of_an_untraced_run():
    line = helpers.run_tiny("tiny.encode")
    assert list(line)[:5] == LINE_KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "encode_docs_per_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_line_of_a_traced_run():
    line = helpers.run_tiny("tiny.encode", trace=True)
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert line["device"]["window_s"] > 0
    b = line["breakdown"]
    assert set(b) == {"device_ops", "idle_gaps"}
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    # a CPU run has no device operations: no per-layer metric is read
    assert line["metrics"] == {}


def made_up_trace(counts=None, calls=None):
    """Times in microseconds (ns x 1000): gaps past the 20 us of a launch."""
    us = 1000
    ops = [("void gemm_kernel<0, 128, EpiUp>(...)", 1000 * us, 400 * us),
           ("ln1_kernel(...)", 1500 * us, 100 * us),
           ("ampere_bf16_s16816gemm_bf16_128x64", 1610 * us, 390 * us),
           ("Memcpy HtoD (Pageable -> Device)", 3000 * us, 500 * us)]
    host = [("portbench.unit", 0, 5000 * us, 1),
            ("aten::mm", 1550 * us, 200 * us, 1),
            ("cudaStreamSynchronize", 2100 * us, 800 * us, 1)]
    return harness.TraceRun(ops, host, (0, 5000 * us), calls or {},
                            counts or {})


def test_trace_arithmetic():
    run = made_up_trace()
    us = 1000
    assert run.busy_intervals() == [
        (1000 * us, 1400 * us), (1500 * us, 1600 * us),
        (1610 * us, 2000 * us), (3000 * us, 3500 * us)]
    assert run.busy_s() == pytest.approx(1390e-6)
    assert run.idle_percent() == pytest.approx(100 * (1 - 1390 / 5000))
    gaps = dict((n, s) for n, s in run.breakdown()["idle_gaps"])
    # 0-1000 and 3500-5000 under the unit alone; 1400-1500 under the unit;
    # 2000-3000 under the sync; 1600-1610 is a launch's gap
    assert gaps["portbench.unit"] == pytest.approx(2600e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(1000e-6)
    assert gaps["short gaps between device ops (under 20 us)"] == \
        pytest.approx(10e-6)
    ops = run.breakdown()["device_ops"]
    assert ops[0][0].startswith("Memcpy") and ops[0][1] == 500e-6


def test_readers_on_a_made_up_trace():
    enc = harness.load_reader("ffn_roofline.encode")
    # one K1 launch at T = 32,768: its least time over the 500 us of the
    # K1 kernels (the GEMM and LN1; cuBLAS's product is not K1's)
    run = made_up_trace(calls={"K1": [((32768, 768), (768,), (768,),
                                       (3072, 768))]})
    least = 4 * 32768 * 768 * 3072 / 989e12
    assert enc.read(run) == pytest.approx(100 * least / 500e-6)
    assert enc.read(made_up_trace()) is None  # no launch recorded
    batch = harness.load_reader("batch_card_ms.encode")
    assert batch.read(made_up_trace(counts={"batches": 2})) == \
        pytest.approx(1e3 * 1390e-6 / 2)
    mfu = harness.load_reader("mfu.encode")
    assert mfu.read(made_up_trace(counts={"useful_flops": 989e12})) == \
        pytest.approx(100 / 5e-3)


def test_a_listed_metric_that_reads_nothing_fails_on_the_card():
    wanted = [{"name": "batch_card_ms.encode", "unit": "ms"},
              {"name": "ffn_roofline.encode", "unit": "%"}]
    run = made_up_trace(counts={"batches": 2})  # no K1 launch recorded
    with pytest.raises(harness.BenchError, match="ffn_roofline.encode"):
        harness.read_metrics(wanted, run, on_device=True)
    # a CPU run has no device trace: what reads nothing is left out
    assert set(harness.read_metrics(wanted, run, on_device=False)) == {
        "batch_card_ms.encode"}


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cocodr_tpu_torch_probe",
                        types.ModuleType("cocodr_tpu_torch_probe"))
    monkeypatch.setitem(sys.modules, "jaxtyping_probe",
                        types.ModuleType("jaxtyping_probe"))
    clean = [m for m in harness.forbidden_modules()]
    assert "cocodr_tpu" not in clean and "jax" not in clean
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert "jax" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cocodr_tpu",
                        types.ModuleType("cocodr_tpu"))
    assert "cocodr_tpu" in harness.forbidden_modules()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_sources_import_neither_jax_nor_the_jax_package():
    for path in harness.PKG.rglob("*.py"):
        assert not set(_imports(path)) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (harness.PKG / "reference").rglob("*.py"):
        tops = set(_imports(path))
        assert "cocodr_tpu_torch" not in tops, path
        assert tops <= {"__future__", "contextlib", "math", "typing",
                        "numpy", "torch", "portbench"}, (path, tops)
        src = path.read_text()
        for name in ("portbench.drivers", "portbench.program",
                     "portbench.harness"):
            assert name not in src, (path, name)


def test_run_refuses_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, str(harness.PKG / "run.py"), "--workload",
         "bert-base.encode", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=harness.ROOT, timeout=120)
    assert out.returncode == 3
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
