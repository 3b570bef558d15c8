"""Shared by the benchmark's tests: the tiny cells under tests/data and a
CPU run of one of them through the harness."""
from pathlib import Path

from portbench import harness

DATA = Path(__file__).resolve().parent / "data"


def manifest():
    return harness.load_json(DATA / "manifest.json")


def run_tiny(cell, seed=7, seconds=0.3, trace=False):
    return harness.run_cell(manifest(), cell, seed, seconds, trace,
                            device="cpu", traffic_dir=DATA, limits_dir=DATA)


def tiny_ctx(cell, tmp_path, seed=7):
    import time

    m = manifest()
    files = harness.cell_files(m, harness.find_cell(m, cell),
                               traffic_dir=DATA, limits_dir=DATA)
    return harness.Ctx(files, seed, 0.0, False, "cpu", str(tmp_path),
                       time.perf_counter())
