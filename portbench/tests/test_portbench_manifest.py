"""BENCHMARK.json against the benchmark's contract, and the discovery of
each cell's files by name."""
import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|proj|head|expansion|"
                    r"_dim$|_rank$|experts_per_tok)")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return harness.load_json(harness.BENCHMARK)


def test_keys_and_command(bench):
    assert set(bench) == TOP_KEYS
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert (harness.ROOT / bench["command"][1]).is_file()
    assert len(json.dumps(bench)) <= 64 * 1024


def test_run_seconds_fits_a_full_check(bench):
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24  # later PRs may fill the benchmark up to 24 cells
    total = (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_entries(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert c["file"].startswith("portbench/")
        assert (harness.ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert not any(WIDTHS.search(k) for k in c["reduced"])
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["name"] not in cells and w["config"] in names
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        cells.add(w["name"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert {w["config"] for w in bench["workloads"]} == names
    metrics = set()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in metrics
        metrics.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= cells if "workloads" in m else True
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert "bound" not in m and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must(bench):
    for w in bench["workloads"]:
        e2e = harness.cell_metrics(bench, w["name"], trace=False)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert harness.cell_metrics(bench, w["name"], trace=True)
        # each per-layer metric's `moves` is reported in its cells
        for m in harness.cell_metrics(bench, w["name"], trace=True):
            assert m["moves"] in names


def test_every_name_finds_its_files(bench):
    for w in bench["workloads"]:
        files = harness.cell_files(bench, w)
        driver = harness.load_driver(files.traffic["driver"])
        assert callable(driver.run) and callable(driver.readings)
        assert files.limits
    for m in bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]).read)
    for w in bench["workloads"]:
        assert any(m["name"].startswith("mfu")
                   for m in harness.cell_metrics(bench, w["name"], True))


def test_find_cell_and_metric_selection():
    bench = {"workloads": [{"name": "a.x"}, {"name": "b.y"}],
             "end_to_end": [{"name": "setup_s"},
                            {"name": "r", "workloads": ["a.x"]}],
             "per_layer": [{"name": "p", "moves": "r"},
                           {"name": "q", "moves": "setup_s",
                            "workloads": ["b.y"]}]}
    assert harness.find_cell(bench, "b.y") == {"name": "b.y"}
    with pytest.raises(harness.BenchError):
        harness.find_cell(bench, "c.z")
    assert [m["name"] for m in harness.cell_metrics(bench, "a.x", False)] \
        == ["setup_s", "r"]
    assert [m["name"] for m in harness.cell_metrics(bench, "b.y", False)] \
        == ["setup_s"]
    assert [m["name"] for m in harness.cell_metrics(bench, "a.x", True)] \
        == ["p"]
    assert [m["name"] for m in harness.cell_metrics(bench, "b.y", True)] \
        == ["q"]


def test_sub_seeds_take_large_seeds_and_differ_by_tag():
    big = 2 ** 31 + 12345
    assert harness.sub_seed(big, "a") == harness.sub_seed(big, "a")
    assert harness.sub_seed(big, "a") != harness.sub_seed(big, "b")
    assert harness.sub_seed(big, "a") != harness.sub_seed(big + 1, "a")
    assert 0 <= harness.sub_seed(2 ** 64 + 5, "w") < 2 ** 63
