"""The port CLI's eval-beir and parity against the JAX CLI on the same
checkpoint and BEIR task: metrics within 1e-6 (both float32 on the CPU);
--int8-encode (K7's plain version against the JAX int8 tower), --search-
method ivf at full probe, --result-dir's group file, --log-dir's line;
parity's PASS, its FAIL with exit code 1, the published number found by
the checkpoint's name. The checkpoint is tests/test_cli.py's with its
weights scaled to std ~0.2, and the task's documents random words, so that
scores do not tie (tests/test_torch_eval.py's reason)."""
import json
import os
import shutil

import pytest
import torch

from cocodr_tpu.cli import main as jax_main
from cocodr_tpu_torch import cli
from test_torch_cli_fixtures import (  # noqa: F401
    CPU,
    hf_checkpoint,
    json_lines,
    write_beir,
)

torch.set_num_threads(1)
TOL = 1e-6


@pytest.fixture(scope="module")
def spread(hf_checkpoint, tmp_path_factory):
    """tests/test_cli.py's checkpoint with every weight matrix x 10."""
    d = tmp_path_factory.mktemp("spread")
    for name in os.listdir(hf_checkpoint):
        shutil.copy(os.path.join(hf_checkpoint, name), d / name)
    sd = torch.load(d / "pytorch_model.bin", weights_only=True)
    torch.save({k: v * 10 if v.dim() == 2 else v for k, v in sd.items()},
               d / "pytorch_model.bin")
    return str(d)


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    return write_beir(tmp_path_factory.mktemp("task"), n_docs=40,
                      name="scifact", seed=7)


def _eval(main, ckpt, task, work, extra=()):
    main(["eval-beir", "--data-dir", task, "--work-dir", str(work),
          "--checkpoint", ckpt, "--batch-size", "8", "--top-k", "20",
          "--query-len", "8", "--doc-len", "16", "--compile-cache", "",
          *extra])


def _metrics(capsys):
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


def assert_metrics_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=TOL), k


@pytest.mark.parametrize("extra", [[], ["--int8-encode"]],
                         ids=["float", "int8"])
def test_eval_beir_metrics_equal_the_jax_clis(spread, task, tmp_path,
                                              capsys, extra):
    _eval(jax_main, spread, task, tmp_path / "jax", extra)
    want = _metrics(capsys)
    _eval(cli.main, spread, task, tmp_path / "port", [*extra, *CPU])
    got = _metrics(capsys)
    assert_metrics_close(got, want)
    assert got["num_queries"] == 6 and 0 < got["ndcg_cut_10"] < 1


def test_eval_beir_ivf_result_and_log_dirs(spread, task, tmp_path, capsys):
    """--search-method ivf at full probe ranks as the exact search (the
    JAX CLI's default); --result-dir writes the JAX CLI's group file,
    --log-dir its metrics line (values within 1e-6)."""
    _eval(jax_main, spread, task, tmp_path / "jax",
          ["--result-dir", str(tmp_path / "jres"), "--result-num", "3",
           "--log-dir", str(tmp_path / "jlog")])
    want = _metrics(capsys)
    _eval(cli.main, spread, task, tmp_path / "port",
          ["--search-method", "ivf", "--ivf-nprobe", "64",
           "--result-dir", str(tmp_path / "pres"), "--result-num", "3",
           "--log-dir", str(tmp_path / "plog"), *CPU])
    got = _metrics(capsys)
    assert_metrics_close(got, want)
    name = "ann_ndcg_group_scifact_3"
    j = json.loads((tmp_path / "jres" / name).read_text())
    p = json.loads((tmp_path / "pres" / name).read_text())
    assert p["checkpoint"] == j["checkpoint"] == spread
    assert p["ndcg"] == pytest.approx(j["ndcg"], abs=TOL)
    (jl,) = json_lines((tmp_path / "jlog" / "metrics.jsonl").read_text())
    (pl,) = json_lines((tmp_path / "plog" / "metrics.jsonl").read_text())
    assert pl["step"] == jl["step"] == 3
    assert_metrics_close({k: v for k, v in pl.items() if k != "step"},
                         {k: v for k, v in jl.items() if k != "step"})
    assert "beir/scifact/ndcg_cut_10" in pl


def _parity(main, ckpt, task, work, extra=()):
    main(["parity", "--checkpoint", ckpt, "--beir-dir", task,
          "--work-dir", str(work), "--batch-size", "8", "--top-k", "20",
          "--query-len", "8", "--doc-len", "16", "--compile-cache", "",
          *extra])


def test_parity_pass_fail_and_published_numbers(spread, task, tmp_path,
                                                capsys):
    """Without a published number: the report only, its average within
    1e-6 of the JAX CLI's; --expect-ndcg at that average PASSes, half a
    point off FAILs with exit code 1; a checkpoint named cocodr-base is
    held against the published 0.288."""
    _parity(jax_main, spread, task, tmp_path / "jw")
    want = json_lines(capsys.readouterr().out)[-1]
    _parity(cli.main, spread, task, tmp_path / "pw", CPU)
    out = capsys.readouterr().out
    got = json_lines(out)[-1]
    assert "no published number" in out and "parity" not in got
    assert got["tasks"].keys() == {"scifact"}
    assert got["tasks"]["scifact"] == pytest.approx(
        want["tasks"]["scifact"], abs=TOL)
    avg = got["avg_ndcg_cut_10"]
    _parity(cli.main, spread, task, tmp_path / "pw",
            ["--expect-ndcg", str(avg), *CPU])
    out = capsys.readouterr().out
    assert json_lines(out)[-1]["parity"] == "PASS" and "parity PASS" in out
    with pytest.raises(SystemExit) as ei:
        _parity(cli.main, spread, task, tmp_path / "pw",
                ["--expect-ndcg", str(avg + 0.5), *CPU])
    assert ei.value.code == 1
    assert json_lines(capsys.readouterr().out)[-1]["parity"] == "FAIL"
    named = tmp_path / "cocodr-base"
    shutil.copytree(spread, named)
    with pytest.raises(SystemExit):
        _parity(cli.main, str(named), task, tmp_path / "pw", CPU)
    assert json_lines(capsys.readouterr().out)[-1]["expected"] == 0.288
