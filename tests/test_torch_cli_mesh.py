"""The port CLI's --mesh, --cpu-devices N and their errors: the JAX CLI's
three mesh cases (tests/test_cli.py:207, 334, 581: warmup + eval-beir,
ance, coco; `slow` there) through `--cpu-devices 2 --mesh 2x1`, a
subprocess whose two spawned gloo ranks run the command, against the
port's own single-device CLI on the same files. Float32 on the CPU, dropout
off where a result is compared (a second rank draws other masks):
losses and parameters 1e-5 (the ranks' gradient all-reduce sums in another
order), metrics 1e-6, ann files byte-equal. Rank 0 alone prints: one JSON
line a step, as the JAX CLI's single controller prints. Beside them:
encode, serve --queries and serve --http over two ranks (rank 0 sends
each query batch to the other), --distributed joining a world
that torchrun's variables describe, a mesh the world does not fill
refused, and a model axis (tensor parallelism): warmup at --mesh 2x2 over
four ranks against the JAX CLI's --mesh 4x2 (1e-5), ance and encode at
--mesh 1x2 against the single-device CLI (the mined ann file and the
encodes byte-equal: inference runs on whole weights)."""
import json
import os
import signal
import socket
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from cocodr_tpu_torch import cli
from cocodr_tpu_torch.utils.train_state import PAYLOAD, latest_checkpoint
from test_torch_cli_fixtures import (  # noqa: F401
    CPU,
    hf_checkpoint,
    json_lines,
    write_beir,
    write_marco,
    write_triples,
)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH2 = ["--cpu-devices", "2", "--mesh", "2x1"]
TP2 = ["--cpu-devices", "2", "--mesh", "1x2"]


def run_cli(args, check=True, **env_vars):
    """python -m cocodr_tpu_torch.cli ARGS in a subprocess (env_vars added
    to its environment) -> the CompletedProcess."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **env_vars)
    p = subprocess.run([sys.executable, "-m", "cocodr_tpu_torch.cli", *args],
                       capture_output=True, text=True, env=env, timeout=600,
                       cwd=ROOT)
    if check:
        assert p.returncode == 0, p.stderr[-3000:]
    return p


def _payload(ckpt_dir):
    return torch.load(os.path.join(latest_checkpoint(str(ckpt_dir)), PAYLOAD),
                      map_location="cpu", weights_only=True)


def _params_close(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), **TOL,
                                   err_msg=k)


def test_warmup_and_eval_on_a_mesh(hf_checkpoint, tmp_path, capsys):
    """warmup (3 steps, batch 4, --no-dropout) then eval-beir: the two-rank
    run's step losses and checkpoint-3's parameters against the
    single-device CLI's, 1e-5, its metrics 1e-6; one JSON line a step, and
    the checkpoint written once."""
    triples = write_triples(tmp_path)
    task = write_beir(tmp_path, n_docs=40, name="scifact", seed=7)
    warm = ["warmup", "--triples", triples, "--checkpoint", hf_checkpoint,
            "--batch-size", "4", "--max-steps", "3", "--max-seq-len", "16",
            "--log-every", "1", "--no-dropout"]
    cli.main(warm + ["--ckpt-dir", str(tmp_path / "one"), *CPU])
    one = json_lines(capsys.readouterr().out)
    p = run_cli(warm + ["--ckpt-dir", str(tmp_path / "two"), *MESH2])
    two = json_lines(p.stdout)
    assert [r["step"] for r in two] == [1, 2, 3]
    np.testing.assert_allclose([r["loss"] for r in two],
                               [r["loss"] for r in one], **TOL)
    _params_close(_payload(tmp_path / "two")["model"],
                  _payload(tmp_path / "one")["model"])
    assert sorted(os.listdir(tmp_path / "two")) == ["checkpoint-3"]

    ev = ["eval-beir", "--data-dir", task, "--checkpoint", hf_checkpoint,
          "--batch-size", "8", "--top-k", "20", "--query-len", "8",
          "--doc-len", "16"]
    cli.main(ev + ["--work-dir", str(tmp_path / "w1"), *CPU])
    out = capsys.readouterr().out
    want = json_lines(out[out.index("{"):].replace("\n", ""))[0]
    p = run_cli(ev + ["--work-dir", str(tmp_path / "w2"), *MESH2])
    got = json_lines(p.stdout.replace("\n", ""))[0]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_ance_round_on_a_mesh(hf_checkpoint, tmp_path, capsys):
    """One `ance` round (mine, then 2 nll steps of batch 8, --no-dropout):
    the mined ann file byte-equal to the single-device run's, the round's
    dev metrics 1e-6, the parameters after it 1e-5; one round line."""
    data = write_marco(tmp_path)
    args = ["ance", "--data-dir", str(data), "--checkpoint", hf_checkpoint,
            "--rounds", "1", "--steps-per-round", "2", "--batch-size", "8",
            "--loss-kind", "nll", "--no-dropout"]
    cli.main(args + ["--ckpt-dir", str(tmp_path / "one"), *CPU])
    (want,) = [r for r in json_lines(capsys.readouterr().out) if "round" in r]
    p = run_cli(args + ["--ckpt-dir", str(tmp_path / "two"), *MESH2])
    (got,) = [r for r in json_lines(p.stdout) if "round" in r]
    assert got["steps"] == want["steps"] == 2
    for k, v in want.items():
        if k != "seconds" and not k.startswith("time_"):
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
    name = "ann_data/ann_training_data_0"
    assert (open(tmp_path / "two" / name).read()
            == open(tmp_path / "one" / name).read())
    _params_close(_payload(tmp_path / "two")["model"],
                  _payload(tmp_path / "one")["model"])


def test_coco_on_a_mesh(hf_checkpoint, tmp_path):
    """coco over two ranks (8 docs a batch: 16 spans, 8 a rank; dropout on,
    as the CLI trains): both steps run, checkpoint-2 is written, rank 0
    prints one finite loss line a step."""
    data_dir = write_beir(tmp_path, n_docs=16)
    cli.main(["preprocess-coco", "--data-dirs", data_dir, "--out",
              str(tmp_path / "spans"), "--tokenizer", hf_checkpoint])
    p = run_cli(["coco", "--train-dir", str(tmp_path / "spans"),
                 "--checkpoint", hf_checkpoint, "--ckpt-dir",
                 str(tmp_path / "ck"), "--batch-docs", "8", "--max-steps",
                 "2", "--max-seq-length", "16", "--save-steps", "2",
                 "--log-every", "1", *MESH2])
    recs = [r for r in json_lines(p.stdout) if "loss" in r]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert latest_checkpoint(str(tmp_path / "ck")).endswith("checkpoint-2")


def _records(hf_checkpoint, tmp_path):
    """preprocess-beir of a 40-document task of random words -> (the
    records' directory, its queries as a qid \\t text TSV)."""
    task = write_beir(tmp_path, n_docs=40, name="task", seed=7)
    rec = str(tmp_path / "rec")
    cli.main(["preprocess-beir", "--data-dir", task, "--out", rec,
              "--tokenizer", hf_checkpoint, "--task", "task",
              "--query-len", "8", "--doc-len", "16"])
    queries = tmp_path / "queries.tsv"
    with open(os.path.join(task, "queries.jsonl")) as f:
        queries.write_text("".join(
            f"{j['_id']}\t{j['text']}\n" for j in map(json.loads, f)))
    return rec, str(queries)


def _trec(path):
    return [ln.split() for ln in open(path).read().splitlines()]


def test_encode_and_serve_on_a_mesh(hf_checkpoint, tmp_path, capsys):
    """encode (batches of 8: 4 rows a rank) and serve --queries (the
    sharded service behind rank 0's Lockstep, the other rank following
    its searches) over two ranks against the single-device CLI: the .npy
    within 1e-5 (a rank's BLAS sums its 4 rows in another order), the
    TREC run's ids equal and its scores within 1e-5."""
    rec, queries = _records(hf_checkpoint, tmp_path)
    runs = {}
    for tag, extra in (("one", CPU), ("two", MESH2)):
        npy = str(tmp_path / f"{tag}.npy")
        enc = ["encode", "--checkpoint", hf_checkpoint, "--records",
               rec + "/passages", "--out", npy, "--batch-size", "8",
               *extra]
        serve = ["serve", "--checkpoint", hf_checkpoint, "--emb",
                 str(tmp_path / "one.npy"), "--id-map",
                 rec + "/passages.docid2offset.pickle", "--top-k", "5",
                 "--queries", queries, "--output",
                 str(tmp_path / f"{tag}.trec"), *extra]
        if tag == "one":
            cli.main(enc)
            cli.main(serve)
            capsys.readouterr()
        else:
            run_cli(enc)
            run_cli(serve)
        runs[tag] = _trec(tmp_path / f"{tag}.trec")
    np.testing.assert_allclose(np.load(tmp_path / "two.npy"),
                               np.load(tmp_path / "one.npy"), **TOL)
    assert len(runs["two"]) == len(runs["one"]) == 6 * 5
    for a, b in zip(runs["two"], runs["one"]):
        assert a[:4] == b[:4]
        assert abs(float(a[4]) - float(b[4])) <= 1e-5


def test_serve_http_on_a_mesh(hf_checkpoint, tmp_path, capsys):
    """serve --http over two ranks: rank 0 prints the ready line after the
    warm-up search (the follower rank joining it), /search answers equal
    the single-device service's (ids, scores 1e-5), and SIGINT to the
    command stops rank 0's server, whose close ends the follower: exit
    code 0."""
    from cocodr_tpu_torch.data.records import load_id_map
    from cocodr_tpu_torch.data.tokenizer import load_tokenizer
    from cocodr_tpu_torch.pipelines.serve import RetrievalService, ServeConfig

    rec, _ = _records(hf_checkpoint, tmp_path)
    npy = str(tmp_path / "one.npy")
    cli.main(["encode", "--checkpoint", hf_checkpoint, "--records",
              rec + "/passages", "--out", npy, *CPU])
    capsys.readouterr()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    id_map = rec + "/passages.docid2offset.pickle"
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "cocodr_tpu_torch.cli", "serve",
         "--checkpoint", hf_checkpoint, "--emb", npy, "--id-map", id_map,
         "--top-k", "3", "--http", f"127.0.0.1:{port}", *MESH2],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready == {"ready": True, "http": f"127.0.0.1:{port}",
                         "n_docs": 40}
        texts = ["alpha beta", "gamma", "delta epsilon zeta"]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/search",
            data=json.dumps({"queries": texts}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            hits = json.loads(r.read())["hits"]
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=120)
        finally:
            proc.kill()
            _, err = proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    off2id = {v: k for k, v in load_id_map(id_map).items()}
    svc = RetrievalService(
        cli._load_model(hf_checkpoint, "rdot_nll_condenser",
                        torch.device("cpu")),
        load_tokenizer(hf_checkpoint), np.load(npy),
        doc_ids=[off2id[i] for i in range(40)], cfg=ServeConfig(top_k=3),
        device="cpu")
    vals, ids = svc.search(texts)
    for q in range(3):
        assert [h["id"] for h in hits[q]] == ids[q]
        np.testing.assert_allclose([h["score"] for h in hits[q]], vals[q],
                                   **TOL)


def test_distributed_joins_the_environments_world(hf_checkpoint, tmp_path,
                                                  capsys):
    """--distributed with torchrun's variables for a world of one on this
    host (RANK 0, WORLD_SIZE 1, MASTER_ADDR 127.0.0.1, a free port):
    encode --mesh auto writes the single-device .npy bit for bit."""
    rec, _ = _records(hf_checkpoint, tmp_path)
    enc = ["encode", "--checkpoint", hf_checkpoint, "--records",
           rec + "/passages", "--batch-size", "8"]
    cli.main(enc + ["--out", str(tmp_path / "one.npy"), *CPU])
    capsys.readouterr()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    run_cli(enc + ["--out", str(tmp_path / "env.npy"), "--distributed",
                   "--mesh", "auto", *CPU],
            RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    assert (np.load(tmp_path / "env.npy").tobytes()
            == np.load(tmp_path / "one.npy").tobytes())


def test_warmup_on_a_model_axis_matches_the_jax_cli(hf_checkpoint, tmp_path,
                                                    capsys):
    """warmup --mesh 2x2 over four ranks (--cpu-devices 4: data 2, the
    layers split over model 2) against the JAX CLI's --mesh 4x2 (its
    shard_train_init splits the same layers by GSPMD) at the same global
    batch of 4, 3 steps, --no-dropout: the step losses and checkpoint-3's
    parameters (a whole checkpoint) within 1e-5 of the JAX CLI's."""
    import orbax.checkpoint as ocp

    from cocodr_tpu.cli import main as jax_main
    from cocodr_tpu_torch.models import convert

    triples = write_triples(tmp_path)
    warm = ["warmup", "--triples", triples, "--checkpoint", hf_checkpoint,
            "--batch-size", "4", "--max-steps", "3", "--max-seq-len", "16",
            "--log-every", "1", "--no-dropout", "--compile-cache", ""]
    jax_main(warm + ["--ckpt-dir", str(tmp_path / "jax"), "--mesh", "4x2"])
    want = [r["loss"] for r in json_lines(capsys.readouterr().out)
            if "loss" in r]
    p = run_cli(warm + ["--ckpt-dir", str(tmp_path / "tp"),
                        "--cpu-devices", "4", "--mesh", "2x2"])
    got = json_lines(p.stdout)
    assert [r["step"] for r in got] == [1, 2, 3]
    np.testing.assert_allclose([r["loss"] for r in got], want, **TOL)
    raw = ocp.PyTreeCheckpointer().restore(os.path.abspath(os.path.join(
        latest_checkpoint(str(tmp_path / "jax")), "state")))
    model = cli._load_model(hf_checkpoint, "rdot_nll_condenser",
                            torch.device("cpu"))
    jax_sd = convert.params_from_jax(raw["params"], model.cfg)
    _params_close(_payload(tmp_path / "tp")["model"], jax_sd)


def test_ance_and_encode_on_a_model_axis(hf_checkpoint, tmp_path, capsys):
    """ance (one round: mine, 2 nll steps, --no-dropout) and encode at
    --mesh 1x2 (--cpu-devices 2): the round mines from whole weights (the
    ann file byte-equal to the single-device run's, its dev metrics
    1e-6), trains the split layers (the parameters after it 1e-5, the
    checkpoint whole); encode's .npy equals the single-device one byte for
    byte."""
    data = write_marco(tmp_path)
    args = ["ance", "--data-dir", str(data), "--checkpoint", hf_checkpoint,
            "--rounds", "1", "--steps-per-round", "2", "--batch-size", "8",
            "--loss-kind", "nll", "--no-dropout"]
    cli.main(args + ["--ckpt-dir", str(tmp_path / "one"), *CPU])
    (want,) = [r for r in json_lines(capsys.readouterr().out) if "round" in r]
    p = run_cli(args + ["--ckpt-dir", str(tmp_path / "tp"), *TP2])
    (got,) = [r for r in json_lines(p.stdout) if "round" in r]
    for k, v in want.items():
        if k != "seconds" and not k.startswith("time_"):
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
    name = "ann_data/ann_training_data_0"
    assert (open(tmp_path / "tp" / name).read()
            == open(tmp_path / "one" / name).read())
    _params_close(_payload(tmp_path / "tp")["model"],
                  _payload(tmp_path / "one")["model"])

    rec, _ = _records(hf_checkpoint, tmp_path)
    enc = ["encode", "--checkpoint", hf_checkpoint, "--records",
           rec + "/passages", "--batch-size", "8"]
    cli.main(enc + ["--out", str(tmp_path / "one.npy"), *CPU])
    run_cli(enc + ["--out", str(tmp_path / "tp.npy"), *TP2])
    assert (np.load(tmp_path / "tp.npy").tobytes()
            == np.load(tmp_path / "one.npy").tobytes())


def test_a_mesh_the_world_does_not_fill_raises(hf_checkpoint, tmp_path):
    """--mesh 8x1 over a world of 2 ranks: each rank raises
    MeshConfig.resolve's ValueError and the command exits non-zero with
    it."""
    task = write_beir(tmp_path)
    p = run_cli(["eval-beir", "--data-dir", task, "--work-dir",
                 str(tmp_path / "w"), "--checkpoint", hf_checkpoint,
                 "--cpu-devices", "2", "--mesh", "8x1"], check=False)
    assert p.returncode != 0
    assert "ValueError: mesh 8x1 != 2 devices" in p.stderr
