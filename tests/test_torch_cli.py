"""The port's CLI (cocodr_tpu_torch/cli.py) on the CPU against the JAX
CLI on the same tiny HuggingFace checkpoint: preprocess-beir -> encode ->
serve (stdin REPL, --queries bulk TREC run, --search-method ivf, --http in
a subprocess), tests/test_cli.py's encode/serve tests through the port.

Tolerances: both CLIs compute the float32 model of config.json on the CPU
(the port computes in bf16 only on the card), so the .npy embeddings agree
within 2e-5, as tests/test_torch_encode.py holds encode_cache. Served
scores agree within 1e-3: both searches round the float32 query
embeddings, which agree to ~1e-5, to bf16, and such a difference moves a
bf16 rounding now and then (tests/test_torch_serve.py's bound). The
fixture's documents repeat four texts, so documents d{i} and d{i+4} tie
exactly and ids are compared by text (i % 4)."""
import io
import json
import os
import signal
import socket
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from cocodr_tpu.cli import main as jax_main
from cocodr_tpu_torch import cli
from cocodr_tpu_torch.data.records import TokenCache, load_id_map
from cocodr_tpu_torch.data.tokenizer import load_tokenizer
from cocodr_tpu_torch.pipelines.encode import (
    EncodeConfig,
    Encoder,
    encode_cache,
)
from cocodr_tpu_torch.pipelines.serve import RetrievalService, ServeConfig

transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--cpu-devices", "1"]


@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    """Tiny HF BertForMaskedLM checkpoint dir + matching tokenizer files
    (tests/test_cli.py's fixture), written as pytorch_model.bin."""
    d = tmp_path_factory.mktemp("hf_ckpt")
    torch.manual_seed(0)
    cfg = transformers.BertConfig(
        vocab_size=40, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64,
    )
    m = transformers.BertForMaskedLM(cfg)
    m.save_pretrained(str(d), safe_serialization=False)
    vocab = (
        "[PAD] [UNK] [CLS] [SEP] [MASK] alpha beta gamma delta epsilon "
        "zeta eta theta iota kappa filler study report".split()
    )
    (d / "vocab.txt").write_text("\n".join(vocab))
    tok = transformers.BertTokenizerFast(vocab_file=str(d / "vocab.txt"))
    tok.save_pretrained(str(d))
    return str(d)


def _write_beir(tmp_path):
    beir = tmp_path / "beir"
    (beir / "qrels").mkdir(parents=True)
    words = ["alpha", "beta", "gamma", "delta"]
    with open(beir / "corpus.jsonl", "w") as f:
        for i in range(8):
            w = words[i % 4]
            f.write(json.dumps({"_id": f"d{i}", "title": "",
                                "text": f"{w} {w} filler"}) + "\n")
    with open(beir / "queries.jsonl", "w") as f:
        for j, w in enumerate(words):
            f.write(json.dumps({"_id": f"q{j}", "text": w}) + "\n")
    with open(beir / "qrels" / "test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for j in range(4):
            for i in range(8):
                if i % 4 == j:
                    f.write(f"q{j}\td{i}\t1\n")
    return str(beir)


def _preprocess(main, hf_checkpoint, data_dir, out):
    main(["preprocess-beir", "--data-dir", data_dir, "--out", out,
          "--tokenizer", hf_checkpoint, "--task", "smoke",
          "--query-len", "8", "--doc-len", "12"])


def _json_lines(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def _texts(ids):
    return [int(str(d).lstrip("d")) % 4 for d in ids]


@pytest.fixture(scope="module")
def encoded(hf_checkpoint, tmp_path_factory):
    """Both CLIs' preprocess-beir and encode on the same checkpoint and
    task -> (tmp dir, port records dir, port .npy, JAX .npy)."""
    tmp = tmp_path_factory.mktemp("enc")
    data_dir = _write_beir(tmp)
    _preprocess(cli.main, hf_checkpoint, data_dir, str(tmp / "rec"))
    _preprocess(jax_main, hf_checkpoint, data_dir, str(tmp / "jrec"))
    for main, rec, out, extra in (
            (cli.main, "rec", "corpus.npy", CPU),
            (jax_main, "jrec", "jcorpus.npy", [])):
        main(["encode", "--checkpoint", hf_checkpoint,
              "--records", str(tmp / rec / "passages"),
              "--out", str(tmp / out), "--batch-size", "4",
              "--compile-cache", ""] + extra)
    return tmp, str(tmp / "rec"), str(tmp / "corpus.npy"), str(
        tmp / "jcorpus.npy")


def test_preprocess_beir_records_equal_the_jax_clis(encoded):
    """The port's WordPiece tokenizer writes the records and id maps the
    JAX CLI writes through AutoTokenizer, byte for byte."""
    tmp = encoded[0]
    for name in ("passages", "passages_meta", "queries", "queries_meta"):
        assert (tmp / "rec" / name).read_bytes() == (
            tmp / "jrec" / name).read_bytes(), name
    assert load_id_map(str(tmp / "rec" / "passages.docid2offset.pickle")) \
        == load_id_map(str(tmp / "jrec" / "passages.docid2offset.pickle"))


def test_encode_npy_matches_the_jax_cli_and_encode_cache(encoded,
                                                         hf_checkpoint,
                                                         capsys):
    """The port CLI's embeddings: within 2e-5 of the JAX CLI's (both
    float32 on the CPU) and equal to the in-process encode_cache of the
    same checkpoint; --int8-encode (K7's plain version) stays close."""
    tmp, rec, port_npy, jax_npy = encoded
    e, j = np.load(port_npy), np.load(jax_npy)
    assert e.shape == (8, 32) and e.dtype == np.float32
    np.testing.assert_allclose(e, j, rtol=2e-5, atol=2e-5)
    model = cli._load_model(hf_checkpoint, "rdot_nll_condenser",
                            torch.device("cpu"))
    direct = encode_cache(Encoder(model, device="cpu"),
                          TokenCache(rec + "/passages"),
                          EncodeConfig(batch_size=4))
    np.testing.assert_array_equal(e, direct)
    capsys.readouterr()
    cli.main(["encode", "--checkpoint", hf_checkpoint, "--records",
              rec + "/passages", "--out", str(tmp / "i8.npy"),
              "--batch-size", "4", "--int8-encode"] + CPU)
    info = _json_lines(capsys.readouterr().out)[0]
    assert info == {"out": str(tmp / "i8.npy"), "n": 8, "dim": 32}
    e8 = np.load(tmp / "i8.npy")
    cos = np.sum(e * e8, axis=1) / np.maximum(
        np.linalg.norm(e, axis=1) * np.linalg.norm(e8, axis=1), 1e-9)
    assert cos.min() > 0.98, cos


def test_cli_encode_and_serve(encoded, hf_checkpoint, capsys, monkeypatch):
    """tests/test_cli.py's encode -> serve: the REPL answers a stdin query
    against the .npy with the JAX CLI's hits (ids by text, scores 1e-3)."""
    tmp, rec, port_npy, _ = encoded
    outs = []
    for main, extra in ((cli.main, CPU), (jax_main, [])):
        monkeypatch.setattr("sys.stdin", io.StringIO("alpha filler\n\n"))
        capsys.readouterr()
        main(["serve", "--checkpoint", hf_checkpoint, "--emb", port_npy,
              "--id-map", rec + "/passages.docid2offset.pickle",
              "--top-k", "3", "--compile-cache", ""] + extra)
        outs.append(_json_lines(capsys.readouterr().out))
    got, want = outs
    assert got[0] == {"ready": True, "n_docs": 8} and len(got) == 2
    hits, jhits = got[1]["hits"], want[1]["hits"]
    assert len(hits) == 3 and all(h["id"].startswith("d") for h in hits)
    assert _texts([h["id"] for h in hits]) == _texts(
        [h["id"] for h in jhits])
    np.testing.assert_allclose([h["score"] for h in hits],
                               [h["score"] for h in jhits], atol=1e-3,
                               rtol=1e-3)


def test_cli_serve_from_records_fast_mode(encoded, hf_checkpoint, capsys,
                                          monkeypatch):
    """serve --records (encode at startup) with --fast. The 8 documents
    are one fine block of 8 rows, and the block-argmax search returns one
    row a fine block: one real hit, the other slots -inf, as the JAX
    package's Pallas kernel gives (ops/mips_hier.py::mips_topk_fast; the
    JAX CLI's test runs its exact blockmax search off the TPU). The hit
    is the exact search's first."""
    _, rec, _, _ = encoded
    monkeypatch.setattr("sys.stdin", io.StringIO("beta filler\n\n"))
    capsys.readouterr()
    cli.main(["serve", "--checkpoint", hf_checkpoint, "--records",
              rec + "/passages", "--top-k", "5", "--fast", "--batch-size",
              "4"] + CPU)
    lines = _json_lines(capsys.readouterr().out)
    assert lines[0]["ready"] and lines[0]["n_docs"] == 8
    hits = lines[1]["hits"]
    assert len(hits) == 5
    scores = [h["score"] for h in hits]
    assert np.isfinite(scores[0]) and np.isneginf(scores[1:]).all()
    monkeypatch.setattr("sys.stdin", io.StringIO("beta filler\n"))
    capsys.readouterr()
    cli.main(["serve", "--checkpoint", hf_checkpoint, "--records",
              rec + "/passages", "--top-k", "5", "--batch-size", "4"] + CPU)
    exact = _json_lines(capsys.readouterr().out)[1]["hits"]
    assert all(np.isfinite(h["score"]) for h in exact)
    assert hits[0]["score"] == pytest.approx(exact[0]["score"], rel=1e-5)
    assert _texts([hits[0]["id"]]) == _texts([exact[0]["id"]])


def _service(hf_checkpoint, rec, npy, **cfg):
    model = cli._load_model(hf_checkpoint, "rdot_nll_condenser",
                            torch.device("cpu"))
    off2id = {v: k for k, v in load_id_map(
        rec + "/passages.docid2offset.pickle").items()}
    return RetrievalService(model, load_tokenizer(hf_checkpoint),
                            np.load(npy),
                            doc_ids=[off2id[i] for i in range(8)],
                            cfg=ServeConfig(**cfg), device="cpu")


QUERIES = "q1\talpha filler\nq2\tbeta words\nq3\tgamma text\n"


@pytest.mark.parametrize("mode", ["default", "ivf"])
def test_cli_serve_bulk_trec_run(encoded, hf_checkpoint, tmp_path, mode):
    """serve --queries: a bulk TSV -> a TREC run through search_stream,
    the cocodr_tpu run tag kept; its lines equal the in-process service's
    search; with --search-method ivf (full probe: 4 clusters, nprobe 32)
    it ranks as the default exact search (ids by text)."""
    _, rec, npy, _ = encoded
    queries = tmp_path / "queries.tsv"
    queries.write_text(QUERIES)
    runs = {}
    for m in ("default", mode):
        run_path = tmp_path / f"{m}.trec"
        cli.main(["serve", "--checkpoint", hf_checkpoint, "--emb", npy,
                  "--id-map", rec + "/passages.docid2offset.pickle",
                  "--top-k", "3", "--queries", str(queries),
                  "--output", str(run_path), "--stream-depth", "2"]
                 + (["--search-method", "ivf"] if m == "ivf" else []) + CPU)
        runs[m] = [ln.split() for ln in run_path.read_text().splitlines()]
    lines = runs[mode]
    assert len(lines) == 9  # 3 queries x top-3
    for qid, q0, did, rank, score, tag in lines:
        assert q0 == "Q0" and tag == "cocodr_tpu" and did.startswith("d")
    svc = _service(hf_checkpoint, rec, npy, top_k=3, ivf=mode == "ivf")
    vals, ids = svc.search(["alpha filler", "beta words", "gamma text"])
    for q in range(3):
        rows = lines[3 * q: 3 * q + 3]
        assert [r[0] for r in rows] == [f"q{q + 1}"] * 3
        assert [int(r[3]) for r in rows] == [1, 2, 3]
        assert [r[2] for r in rows] == ids[q]
        assert [float(r[4]) for r in rows] == [
            float(f"{v:.6f}") for v in vals[q]]
        base = runs["default"][3 * q: 3 * q + 3]
        assert _texts([r[2] for r in rows]) == _texts([r[2] for r in base])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("mode", ["default", "ivf"])
def test_cli_serve_http_in_a_subprocess(encoded, hf_checkpoint, mode):
    """serve --http: the ready line after one warm-up search, /healthz,
    and /search answers equal to the in-process service's search; SIGINT
    stops the server."""
    _, rec, npy, _ = encoded
    port = _free_port()
    cmd = [sys.executable, "-m", "cocodr_tpu_torch.cli", "serve",
           "--checkpoint", hf_checkpoint, "--emb", npy,
           "--id-map", rec + "/passages.docid2offset.pickle", "--top-k", "3",
           "--http", f"127.0.0.1:{port}"] + CPU
    if mode == "ivf":
        cmd += ["--search-method", "ivf", "--ivf-nprobe", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready == {"ready": True, "http": f"127.0.0.1:{port}",
                         "n_docs": 8}
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["n_docs"] == 8
        texts = ["alpha filler", "delta", "beta gamma"]
        req = urllib.request.Request(
            base + "/search", data=json.dumps({"queries": texts}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            hits = json.loads(r.read())["hits"]
        kw = dict(ivf=True, ivf_nprobe=2) if mode == "ivf" else {}
        vals, ids = _service(hf_checkpoint, rec, npy, top_k=3,
                             **kw).search(texts)
        for q in range(3):
            assert [h["id"] for h in hits[q]] == ids[q]
            np.testing.assert_allclose([h["score"] for h in hits[q]],
                                       vals[q], rtol=1e-6)
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        finally:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0


def test_load_model_heads_towers_and_weights(hf_checkpoint, tmp_path):
    """A bare backbone loads into rdot_nll_condenser whole; rdot_nll and
    DPR get their head / poolers fresh from the seed (the same draw twice,
    another with another seed); DPR's two towers both come from the one
    backbone; model.safetensors reads as pytorch_model.bin does; a
    checkpoint of another model's keys is refused."""
    cpu = torch.device("cpu")
    plain = cli._load_model(hf_checkpoint, "rdot_nll_condenser", cpu)
    assert plain.cfg.bert.dtype == torch.float32
    a = cli._load_model(hf_checkpoint, "rdot_nll", cpu, seed=1)
    b = cli._load_model(hf_checkpoint, "rdot_nll", cpu, seed=1)
    c = cli._load_model(hf_checkpoint, "rdot_nll", cpu, seed=2)
    assert torch.equal(a.head.dense.weight, b.head.dense.weight)
    assert not torch.equal(a.head.dense.weight, c.head.dense.weight)
    for k, v in plain.encoder.state_dict().items():
        assert torch.equal(a.encoder.state_dict()[k], v), k
    dpr = cli._load_model(hf_checkpoint, "dpr", cpu)
    enc, doc = dpr.encoder.state_dict(), dpr.doc_encoder.state_dict()
    for k, v in plain.encoder.state_dict().items():
        assert torch.equal(enc[k], v) and torch.equal(doc[k], v), k
    assert "pooler.dense.weight" in enc
    i8 = cli._load_model(hf_checkpoint, "rdot_nll_condenser", cpu,
                         int8_encode=True)
    assert i8.cfg.bert.matmul_int8
    st = tmp_path / "st"
    st.mkdir()
    (st / "config.json").write_text(
        (Path(hf_checkpoint) / "config.json").read_text())
    from safetensors.torch import save_file

    sd = torch.load(Path(hf_checkpoint) / "pytorch_model.bin",
                    weights_only=True)
    save_file({k: v.clone() for k, v in sd.items()},
              str(st / "model.safetensors"))
    from_st = cli._load_model(str(st), "rdot_nll_condenser", cpu)
    for k, v in plain.state_dict().items():
        assert torch.equal(from_st.state_dict()[k], v), k
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "config.json").write_text(
        (Path(hf_checkpoint) / "config.json").read_text())
    torch.save({"bert.embeddings.word_embeddings.weight": torch.zeros(40, 32)},
               bad / "pytorch_model.bin")
    with pytest.raises(ValueError, match="lacks"):
        cli._load_model(str(bad), "rdot_nll_condenser", cpu)


def test_what_the_cli_leaves_raises(hf_checkpoint, encoded, monkeypatch,
                                   capsys):
    """--mesh, --distributed and --cpu-devices 2 raised here until the
    multi-device slices: a 4x2 mesh over the one process of --cpu-devices
    1 raises MeshConfig.resolve's ValueError before any world is made (a
    model axis runs: tests/test_torch_cli_mesh.py), --distributed outside
    torchrun's environment raises for want of
    its RANK, and --cpu-devices 2 without a mesh runs on the CPU, one
    process, as the JAX CLI leaves its extra devices unused (the mesh
    runs: tests/test_torch_cli_mesh.py); without a card and without
    --cpu-devices the commands raise instead of running on the CPU; every
    one of the JAX CLI's subcommands is registered
    (tests/test_torch_cli_surface.py holds their flags)."""
    import torch.distributed as dist

    _, rec, npy, _ = encoded
    base = ["encode", "--checkpoint", hf_checkpoint, "--records",
            rec + "/passages", "--out", npy + ".x"]
    with pytest.raises(ValueError, match="mesh 4x2 != 1 devices"):
        cli.main(base + ["--mesh", "4x2", "--cpu-devices", "1"])
    assert not dist.is_initialized()
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="RANK"):
        cli.main(base + ["--distributed", "--cpu-devices", "1"])
    assert not dist.is_initialized()
    cli.main(base + ["--cpu-devices", "2"])
    assert np.load(npy + ".x").shape == np.load(npy).shape
    capsys.readouterr()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(base)
    for name in ("eval-beir", "warmup", "coco", "presets"):
        with pytest.raises(SystemExit) as ei:
            cli.main([name, "--help"])
        assert ei.value.code == 0
    assert "usage: cocodr_tpu_torch " + name in capsys.readouterr().out


def test_profile_and_log_dirs(encoded, hf_checkpoint, tmp_path, capsys):
    """--profile-dir writes a torch.profiler trace of the command;
    --log-dir a metrics.jsonl line of the encode."""
    _, rec, _, _ = encoded
    cli.main(["encode", "--checkpoint", hf_checkpoint, "--records",
              rec + "/passages", "--out", str(tmp_path / "e.npy"),
              "--batch-size", "4", "--profile-dir", str(tmp_path / "prof"),
              "--log-dir", str(tmp_path / "log")] + CPU)
    assert list((tmp_path / "prof").glob("trace-*.json"))
    rec_line = json.loads((tmp_path / "log" / "metrics.jsonl").read_text())
    assert rec_line["step"] == 0 and rec_line["encode/records"] == 8
