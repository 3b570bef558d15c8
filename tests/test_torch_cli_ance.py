"""The port CLI's ANCE subcommands on the CPU: ance, ance-mine and
ance-train. The JAX CLI's runs of them are slow tests, so the CLI is held
against the port's in-process pipeline, bit for bit (ance_round is held
against the JAX package by tests/test_torch_ance.py and test_torch_mine.py),
and the JAX CLI tests' non-mesh cases run through the port: the miner
knobs, ivf mining, the async two-job pair as two processes, the quick
iDRO round and the DRO rounds with their flags."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cocodr_tpu_torch import cli
from cocodr_tpu_torch.core.configs import AnceStageConfig
from cocodr_tpu_torch.data.records import TokenCache, load_qrels
from cocodr_tpu_torch.data.streams import TripletBatcher
from cocodr_tpu_torch.losses.dro import dro_greedy_init
from cocodr_tpu_torch.pipelines import ance
from cocodr_tpu_torch.pipelines.train_step import (
    TrainStepConfig,
    build_train_step,
)
from cocodr_tpu_torch.utils.train_state import (
    PAYLOAD,
    TrainState,
    latest_checkpoint,
)
from test_torch_cli_fixtures import (  # noqa: F401
    CPU,
    hf_checkpoint,
    json_lines,
    write_marco,
)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
CPU_DEV = torch.device("cpu")


def _ance(ckpt, data, ckpt_dir, rounds, extra=()):
    cli.main(["ance", "--data-dir", str(data), "--checkpoint", ckpt,
              "--ckpt-dir", str(ckpt_dir), "--rounds", str(rounds),
              "--steps-per-round", "2", "--batch-size", "8",
              "--compile-cache", "", *extra, *CPU])


def _rounds(out):
    return [r for r in json_lines(out) if "round" in r]


def _payload(ckpt_dir):
    return torch.load(os.path.join(latest_checkpoint(str(ckpt_dir)),
                                   PAYLOAD), map_location="cpu",
                      weights_only=True)


def test_ance_cli_equals_ance_round_in_process_and_resumes(hf_checkpoint,
                                                           tmp_path, capsys):
    """dro-greedy with --weight-ema, --n-groups 4, --dro-alpha and
    --rewarmup: one CLI call of 1 round, then a call that resumes at round
    1 (the newest checkpoint and ann file) -> two ance_rounds in this
    process from the same config: each round's ann file byte for byte, its
    dev metrics, and the final parameters, optimizer count and h_fun bit
    for bit."""
    data = write_marco(tmp_path)
    flags = ["--loss-kind", "dro-greedy", "--weight-ema", "--n-groups", "4",
             "--dro-alpha", "0.3", "--rewarmup", "--seed", "2"]
    _ance(hf_checkpoint, data, tmp_path / "ck", 1, flags)
    _ance(hf_checkpoint, data, tmp_path / "ck", 2, flags)
    out = capsys.readouterr().out
    recs = _rounds(out)
    assert [r["round"] for r in recs] == [0, 1]
    assert json_lines(out)[1] == {
        "resumed": str(tmp_path / "ck" / "checkpoint-2"), "step": 2}

    base = AnceStageConfig.base()
    dro = dataclasses.replace(base.dro, n_groups=4, weight_ema=True,
                              alpha=0.3)
    opt = dataclasses.replace(base.optimizer, schedule="episode-rewarmup",
                              episode_steps=2)
    model = cli._load_model(hf_checkpoint, base.model_type, CPU_DEV)
    state = TrainState(model, opt.build(model.parameters()),
                       extra=dro_greedy_init(dro, device="cpu"))
    step = build_train_step(TrainStepConfig(loss_kind="dro-greedy", dro=dro))
    caches = {n: TokenCache(str(data / n))
              for n in ("passages", "train-query", "dev-query")}
    qrels = load_qrels(str(data / "train-qrel.tsv"))
    positives = {q: max(d, key=d.get) for q, d in qrels.items()}
    mine_cfg = ance.MineConfig(topk_training=base.topk_training,
                               negative_sample=base.negative_sample,
                               cluster_query=True, cluster_centroids=4,
                               batch_size=base.eval_batch)
    work = str(tmp_path / "direct")
    for rnd in range(2):
        state, metrics, steps = ance.ance_round(
            state, step, TripletBatcher(caches["train-query"],
                                        caches["passages"]),
            caches["passages"], caches["train-query"], positives,
            caches["dev-query"], load_qrels(str(data / "dev-qrel.tsv")),
            work, rnd, mine_cfg, batch_size=8, steps_per_round=2,
            dropout_seed=2, device="cpu")
        got = recs[rnd]
        assert got["steps"] == steps == 2
        for k, v in metrics.items():
            if not k.startswith("time_"):
                assert got[k] == float(v), k
        name = f"ann_training_data_{rnd}"
        assert (tmp_path / "ck" / "ann_data" / name).read_bytes() == \
            (tmp_path / "direct" / name).read_bytes()
    payload = _payload(tmp_path / "ck")
    assert payload["step"] == state.step == 4
    for k, v in state.model.state_dict().items():
        assert torch.equal(payload["model"][k], v), k
    assert torch.equal(payload["extra"]["h_fun"], state.extra.h_fun)
    assert payload["optimizer"]["param_groups"][0]["count"] == 4


def test_ance_miner_knobs(hf_checkpoint, tmp_path, capsys, monkeypatch):
    """tests/test_cli.py's miner knobs through the port: fast search, the
    per-checkpoint embedding cache, ann_chunk_factor's query rotation, the
    float32 sweep, and --int8-encode, which mines with the matmul_int8
    twin while the trained model stays float."""
    mined_with = []
    mine = ance.mine

    def spy(model, params, *a, **k):
        mined_with.append(model.cfg.bert.matmul_int8)
        return mine(model, params, *a, **k)

    monkeypatch.setattr(ance, "mine", spy)
    data = write_marco(tmp_path)
    emb_cache = str(tmp_path / "embcache")
    _ance(hf_checkpoint, data, tmp_path / "ck", 1,
          ["--loss-kind", "nll", "--search-method", "fast",
           "--emb-cache-dir", emb_cache, "--ann-chunk-factor", "2",
           "--exact-fp32", "--int8-encode"])
    capsys.readouterr()
    assert mined_with == [True]
    cached = os.listdir(emb_cache)
    assert any(f.startswith("corpus_") and f.endswith(".npy")
               for f in cached), cached
    ann = tmp_path / "ck" / "ann_data" / "ann_training_data_0"
    qids = {int(line.split("\t")[0]) for line in open(ann)}
    assert qids and qids <= set(range(4)), qids
    assert not _payload(tmp_path / "ck")["model"].keys() - \
        cli._load_model(hf_checkpoint, "rdot_nll_condenser",
                        CPU_DEV).state_dict().keys()


def test_ance_ivf_mining(hf_checkpoint, tmp_path, capsys):
    """--search-method ivf at full probe: the round's ann file equals the
    default exact search's byte for byte (tests/test_cli.py asks for an
    ann file and dev metrics)."""
    data = write_marco(tmp_path)
    for sub, extra in (("ivf", ["--search-method", "ivf", "--ivf-nprobe",
                                "64"]), ("exact", [])):
        _ance(hf_checkpoint, data, tmp_path / sub, 1,
              ["--loss-kind", "nll", *extra])
        (rec,) = _rounds(capsys.readouterr().out)
        assert rec["steps"] >= 1 and "ndcg_cut_10" in rec
    name = "ann_data/ann_training_data_0"
    ivf = (tmp_path / "ivf" / name).read_bytes()
    assert ivf.strip() and ivf == (tmp_path / "exact" / name).read_bytes()


def test_ance_idro_quick(hf_checkpoint, tmp_path, capsys):
    """tests/test_cli.py's quick iDRO guard: one 1-step round at batch 4,
    two groups, the default idro-last-k (3) clamped to the 2-layer
    backbone."""
    data = write_marco(tmp_path)
    cli.main(["ance", "--data-dir", str(data), "--checkpoint", hf_checkpoint,
              "--ckpt-dir", str(tmp_path / "ck"), "--rounds", "1",
              "--steps-per-round", "1", "--batch-size", "4", "--n-groups",
              "2", "--loss-kind", "idro", *CPU])
    (rec,) = _rounds(capsys.readouterr().out)
    assert rec["steps"] >= 1


@pytest.mark.parametrize("loss_args", [
    ["--loss-kind", "dro-greedy", "--weight-ema"],
    ["--loss-kind", "idro", "--dro-alpha", "0.3", "--dro-rho", "0.04",
     "--dro-eps", "0.02", "--dro-ema", "0.2"],
], ids=["dro-greedy-ema", "idro"])
def test_ance_round_with_dro(hf_checkpoint, tmp_path, capsys, loss_args,
                             monkeypatch):
    """tests/test_cli.py's DRO rounds: the queries clustered into 4 groups,
    the robust step, the DRO state saved with the checkpoint; the flags
    reach the step's DroConfig."""
    seen = []
    build = cli._ance_step

    def spy(cfg):
        seen.append(cfg)
        return build(cfg)

    monkeypatch.setattr(cli, "_ance_step", spy)
    data = write_marco(tmp_path)
    _ance(hf_checkpoint, data, tmp_path / "ck", 1,
          ["--n-groups", "4", *loss_args])
    (rec,) = _rounds(capsys.readouterr().out)
    assert rec["steps"] >= 1
    h = _payload(tmp_path / "ck")["extra"]["h_fun"].numpy()
    assert h.shape == (4,) and np.isfinite(h).all() and h.sum() > 0
    (cfg,) = seen
    assert cfg.loss_kind == loss_args[1] and cfg.dro.n_groups == 4
    if loss_args[1] == "idro":
        assert (cfg.dro.alpha, cfg.dro.rho, cfg.dro.eps, cfg.dro.ema) == (
            0.3, 0.04, 0.02, 0.2)
    else:
        assert cfg.dro.weight_ema


def test_async_two_job_pair(hf_checkpoint, tmp_path):
    """ance-mine and ance-train as two concurrent processes coupled only
    through the files (the reference's two jobs), two rounds each: the
    first ann file mined from --checkpoint's weights, the second from
    checkpoint-2, the trainer's checkpoint after each file and its
    --result-dir group curves and --log-dir lines."""
    data = write_marco(tmp_path, n_docs=24)
    ck = str(tmp_path / "ck")
    res = tmp_path / "res"
    res.mkdir()
    (res / "ann_ndcg_group_scifact_0").write_text(
        json.dumps({"ndcg": 0.25, "checkpoint": "c"}))
    common = ["--data-dir", str(data), "--checkpoint", hf_checkpoint,
              "--ckpt-dir", ck, "--rounds", "2", "--poll-secs", "1",
              "--batch-size", "8", "--steps-per-round", "2",
              "--loss-kind", "nll", *CPU]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cocodr_tpu_torch.cli", name, *common,
         *extra], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, extra in (("ance-mine", []),
                            ("ance-train", ["--result-dir", str(res),
                                            "--log-dir",
                                            str(tmp_path / "log")]))]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    ann = Path(ck) / "ann_data"
    names = [json.loads((ann / f"ann_ndcg_{n}").read_text())["checkpoint"]
             for n in (0, 1)]
    assert names == ["initial", "checkpoint-2"]
    assert latest_checkpoint(ck).endswith("checkpoint-4")
    logged = json_lines((tmp_path / "log" / "metrics.jsonl").read_text())
    assert any(r.get("ance/ann_ndcg_group_scifact") == 0.25 for r in logged)
    assert any(r.get("ance/ann_file") == 1 for r in logged)
