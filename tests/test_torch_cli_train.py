"""The port CLI's training subcommands warmup and coco on the CPU.

warmup --no-dropout (3 steps, then a second call that resumes to 5) against
the JAX CLI on the same checkpoint and triples: each step's loss and the
final parameters within 1e-5 (float32, sums in another order). With
dropout, the dev eval (--eval-data-dir, --eval-top1000), --async-checkpoint
and --log-dir, the CLI against run_warmup called in this process with the
same arguments and seed, bit for bit. coco (the JAX CLI's runs are slow
tests) against run_coco_pretrain in this process, bit for bit: a run of 2
steps resumed to 4 through --async-checkpoint, and the grad cache; its
first step, dropout off, against the JAX build_coco_train_step on the same
batch from the same weights (1e-5), which holds the preset's skip_from 6 on
a 2-layer backbone to the JAX package's clamped index."""
import dataclasses
import json
import os

import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

import jax
import jax.numpy as jnp

from cocodr_tpu.cli import main as jax_main
from cocodr_tpu.core import configs as jax_configs
from cocodr_tpu.models.condenser import CoCondenserForPretraining as JaxCoco
from cocodr_tpu.models.condenser import condenser_params_from_torch
from cocodr_tpu.models.hf import config_from_hf as jax_config_from_hf
from cocodr_tpu.pipelines import coco as jax_coco
from cocodr_tpu.utils.train_state import TrainState as JaxTrainState
from cocodr_tpu_torch import cli
from cocodr_tpu_torch.core.configs import CocoStageConfig, WarmupStageConfig
from cocodr_tpu_torch.data.coco_collator import CoCondenserCollator
from cocodr_tpu_torch.data.coco_spans import span_batches
from cocodr_tpu_torch.data.records import TokenCache, load_id_map, load_qrels
from cocodr_tpu_torch.data.tokenizer import load_tokenizer
from cocodr_tpu_torch.evals.mrr_eval import combined_mrr, load_top_dev
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.hf import load_torch_state_dict
from cocodr_tpu_torch.pipelines import coco
from cocodr_tpu_torch.pipelines.train_step import (
    TrainStepConfig,
    build_train_step,
)
from cocodr_tpu_torch.pipelines.warmup import WarmupConfig, run_warmup
from cocodr_tpu_torch.utils.train_state import (
    PAYLOAD,
    TrainState,
    latest_checkpoint,
)
from test_torch_cli_fixtures import (  # noqa: F401
    CPU,
    hf_checkpoint,
    json_lines,
    write_beir,
    write_marco_tsv,
    write_triples,
)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
CPU_DEV = torch.device("cpu")


def _payload(ckpt_dir):
    return torch.load(os.path.join(latest_checkpoint(ckpt_dir), PAYLOAD),
                      map_location="cpu", weights_only=True)


def _warmup(main, ckpt, triples, ckpt_dir, steps, extra=()):
    main(["warmup", "--triples", triples, "--checkpoint", ckpt,
          "--ckpt-dir", str(ckpt_dir), "--batch-size", "4", "--max-steps",
          str(steps), "--max-seq-len", "16", "--log-every", "1",
          "--compile-cache", "", *extra])


def test_warmup_no_dropout_matches_the_jax_cli_and_resumes(hf_checkpoint,
                                                           tmp_path, capsys):
    """3 steps, then a second call resuming from checkpoint-3 to 5: the
    losses of steps 1-5 and the parameters at 5 within 1e-5 of the JAX
    CLI's."""
    triples = write_triples(tmp_path)
    losses = {}
    for main, sub, extra in ((jax_main, "jax", []),
                             (cli.main, "port", CPU)):
        for steps in (3, 5):
            _warmup(main, hf_checkpoint, triples, tmp_path / sub, steps,
                    ["--no-dropout", *extra])
        recs = json_lines(capsys.readouterr().out)
        losses[sub] = [r["loss"] for r in recs if "loss" in r]
        assert [r["step"] for r in recs] == [1, 2, 3, 4, 5]
    np.testing.assert_allclose(losses["port"], losses["jax"], **TOL)
    raw = ocp.PyTreeCheckpointer().restore(os.path.abspath(os.path.join(
        latest_checkpoint(str(tmp_path / "jax")), "state")))
    model = cli._load_model(hf_checkpoint, "rdot_nll_condenser", CPU_DEV)
    want = convert.params_from_jax(raw["params"], model.cfg)
    got = _payload(str(tmp_path / "port"))
    assert got["step"] == 5
    assert got["model"].keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got["model"][k].numpy(), v.numpy(),
                                   **TOL, err_msg=k)


def test_warmup_cli_equals_run_warmup_in_process(hf_checkpoint, tmp_path,
                                                 capsys):
    """With dropout (seed 3), the dev eval every 2 steps with the rerank
    candidates, --async-checkpoint and --log-dir, 4 steps: the CLI's
    losses, eval lines and final parameters equal run_warmup's in this
    process bit for bit; the log dir holds a line a step."""
    d = write_marco_tsv(tmp_path)
    rec = tmp_path / "rec"
    cli.main(["preprocess-msmarco", "--collection", str(d / "collection.tsv"),
              "--dev-queries", str(d / "queries.dev.tsv"),
              "--dev-qrels", str(d / "qrels.dev.tsv"), "--out", str(rec),
              "--tokenizer", hf_checkpoint, "--max-seq-length", "16",
              "--max-query-length", "8"])
    triples = write_triples(tmp_path)
    top = str(d / "top1000.dev.tsv")
    capsys.readouterr()
    _warmup(cli.main, hf_checkpoint, triples, tmp_path / "cli", 4,
            ["--seed", "3", "--eval-data-dir", str(rec), "--eval-top1000",
             top, "--eval-every", "2", "--async-checkpoint", "--log-dir",
             str(tmp_path / "log"), *CPU])
    recs = json_lines(capsys.readouterr().out)

    cfg = WarmupStageConfig.base()
    model = cli._load_model(hf_checkpoint, cfg.model_type, CPU_DEV)
    state = TrainState(model, cfg.optimizer.build(model.parameters()))
    qc, pc = TokenCache(str(rec / "dev-query")), TokenCache(str(rec /
                                                                "passages"))
    qrels = {q: list(v) for q, v in load_qrels(str(rec / "dev-qrel.tsv"))
             .items()}
    cands = load_top_dev(top, load_id_map(str(rec / "dev-query.qid2offset"
                                              ".pickle")),
                         load_id_map(str(rec / "passages.pid2offset.pickle")))
    seen = []
    run_warmup(state, build_train_step(TrainStepConfig(loss_kind="nll")),
               triples, load_tokenizer(hf_checkpoint),
               WarmupConfig(max_seq_len=16, batch_size=4,
                            num_epochs=cfg.num_epochs,
                            save_steps=cfg.save_steps, max_steps=4,
                            eval_every_steps=2, log_every=1),
               str(tmp_path / "direct"),
               eval_fn=lambda s: seen.append(
                   {"step": s.step, **combined_mrr(s.model, qc, pc, qrels,
                                                   candidates=cands,
                                                   device="cpu")}),
               log_fn=lambda s, m: seen.append({"step": s, **m}),
               dropout_seed=3)
    assert len(recs) == len(seen) == 6
    for got, want in zip(recs, seen):
        got = {k: v for k, v in got.items() if k != "triplets_per_s"}
        assert got == want
    assert "rerank_MRR @10" in recs[2]
    direct = state.model.state_dict()
    got = _payload(str(tmp_path / "cli"))
    assert got["step"] == 4
    for k, v in direct.items():
        assert torch.equal(got["model"][k], v), k
    logged = json_lines((tmp_path / "log" / "metrics.jsonl").read_text())
    assert [r["step"] for r in logged] == [1, 2, 3, 4]
    assert all("warmup/loss" in r and r["warmup/triplets_per_s"] > 0
               for r in logged)


class Recorder:
    """Wraps a COCO step: its (step, loss) pairs."""

    def __init__(self, step, out):
        self.step, self.out = step, out

    def __call__(self, state, batch, seed=None):
        m = self.step(state, batch, seed)
        self.out.append((state.step, float(m["loss"])))
        return m


@pytest.fixture()
def recorded(monkeypatch):
    """Every COCO step the CLI builds records its losses here."""
    losses = []
    build = coco.build_coco_train_step
    monkeypatch.setattr(coco, "build_coco_train_step",
                        lambda cfg: Recorder(build(cfg), losses))
    return losses


@pytest.fixture()
def spans(hf_checkpoint, tmp_path):
    beir = write_beir(tmp_path, n_docs=40, name="scifact", seed=9)
    cli.main(["preprocess-coco", "--data-dirs", beir, "--out",
              str(tmp_path / "spans"), "--tokenizer", hf_checkpoint])
    return str(tmp_path / "spans")


def _coco(ckpt, spans, ckpt_dir, steps, extra=()):
    cli.main(["coco", "--train-dir", spans, "--checkpoint", ckpt,
              "--ckpt-dir", str(ckpt_dir), "--batch-docs", "4",
              "--max-steps", str(steps), "--max-seq-length", "16",
              "--save-steps", "2", "--seed", "5", *extra, *CPU])


def _coco_direct(ckpt, spans, steps, recorded, chunk=0):
    """run_coco_pretrain in this process: the CLI's model, optimizer,
    collator and stream for a run of `steps` -> (the CLI's losses so far,
    this run's losses, state)."""
    cfg = CocoStageConfig.base()
    model = cli._load_condenser(ckpt, cfg, CPU_DEV, 5)
    opt = dataclasses.replace(cfg.optimizer, total_steps=steps,
                              warmup_steps=cfg.warmup_steps_for(steps))
    state = TrainState(model, opt.build(model.parameters()))
    coll = CoCondenserCollator(load_tokenizer(ckpt), cfg.mlm_probability, 16)
    n = len(recorded)
    step = coco.build_coco_train_step(coco.CocoConfig(cache_chunk_size=chunk))
    coco.run_coco_pretrain(state, step, span_batches(
        [os.path.join(spans, "scifact.spans.jsonl")], coll, 4,
        num_epochs=cfg.num_epochs), 5, max_steps=steps)
    return recorded[:n], recorded[n:], state


def test_coco_cli_resumed_equals_an_uninterrupted_run(hf_checkpoint, spans,
                                                      tmp_path, recorded,
                                                      capsys):
    """2 steps saving at 2, then a call that resumes to 4 with
    --async-checkpoint (and --dropout-rng, which has no effect): the
    losses and parameters of run_coco_pretrain's 4 steps in this process,
    bit for bit; the fresh c_head drawn from --seed."""
    _coco(hf_checkpoint, spans, tmp_path / "ck", 2)
    _coco(hf_checkpoint, spans, tmp_path / "ck", 4,
          ["--async-checkpoint", "--dropout-rng", "threefry2x32"])
    assert "resumed from" in capsys.readouterr().out
    cli_losses, losses, state = _coco_direct(hf_checkpoint, spans, 4,
                                             recorded)
    assert cli_losses == losses and len(losses) == 4
    got = _payload(str(tmp_path / "ck"))
    assert got["step"] == 4
    for k, v in state.model.state_dict().items():
        assert torch.equal(got["model"][k], v), k


def test_coco_cli_grad_cache_equals_run_coco_pretrain(hf_checkpoint, spans,
                                                      tmp_path, recorded):
    _coco(hf_checkpoint, spans, tmp_path / "ck", 2,
          ["--cache-chunk-size", "4"])
    cli_losses, losses, state = _coco_direct(hf_checkpoint, spans, 2,
                                             recorded, chunk=4)
    assert cli_losses == losses and len(losses) == 2
    got = _payload(str(tmp_path / "ck"))
    for k, v in state.model.state_dict().items():
        assert torch.equal(got["model"][k], v), k


def test_coco_cli_first_step_matches_the_jax_step(hf_checkpoint, spans,
                                                  tmp_path):
    """A Condenser checkpoint with its c_head (the CLI's own export of a
    2-step run), loaded by the CLI's loader with coco-base's skip_from 6 on
    the 2-layer backbone, and the JAX CLI's params of it: one step, dropout
    off, on the CLI's first batch: loss, mlm_loss, co_loss and every
    parameter within 1e-5 of the JAX step's."""
    _coco(hf_checkpoint, spans, tmp_path / "ck", 2)
    export = str(tmp_path / "export")
    cli.main(["export-hf", "--from-orbax", "--checkpoint",
              str(tmp_path / "ck"), "--config", hf_checkpoint, "--out",
              export])
    cfg = CocoStageConfig.base()
    model = cli._load_condenser(export, cfg, CPU_DEV, 0)
    assert model.skip_from == 6 and model.cfg.num_hidden_layers == 2
    opt = dataclasses.replace(cfg.optimizer, total_steps=10,
                              warmup_steps=cfg.warmup_steps_for(10))
    state = TrainState(model, opt.build(model.parameters()))
    coll = CoCondenserCollator(load_tokenizer(hf_checkpoint),
                               cfg.mlm_probability, 16)
    batch = next(span_batches([os.path.join(spans, "scifact.spans.jsonl")],
                              coll, 4))
    m = coco.build_coco_train_step(coco.CocoConfig())(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})

    with open(os.path.join(export, "config.json")) as f:
        jcfg = dataclasses.replace(jax_config_from_hf(json.load(f)),
                                   hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0)
    jmodel = JaxCoco(jcfg, n_head_layers=cfg.n_head_layers,
                     skip_from=cfg.skip_from, late_mlm=cfg.late_mlm,
                     mlm_budget_frac=cfg.mlm_budget_frac)
    params = condenser_params_from_torch(
        load_torch_state_dict(os.path.join(export, "pytorch_model.bin")),
        jcfg, cfg.n_head_layers,
        head_state_dict=load_torch_state_dict(os.path.join(export,
                                                           "model.pt")))
    tx = jax_configs.OptimizerConfig(**dataclasses.asdict(opt)).build()
    jstep = jax_coco.build_coco_train_step(
        jmodel, tx, jax_coco.CocoConfig(batch_size=8, max_seq_length=16))
    jstate, jm = jstep(JaxTrainState.create(params, tx),
                       {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(0))
    for k in ("loss", "mlm_loss", "co_loss"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), **TOL,
                                   err_msg=k)
    want = convert.condenser_state_dict_from_jax(
        jax.device_get(jstate.params), model.cfg, cfg.n_head_layers)
    for k, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), **TOL,
                                   err_msg=k)
