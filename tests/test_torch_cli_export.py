"""The port CLI's checkpoint subcommands against the JAX CLI on the same
files: export-hf writes the JAX export's pytorch_model.bin (the same keys,
each tensor bit for bit), config.json and model.pt, for rdot_nll_condenser,
rdot_nll, rdot_nll_multi_chunk and DPR, and with --from-orbax for a COCO
checkpoint (the port's own checkpoint of the same parameters the JAX
orbax checkpoint holds); convert-hf prints the JAX CLI's line; an export
reloads into the same model. A checkpoint without a head or poolers gets
them fresh from each package's own generator, so the heads compared come
from a directory the JAX CLI exported first."""
import json
import os

import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cocodr_tpu.cli import main as jax_main
from cocodr_tpu.models.condenser import CoCondenserForPretraining as JaxCoco
from cocodr_tpu.models.hf import config_from_hf as jax_config_from_hf
from cocodr_tpu.utils.train_state import TrainState as JaxTrainState
from cocodr_tpu.utils.train_state import save_checkpoint as jax_save
from cocodr_tpu_torch import cli
from cocodr_tpu_torch.core.configs import CocoStageConfig
from cocodr_tpu_torch.models.condenser import build_condenser
from cocodr_tpu_torch.models.convert import condenser_state_dict_from_jax
from cocodr_tpu_torch.models.hf import config_from_hf
from cocodr_tpu_torch.optim import Lamb
from cocodr_tpu_torch.utils.train_state import (
    TrainState,
    export_hf_bert,
    save_checkpoint,
)
from test_torch_cli_fixtures import hf_checkpoint  # noqa: F401

torch.set_num_threads(1)
MODEL_TYPES = ["rdot_nll_condenser", "rdot_nll", "rdot_nll_multi_chunk",
               "dpr"]


def _sd(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def assert_same_export(a, b):
    """Two export directories: the same files; pytorch_model.bin and
    model.pt key for key, each tensor bit for bit (dtype and shape too);
    config.json equal."""
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        if name.endswith((".bin", ".pt")):
            x, y = _sd(os.path.join(a, name)), _sd(os.path.join(b, name))
            assert sorted(x) == sorted(y), name
            for k in x:
                assert x[k].dtype == y[k].dtype == torch.float32, k
                assert torch.equal(x[k], y[k]), k
        else:
            with open(os.path.join(a, name)) as f, \
                    open(os.path.join(b, name)) as g:
                assert json.load(f) == json.load(g), name


@pytest.fixture(scope="module")
def headed(hf_checkpoint, tmp_path_factory):
    """model type -> a directory the JAX CLI exported from the bare
    backbone (its fresh head or poolers included), with a model.pt beside
    the single-tower ones."""
    root = tmp_path_factory.mktemp("headed")
    out = {}
    for mt in MODEL_TYPES:
        d = str(root / mt)
        jax_main(["export-hf", "--checkpoint", hf_checkpoint, "--out", d,
                  "--model-type", mt])
        if mt != "dpr":
            torch.save({"c_head.0.output.dense.bias": torch.arange(4.0)},
                       os.path.join(d, "model.pt"))
        out[mt] = d
    return out


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_export_hf_equals_the_jax_export(headed, hf_checkpoint, tmp_path,
                                         model_type, capsys):
    """From the bare backbone (rdot_nll_condenser) and from each headed
    directory: the port's export equals the JAX CLI's bit for bit, the
    reference's head names and DPR's towers included, model.pt copied."""
    sources = [headed[model_type]]
    if model_type == "rdot_nll_condenser":
        sources.append(hf_checkpoint)
    for i, src in enumerate(sources):
        outs = []
        for main, sub in ((jax_main, "jax"), (cli.main, "port")):
            outs.append(str(tmp_path / f"{sub}{i}"))
            main(["export-hf", "--checkpoint", src, "--out", outs[-1],
                  "--model-type", model_type])
        lines = capsys.readouterr().out.splitlines()
        assert lines[1] == lines[0].replace(outs[0], outs[1])
        assert_same_export(*outs)
        sd = _sd(os.path.join(outs[1], "pytorch_model.bin"))
        if model_type == "dpr":
            assert any(k.startswith("ctx_model.pooler.") for k in sd)
            assert any(k.startswith("question_model.encoder.") for k in sd)
        else:
            assert "embeddings.word_embeddings.weight" in sd
            assert ("embeddingHead.weight" in sd) == (
                model_type != "rdot_nll_condenser")


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_export_reloads_into_the_same_model(headed, tmp_path, model_type):
    """The port's export of a headed directory loads back into a model
    whose every tensor equals the source's (head, poolers, both towers)."""
    cpu = torch.device("cpu")
    src = cli._load_model(headed[model_type], model_type, cpu, seed=5)
    cli.main(["export-hf", "--checkpoint", headed[model_type], "--out",
              str(tmp_path / "e"), "--model-type", model_type])
    back = cli._load_model(str(tmp_path / "e"), model_type, cpu, seed=6)
    for k, v in src.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_convert_hf_prints_the_jax_clis_line(headed, model_type, capsys):
    for main in (jax_main, cli.main):
        main(["convert-hf", "--hf-dir", headed[model_type], "--model-type",
              model_type])
    jax_line, port_line = capsys.readouterr().out.splitlines()
    assert port_line == jax_line
    assert "M params, 2 layers, hidden 32" in port_line


def _jax_coco_params(cfg, seed):
    model = JaxCoco(cfg, n_head_layers=2, skip_from=1)
    return jax.device_get(model.init(
        jax.random.PRNGKey(seed), jnp.ones((2, 8), jnp.int32),
        jnp.ones((2, 8), jnp.int32), jnp.full((2, 8), -100, jnp.int32),
    )["params"])


def test_export_from_orbax_equals_the_jax_export(hf_checkpoint, tmp_path,
                                                 capsys):
    """The same Condenser parameters as a JAX orbax TrainState and as the
    port's TrainState (two checkpoints in the root; the newest DONE one is
    taken, and a checkpoint-{step} directory given directly): backbone +
    MLM head in pytorch_model.bin and the c_head in model.pt, bit for bit
    with the JAX export, config.json equal."""
    with open(os.path.join(hf_checkpoint, "config.json")) as f:
        hf = json.load(f)
    jcfg, cfg = jax_config_from_hf(hf), config_from_hf(hf)
    stage = CocoStageConfig(n_head_layers=2, skip_from=1)
    model = build_condenser(cfg, "cpu", n_head_layers=2, skip_from=1)
    state = TrainState(model, Lamb(model.parameters(), 1e-3))
    jroot, proot = str(tmp_path / "jax_ck"), str(tmp_path / "port_ck")
    for step, seed in ((1, 3), (2, 4)):
        params = _jax_coco_params(jcfg, seed)
        jstate = JaxTrainState.create(params, optax.adamw(1e-4))
        jax_save(jroot, jstate.replace(step=jnp.asarray(step)))
        model.load_state_dict(condenser_state_dict_from_jax(
            params, cfg, stage.n_head_layers))
        state.step = step
        save_checkpoint(proot, state)
    outs = []
    for main, root, sub in ((jax_main, jroot, "jax"), (cli.main, proot,
                                                        "port")):
        for ck in (root, os.path.join(root, "checkpoint-1")):
            outs.append(str(tmp_path / f"{sub}_{os.path.basename(ck)}"))
            main(["export-hf", "--from-orbax", "--checkpoint", ck,
                  "--config", hf_checkpoint, "--out", outs[-1]])
    lines = capsys.readouterr().out.splitlines()
    assert lines[2].endswith(f"checkpoint-2 to {outs[2]}")
    assert_same_export(outs[0], outs[2])
    assert_same_export(outs[1], outs[3])
    sd = _sd(os.path.join(outs[2], "pytorch_model.bin"))
    head = _sd(os.path.join(outs[2], "model.pt"))
    assert "cls.predictions.transform.dense.weight" in sd
    assert "cls.predictions.bias" in sd
    assert sorted({k.split(".")[1] for k in head}) == ["0", "1"]
    # the newest checkpoint's backbone (step 2, the model's weights now)
    for k, v in model.state_dict().items():
        if k.startswith("bert."):
            assert torch.equal(sd[k[len("bert."):]], v), k
    with pytest.raises(SystemExit, match="--config"):
        cli.main(["export-hf", "--from-orbax", "--checkpoint", proot,
                  "--out", str(tmp_path / "x")])


def test_export_hf_bert_names_roberta_and_skips_empty_heads(tmp_path):
    """export_hf_bert on a RoBERTa-flavoured tower: no `roberta.` prefix
    left, config.json's model_type roberta; no model.pt without
    head_params."""
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder

    bert = BertConfig(vocab_size=50, hidden_size=16, num_hidden_layers=1,
                      num_attention_heads=2, intermediate_size=32,
                      max_position_embeddings=40, position_style="roberta",
                      pad_token_id=1)
    model = build_dual_encoder("rdot_nll", bert, device="cpu")
    export_hf_bert(model.state_dict(), model.cfg, str(tmp_path))
    sd = _sd(tmp_path / "pytorch_model.bin")
    assert not any(k.startswith("roberta.") for k in sd)
    assert torch.equal(sd["embeddingHead.weight"], model.head.dense.weight)
    cfg = json.loads((tmp_path / "config.json").read_text())
    assert cfg["model_type"] == "roberta" and cfg["pad_token_id"] == 1
    assert not (tmp_path / "model.pt").exists()


@pytest.mark.parametrize("model_type", ["rdot_nll_condenser", "rdot_nll"])
def test_export_hf_of_a_training_checkpoint(hf_checkpoint, tmp_path,
                                            model_type, capsys):
    """A warmup (or ANCE) checkpoint of the port, given as its root: the
    export's tensors are the newest checkpoint's model, bit for bit, and
    load back through the CLI's loader; --config is required."""
    model = cli._load_model(hf_checkpoint, model_type, torch.device("cpu"),
                            seed=2)
    state = TrainState(model, Lamb(model.parameters(), 1e-3))
    root = str(tmp_path / "ck")
    save_checkpoint(root, state)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.5)
    state.step = 7
    save_checkpoint(root, state)
    with pytest.raises(SystemExit, match="--config"):
        cli.main(["export-hf", "--checkpoint", root, "--out",
                  str(tmp_path / "x"), "--model-type", model_type])
    out = str(tmp_path / "export")
    cli.main(["export-hf", "--checkpoint", root, "--config", hf_checkpoint,
              "--out", out, "--model-type", model_type])
    assert capsys.readouterr().out.strip() == (
        f"exported HF checkpoint {root}/checkpoint-7 to {out}")
    back = cli._load_model(out, model_type, torch.device("cpu"), seed=3)
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
