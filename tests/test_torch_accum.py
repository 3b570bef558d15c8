"""Gradient accumulation in the port (optim/multi_steps.py::MultiSteps, built
by OptimizerConfig(grad_accum_steps=k)) against optax.MultiSteps over the
JAX train steps, on the same tiny models and batches, float32 on the CPU,
dropout off where the packages are compared (their random bits cannot
match). Tolerance 1e-5 in losses, h_fun and parameters (sums in another
order). Also: the parameters and the inner optimizer's state do not move
on the micro-batches that do not emit; a run_warmup checkpoint taken
inside a window resumes bit for bit (dropout on); load_jax_train_state
reads an optax.MultiStepsState."""
import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.core import configs as jax_configs
from cocodr_tpu.losses import DroConfig as JaxDroConfig
from cocodr_tpu.losses import dro_greedy_init as jax_dro_init
from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.condenser import CoCondenserForPretraining as JaxCoco
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu.pipelines import coco as jax_coco
from cocodr_tpu.pipelines.train_step import TrainStepConfig as JaxStepConfig
from cocodr_tpu.pipelines.train_step import build_train_step as jax_step
from cocodr_tpu.utils.train_state import TrainState as JaxTrainState
from cocodr_tpu_torch.core import configs
from cocodr_tpu_torch.losses.dro import DroConfig, dro_greedy_init
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig
from cocodr_tpu_torch.models.condenser import CoCondenserForPretraining
from cocodr_tpu_torch.models.dual_encoder import (
    MODEL_REGISTRY,
    DualEncoder,
    build_dual_encoder,
)
from cocodr_tpu_torch.optim import MultiSteps
from cocodr_tpu_torch.pipelines import coco
from cocodr_tpu_torch.pipelines import train_step as ts
from cocodr_tpu_torch.pipelines import warmup
from cocodr_tpu_torch.utils import train_state as tstate

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
G, B, SQ, SD, VOCAB, HEAD_DIM = 4, 8, 6, 12, 128, 16


def opt_kw(name, k):
    return dict(name=name, lr=1e-3, warmup_steps=2, total_steps=10,
                weight_decay=0.01 if name == "adamw" else 0.0,
                grad_accum_steps=k)


def batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = {}
        for key, S in (("q", SQ), ("pos", SD), ("neg", SD)):
            ids = rng.randint(1, VOCAB, size=(B, S)).astype(np.int32)
            lens = rng.randint(S // 2, S + 1, size=B)
            mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
            b[f"{key}_ids"], b[f"{key}_mask"] = ids * mask, mask
        b["groups"] = rng.randint(0, G, size=B).astype(np.int32)
        b["weights"] = rng.uniform(0.5, 1.5, size=B).astype(np.float32)
        out.append(b)
    return out


def setup(name, k, kind):
    """(JAX state, JAX step, port state, port step, port model config),
    both optimizers built by their package's OptimizerConfig."""
    jmodel = jax_build("rdot_nll", JaxBertConfig.tiny(), head_dim=HEAD_DIM)
    ones = jnp.ones((2, SD), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(0), ones, ones)["params"]
    tx = jax_configs.OptimizerConfig(**opt_kw(name, k)).build()
    dro = kind != "nll"
    jstate = JaxTrainState.create(
        params, tx, extra=jax_dro_init(JaxDroConfig(n_groups=G)) if dro
        else None)
    jstep = jax_step(jmodel, tx, JaxStepConfig(
        loss_kind=kind, dro=JaxDroConfig(n_groups=G) if dro else None))
    cfg = MODEL_REGISTRY["rdot_nll"](BertConfig.tiny(), head_dim=HEAD_DIM)
    model = DualEncoder(cfg)
    model.load_state_dict(convert.params_from_jax(jax.device_get(params),
                                                  cfg))
    state = tstate.TrainState(
        model, configs.OptimizerConfig(**opt_kw(name, k)).build(
            model.parameters()),
        extra=dro_greedy_init(DroConfig(n_groups=G), "cpu") if dro else None)
    step = ts.build_train_step(ts.TrainStepConfig(
        loss_kind=kind, dro=DroConfig(n_groups=G) if dro else None))
    return jstate, jstep, state, step, cfg


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def assert_params_match(jax_params, model, cfg):
    want = convert.params_from_jax(jax.device_get(jax_params), cfg)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)


def snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {id(p): {k: v.clone() for k, v in s.items()}
             for p, s in state.optimizer.state.items()},
            [g["count"] for g in state.optimizer.param_groups])


@pytest.mark.parametrize("kind", ["nll", "dro-greedy"])
@pytest.mark.parametrize("name", ["lamb", "adamw"])
@pytest.mark.parametrize("k", [2, 3])
def test_two_windows_match_optax_multisteps(k, name, kind):
    """2k micro-batches, clipped at norm 1 each: every micro-batch's loss
    (and DRO's h_fun, replaced on every micro-batch) against the JAX
    step's; on the k - 1 micro-batches of a window that do not emit, every
    parameter, every moment and the schedule count stay bit-equal; after
    each window the parameters equal the JAX ones, the schedule count is
    the window count and state.step counts micro-batches."""
    jstate, jstep, state, step, cfg = setup(name, k, kind)
    assert isinstance(state.optimizer, MultiSteps)
    for i, b in enumerate(batches(2 * k)):
        before = snapshot(state)
        jstate, jm = jstep(jstate, to_jax(b))
        m = step(state, to_torch(b))
        loss = m["loss"] if isinstance(m, dict) else m[0]
        np.testing.assert_allclose(loss.item(), float(jm["loss"]), **TOL)
        if kind != "nll":
            np.testing.assert_allclose(state.extra.h_fun.numpy(),
                                       np.asarray(jstate.extra.h_fun), **TOL)
        assert state.step == int(jstate.step) == i + 1
        assert state.optimizer.mini_step == int(jstate.opt_state.mini_step)
        after = snapshot(state)
        if (i + 1) % k:
            for name_, v in before[0].items():
                assert torch.equal(v, after[0][name_]), name_
            assert before[1] == {} or all(
                torch.equal(v, after[1][pid][key])
                for pid, s in before[1].items() for key, v in s.items())
            assert after[2] == before[2]
        else:
            assert after[2] == [(i + 1) // k] * len(after[2])
            assert_params_match(jstate.params, state.model, cfg)
    assert state.optimizer.gradient_step == 2


def test_coco_direct_step_accumulates_as_optax_multisteps():
    """The COCO direct step takes accumulation through its OptimizerConfig
    alone: 4 micro-batches at k = 2 with AdamW against the JAX
    build_coco_train_step over optax.MultiSteps, dropout off; losses and
    the final parameters, 1e-5."""
    jcfg = JaxBertConfig.tiny(hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    jmodel = JaxCoco(jcfg, n_head_layers=1, skip_from=1, late_mlm=True)
    rng = np.random.RandomState(0)
    data = []
    for _ in range(4):
        ids = rng.randint(5, 100, size=(8, 12)).astype(np.int32)
        labels = np.where(rng.rand(8, 12) < 0.3, ids, -100).astype(np.int32)
        data.append({"input_ids": ids, "attention_mask": np.ones_like(ids),
                     "labels": labels})
    params = jmodel.init(jax.random.PRNGKey(0), data[0]["input_ids"][:2],
                         data[0]["attention_mask"][:2],
                         data[0]["labels"][:2])["params"]
    tx = jax_configs.OptimizerConfig(**opt_kw("adamw", 2)).build()
    jstep = jax_coco.build_coco_train_step(
        jmodel, tx, jax_coco.CocoConfig(batch_size=8))
    jstate = JaxTrainState.create(params, tx)
    model = CoCondenserForPretraining(BertConfig.tiny(), 1, 1, True)
    model.load_state_dict(convert.condenser_state_dict_from_jax(
        jax.device_get(params), model.cfg, 1))
    state = tstate.TrainState(model, configs.OptimizerConfig(
        **opt_kw("adamw", 2)).build(model.parameters()))
    step = coco.build_coco_train_step(coco.CocoConfig())
    for i, b in enumerate(data):
        jstate, jm = jstep(jstate, to_jax(b), jax.random.PRNGKey(i))
        m = step(state, to_torch(b))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   **TOL)
    want = convert.condenser_state_dict_from_jax(
        jax.device_get(jstate.params), model.cfg, 1)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)


class WordHashTokenizer:
    """[CLS]=1, words hashed into 5..127, [SEP]=2, padding 0."""

    def __call__(self, texts, padding="max_length", truncation=True,
                 max_length=16, return_tensors="np"):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros_like(ids)
        for i, text in enumerate(texts):
            words = [5 + zlib.crc32(w.encode()) % 123 for w in text.split()]
            toks = [1] + words[:max_length - 2] + [2]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def write_triples(path, n):
    rng = np.random.RandomState(0)
    words = [f"w{i}" for i in range(300)]
    with open(path, "w", encoding="utf8") as f:
        for _ in range(n):
            f.write("\t".join(" ".join(rng.choice(words, rng.randint(2, 14)))
                              for _ in range(3)) + "\n")
    return str(path)


def warmup_state(k):
    model = build_dual_encoder("rdot_nll_condenser", BertConfig.tiny(),
                               device="cpu",
                               generator=torch.Generator().manual_seed(5))
    return tstate.TrainState(model, configs.OptimizerConfig(
        **opt_kw("lamb", k)).build(model.parameters()))


@pytest.mark.parametrize("stop", [4, 5])
def test_warmup_resumes_inside_a_window_bit_for_bit(tmp_path, stop):
    """run_warmup at k = 3 with dropout: a run killed at step 4 or 5 (one
    or two micro-batches into its second window, saved there) and resumed
    by a fresh state from that checkpoint to step 9 equals the run that
    went to 9 uninterrupted, parameters, moments, the accumulator and its
    counters bit for bit; the checkpoint holds the accumulator."""
    path = write_triples(tmp_path / "t.tsv", 80)
    tok = WordHashTokenizer()
    step = ts.build_train_step()

    def run(state, ckpt, max_steps, save_steps):
        cfg = warmup.WarmupConfig(max_seq_len=16, batch_size=8, num_epochs=1,
                                  save_steps=save_steps, max_steps=max_steps,
                                  log_every=100, keep_checkpoints=0)
        return warmup.run_warmup(state, step, path, tok, cfg,
                                 str(tmp_path / ckpt), dropout_seed=0)

    full = run(warmup_state(3), "full", 9, 0)
    run(warmup_state(3), "killed", stop, stop)
    ck = tstate.latest_checkpoint(str(tmp_path / "killed"))
    assert ck.endswith(f"checkpoint-{stop}")
    resumed = warmup_state(3)
    tstate.load_checkpoint(ck, resumed)
    assert resumed.optimizer.mini_step == stop - 3
    assert resumed.optimizer.gradient_step == 1
    assert len(resumed.optimizer.acc) == len(list(
        resumed.model.parameters()))
    run(resumed, "killed", 9, 0)
    assert resumed.step == full.step == 9
    assert resumed.optimizer.gradient_step == full.optimizer.gradient_step
    for (name, a), b in zip(full.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    for p, q in zip(full.model.parameters(), resumed.model.parameters()):
        assert torch.equal(full.optimizer.acc[p], resumed.optimizer.acc[q])
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(full.optimizer.state[p][key],
                               resumed.optimizer.state[q][key])


def test_load_jax_train_state_reads_a_multisteps_state():
    """A JAX state three micro-batches into k = 2 (the second window half
    full): the port's MultiSteps takes mini_step, gradient_step, the
    accumulator and the inner LAMB's moments and count; three more
    micro-batches on both sides end equal, 1e-5. A port optimizer without
    accumulation refuses that state."""
    jstate, jstep, _, _, cfg = setup("lamb", 2, "nll")
    data = batches(6, seed=1)
    for b in data[:3]:
        jstate, _ = jstep(jstate, to_jax(b))
    model = DualEncoder(cfg)
    state = tstate.TrainState(model, configs.OptimizerConfig(
        **opt_kw("lamb", 2)).build(model.parameters()))
    convert.load_jax_train_state(state, jax.device_get(jstate), cfg)
    assert state.step == 3
    assert (state.optimizer.mini_step, state.optimizer.gradient_step) == (1, 1)
    assert state.optimizer.param_groups[0]["count"] == 1
    want = convert.params_from_jax(
        jax.device_get(jstate.opt_state.acc_grads), cfg)
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(state.optimizer.acc[p].numpy(),
                                      want[name].numpy())
    plain = DualEncoder(cfg)
    with pytest.raises(ValueError, match="grad_accum_steps"):
        convert.load_jax_train_state(tstate.TrainState(
            plain, configs.OptimizerConfig(**opt_kw("lamb", 1)).build(
                plain.parameters())), jax.device_get(jstate), cfg)
    step = ts.build_train_step()
    for b in data[3:]:
        jstate, jm = jstep(jstate, to_jax(b))
        loss, _ = step(state, to_torch(b))
        np.testing.assert_allclose(loss.item(), float(jm["loss"]), **TOL)
    assert_params_match(jstate.params, state.model, cfg)


def test_multisteps_refuses_a_checkpoint_of_another_k():
    model = torch.nn.Linear(2, 2)
    a = configs.OptimizerConfig(**opt_kw("lamb", 2)).build(model.parameters())
    b = configs.OptimizerConfig(**opt_kw("lamb", 3)).build(model.parameters())
    with pytest.raises(ValueError, match="every_k"):
        b.load_state_dict(a.state_dict())
