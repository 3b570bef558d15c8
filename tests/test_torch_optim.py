"""The port's optimizer pieces against the JAX package's, on the same numpy
inputs, float32 on the CPU: the reference LAMB (optim/lamb.py), the five
schedules, optax's global-norm clip, the triplet NLL, the stage configs,
and one JAX train-step comparison without clipping or weights."""
import dataclasses

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.core import configs as jax_configs
from cocodr_tpu.losses import triplet_nll as jax_nll
from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu.optim import lamb as jax_lamb
from cocodr_tpu.optim import schedules as jax_sched
from cocodr_tpu.pipelines.train_step import TrainStepConfig as JaxStepConfig
from cocodr_tpu.pipelines.train_step import build_train_step as jax_step
from cocodr_tpu.utils.train_state import TrainState as JaxTrainState
from cocodr_tpu_torch.core import configs
from cocodr_tpu_torch.losses import triplet_nll
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig
from cocodr_tpu_torch.models.dual_encoder import MODEL_REGISTRY, DualEncoder
from cocodr_tpu_torch.optim import Lamb, schedules
from cocodr_tpu_torch.pipelines.train_step import (
    TrainStepConfig,
    build_train_step,
    clip_by_global_norm_,
)
from cocodr_tpu_torch.utils.train_state import TrainState

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-7)  # float32: norms summed in another order


def lamb_run(tree, grads_seq, lr, port_lr=None, **kw):
    """LAMB updates of a numpy tree in both packages, at rate lr (the
    port's at port_lr when given) -> (jax tree, {name: torch tensor});
    tensors named like the tree's leaves."""
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = jax_lamb(lr, **kw)
    st = tx.init(jparams)
    leaves = {"/".join(str(getattr(k, "key", k)) for k in path): v
              for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in leaves.items()}
    opt = Lamb(list(tparams.values()), port_lr or lr, **kw)
    for grads in grads_seq:
        jg = jax.tree_util.tree_map(jnp.asarray, grads)
        up, st = tx.update(jg, st, jparams)
        jparams = optax.apply_updates(jparams, up)
        flat = {"/".join(str(getattr(k, "key", k)) for k in path): v
                for path, v in jax.tree_util.tree_flatten_with_path(grads)[0]}
        for k, p in tparams.items():
            p.grad = torch.from_numpy(flat[k].copy())
        opt.step()
    return jparams, tparams


def _tree(rng, scale=1.0):
    return {"dense": {"kernel": (scale * rng.randn(6, 5)).astype(np.float32),
                      "bias": (0.1 * rng.randn(5)).astype(np.float32)},
            "ln": {"scale": np.ones(5, np.float32)}}


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("adam", [False, True])
def test_lamb_matches_jax(weight_decay, adam):
    """Four updates of a small tree at a constant rate and on a schedule.
    Tolerance 1e-6 relative: float32, norms summed in another order."""
    rng = np.random.RandomState(0)
    tree = _tree(rng)
    grads = [jax.tree_util.tree_map(
        lambda x: rng.randn(*x.shape).astype(np.float32), tree)
        for _ in range(4)]
    for lr, port_lr in ((1e-2, None),
                        (jax_sched.warmup_linear(1e-2, 2, 4),
                         schedules.warmup_linear(1e-2, 2, 4))):
        want, got = lamb_run(tree, grads, lr, port_lr,
                             weight_decay=weight_decay, adam=adam)
        for k, w in _flat(want).items():
            np.testing.assert_allclose(got[k].detach().numpy(), w, **TOL,
                                       err_msg=k)


def test_lamb_weight_norm_above_10_and_zero_norms():
    """A weight of norm ~60 (the clamp at 10 sets its trust ratio), a zero
    weight and a tensor whose gradient is zero (trust ratio 1 when either
    norm is 0)."""
    rng = np.random.RandomState(1)
    tree = _tree(rng, scale=10.0)
    tree["ln"]["scale"] = np.zeros(5, np.float32)
    grads = []
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda x: rng.randn(*x.shape).astype(np.float32), tree)
        g["dense"]["bias"] = np.zeros(5, np.float32)
        grads.append(g)
    assert np.linalg.norm(tree["dense"]["kernel"]) > 10
    want, got = lamb_run(tree, grads, 1e-2, weight_decay=0.01)
    for k, w in _flat(want).items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, **TOL,
                                   err_msg=k)


def test_lamb_stacked_leaf_equals_per_layer_tensors():
    """The JAX package's [L, ...] leaf under a 'layer' key takes one trust
    ratio per layer slice; the port's L separate tensors give the same
    updates."""
    rng = np.random.RandomState(2)
    L = 3
    w = (rng.randn(L, 4, 6) * np.array([0.1, 1.0, 20.0])[:, None, None]
         ).astype(np.float32)
    gs = [rng.randn(L, 4, 6).astype(np.float32) for _ in range(3)]
    jparams = {"layer": {"w": jnp.asarray(w)}}
    tx = jax_lamb(1e-2)
    st = tx.init(jparams)
    for g in gs:
        up, st = tx.update({"layer": {"w": jnp.asarray(g)}}, st, jparams)
        jparams = optax.apply_updates(jparams, up)
    tparams = [torch.nn.Parameter(torch.from_numpy(w[i].copy()))
               for i in range(L)]
    opt = Lamb(tparams, 1e-2)
    for g in gs:
        for i, p in enumerate(tparams):
            p.grad = torch.from_numpy(g[i].copy())
        opt.step()
    want = np.asarray(jparams["layer"]["w"])
    for i, p in enumerate(tparams):
        np.testing.assert_allclose(p.detach().numpy(), want[i], **TOL)


def test_lamb_state_dict_round_trip():
    """The schedule count and the moments survive state_dict(), so a
    resumed run continues the schedule."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = Lamb([p], schedules.warmup_linear(1.0, 2, 10))
    for _ in range(3):
        p.grad = torch.full((3,), 0.5)
        opt.step()
    q = torch.nn.Parameter(p.detach().clone())
    opt2 = Lamb([q], schedules.warmup_linear(1.0, 2, 10))
    opt2.load_state_dict(opt.state_dict())
    assert opt2.param_groups[0]["count"] == 3
    for o, t in ((opt, p), (opt2, q)):
        t.grad = torch.full((3,), -0.25)
        o.step()
    assert torch.equal(p, q)


SCHEDULES = [
    ("warmup_linear", (2e-4, 3, 10)),
    ("warmup_linear", (2e-4, 0, 10)),  # step 0 gives 0 even without warmup
    ("warmup_cosine", (1e-4, 3, 12)),
    ("warmup_cosine", (1e-4, 2, 12, 1.5)),
    ("episode_rewarmup", (1e-4, 2, 5, 14)),
    ("episode_decay", (1e-4, 2, 12)),
    ("episode_decay", (1e-4, 2, 12, 0.3, 4)),
    ("warmup_constant", (5e-5, 4)),
]


@pytest.mark.parametrize("name,args", SCHEDULES)
def test_schedule_matches_jax(name, args):
    """Steps 0..16 (past the end), float32 on both sides. Tolerance 2e-7
    relative plus 2^-23 of the base rate: numpy's and XLA's float32 cos
    may differ by one ulp (2^-24 of 1)."""
    want = getattr(jax_sched, name)(*args)
    got = getattr(schedules, name)(*args)
    for step in range(0, 17):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=2e-7,
                                   atol=args[0] * 2.0 ** -23,
                                   err_msg=f"step {step}")
    if name == "warmup_linear":
        assert got(0) == 0.0


@pytest.mark.parametrize("max_norm", [50.0, 1.0])
def test_clip_matches_optax(max_norm):
    """Below the norm (50: the gradients stay bit-equal) and above it (1:
    g / norm * max_norm). Tolerance 1e-7 relative."""
    rng = np.random.RandomState(3)
    grads = [rng.randn(7, 3).astype(np.float32),
             rng.randn(5).astype(np.float32)]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = clip_by_global_norm_(params, max_norm)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(want))
                               if max_norm > 5 else
                               float(np.sqrt(sum((g ** 2).sum()
                                                 for g in grads))),
                               rtol=1e-6)
    for p, w, g in zip(params, want, grads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-7,
                                   atol=0)
        if max_norm > 5:
            assert np.array_equal(p.grad.numpy(), g)


def test_triplet_nll_with_weights_matches_jax():
    """Loss, accuracy and logits of bf16 and float32 embeddings, and the
    weighted mean the train step takes. Tolerance 1e-6: float32 dots."""
    rng = np.random.RandomState(4)
    q, a, b = (rng.randn(9, 16).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.5, 1.5, 9).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        jl, ja, jlog = jax_nll(*(jnp.asarray(x, jdt) for x in (q, a, b)))
        tl, ta, tlog = triplet_nll(*(torch.from_numpy(x).to(dt)
                                     for x in (q, a, b)))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float((tl * torch.from_numpy(w)).mean()),
                                   float(jnp.mean(jl * w)), rtol=1e-6)


def test_optimizer_config_builds_lamb_and_names_what_waits():
    """lamb with the linear, cosine and ANCE episode schedules (each equal
    to the JAX OptimizerConfig's schedule, lr_floor and episode_steps
    passed through); adamw and gradient accumulation raise with their
    ROADMAP item, episode-rewarmup without episode_steps with the JAX
    config's complaint."""
    p = [torch.nn.Parameter(torch.zeros(2))]
    for kw in (dict(schedule="linear"), dict(schedule="cosine"),
               dict(schedule="episode-decay", lr_floor=0.3),
               dict(schedule="episode-decay", episode_steps=4),
               dict(schedule="episode-rewarmup", episode_steps=5)):
        cfg = configs.OptimizerConfig(lr=2e-4, warmup_steps=3,
                                      total_steps=14, **kw)
        opt = cfg.build(p)
        assert isinstance(opt, Lamb)
        jax_configs.OptimizerConfig(lr=2e-4, warmup_steps=3,
                                    total_steps=14, **kw).build()
        # the schedule the JAX build makes of the same fields
        fn = {"linear": jax_sched.warmup_linear,
              "cosine": jax_sched.warmup_cosine}.get(kw["schedule"])
        if fn is not None:
            ref = fn(2e-4, 3, 14)
        elif kw["schedule"] == "episode-decay":
            ref = jax_sched.episode_decay(
                2e-4, 3, 14, floor=kw.get("lr_floor", 0.2),
                episode_steps=kw.get("episode_steps", 0))
        else:
            ref = jax_sched.episode_rewarmup(2e-4, 3, 5, 14, floor=0.2)
        for step in range(15):
            np.testing.assert_allclose(opt.schedule(step), float(ref(step)),
                                       rtol=2e-7, atol=2e-4 * 2.0 ** -23)
    for kw, item in ((dict(name="adamw"), "item 13"),
                     (dict(grad_accum_steps=2), "item 13")):
        with pytest.raises(NotImplementedError, match=item):
            configs.OptimizerConfig(**kw).build(p)
    with pytest.raises(ValueError, match="episode_steps"):
        configs.OptimizerConfig(schedule="episode-rewarmup").build(p)


@pytest.mark.parametrize("preset", ["base", "large"])
def test_warmup_stage_presets_match_jax(preset):
    """Every field of WarmupStageConfig and its OptimizerConfig equals the
    JAX preset's; the BERT widths too."""
    got = getattr(configs.WarmupStageConfig, preset)()
    want = getattr(jax_configs.WarmupStageConfig, preset)()
    assert dataclasses.asdict(got.optimizer) == dataclasses.asdict(
        want.optimizer)
    for f in ("model_type", "per_device_batch", "num_epochs", "max_seq_len",
              "save_steps"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("hidden_size", "num_hidden_layers", "num_attention_heads",
              "intermediate_size", "hidden_dropout_prob",
              "attention_probs_dropout_prob"):
        assert getattr(got.bert, f) == getattr(want.bert, f), f


def test_step_without_clipping_or_weights_matches_jax():
    """max_grad_norm 0 leaves the gradients as they are; a batch without
    weights takes the plain mean; warmup_steps 0 (the first update still
    has rate 0). Three steps against the JAX step with the same settings,
    float32, tolerance 1e-5."""
    rng = np.random.RandomState(5)

    def tok(B, S):
        ids = rng.randint(1, 128, size=(B, S)).astype(np.int32)
        lens = rng.randint(S // 2, S + 1, size=B)
        mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
        return ids * mask, mask

    data = []
    for _ in range(3):
        b = {}
        b["q_ids"], b["q_mask"] = tok(6, 8)
        b["pos_ids"], b["pos_mask"] = tok(6, 12)
        b["neg_ids"], b["neg_mask"] = tok(6, 12)
        data.append(b)
    jmodel = jax_build("rdot_nll_condenser", JaxBertConfig.tiny())
    ids = jnp.ones((2, 8), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(2), ids, ids)["params"]
    tx = jax_lamb(jax_sched.warmup_linear(1e-3, 0, 5), eps=1e-6)
    jstate = JaxTrainState.create(params, tx)
    jstep = jax_step(jmodel, tx, JaxStepConfig(max_grad_norm=0.0))
    cfg = MODEL_REGISTRY["rdot_nll_condenser"](BertConfig.tiny())
    model = DualEncoder(cfg)
    model.load_state_dict(convert.params_from_jax(jax.device_get(params),
                                                  cfg))
    state = TrainState(model, Lamb(model.parameters(),
                                   schedules.warmup_linear(1e-3, 0, 5),
                                   eps=1e-6))
    step = build_train_step(TrainStepConfig(max_grad_norm=0.0))
    for b in data:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        loss, _ = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(loss), float(m["loss"]), rtol=1e-5,
                                   atol=1e-5)
    want = convert.params_from_jax(jax.device_get(jstate.params), cfg)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
