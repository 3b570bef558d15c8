"""The port's training step against the JAX package's `build_train_step`:
the same tiny dual encoder (models/convert.py), the same batches, dropout
off, float32 on the CPU. A trajectory composes the forward, the triplet NLL
with per-sample weights, the backward (through K1's autograd.Function, the
CPU taking its plain version), optax's global-norm clip, the reference
LAMB and the linear warmup schedule."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu.optim import lamb as jax_lamb
from cocodr_tpu.optim import warmup_linear as jax_warmup_linear
from cocodr_tpu.pipelines.train_step import TrainStepConfig as JaxStepConfig
from cocodr_tpu.pipelines.train_step import build_train_step as jax_step
from cocodr_tpu.utils.train_state import TrainState as JaxTrainState
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig
from cocodr_tpu_torch.models.dual_encoder import MODEL_REGISTRY, DualEncoder
from cocodr_tpu_torch.optim import Lamb, warmup_linear
from cocodr_tpu_torch.pipelines.train_step import (
    TrainStepConfig,
    build_train_step,
)
from cocodr_tpu_torch.utils.train_state import TrainState

torch.set_num_threads(1)

N_STEPS = 10
LR, WARMUP = 1e-3, 3
B, SQ, SD, VOCAB = 8, 10, 14, 128
HEAD_DIM = 16
TOL = dict(rtol=1e-5, atol=1e-5)  # float32, sums in another order


def batches(n=N_STEPS, seed=7):
    """Padded token batches with per-sample weights, from numpy."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        def tok(S):
            ids = rng.randint(1, VOCAB, size=(B, S)).astype(np.int32)
            lens = rng.randint(S // 2, S + 1, size=B)
            mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
            return ids * mask, mask

        b = {}
        b["q_ids"], b["q_mask"] = tok(SQ)
        b["pos_ids"], b["pos_mask"] = tok(SD)
        b["neg_ids"], b["neg_mask"] = tok(SD)
        b["weights"] = rng.uniform(0.5, 1.5, size=B).astype(np.float32)
        out.append(b)
    return out


def jax_setup(model_type, seed=0):
    jcfg = JaxBertConfig.tiny()
    model = jax_build(model_type, jcfg, head_dim=HEAD_DIM)
    ids = jnp.ones((2, SD), jnp.int32)
    params = model.init(jax.random.PRNGKey(seed), ids, ids)["params"]
    tx = jax_lamb(jax_warmup_linear(LR, WARMUP, N_STEPS), eps=1e-6)
    state = JaxTrainState.create(params, tx)
    step = jax_step(model, tx, JaxStepConfig(loss_kind="nll",
                                             max_grad_norm=1.0))
    return state, step


def port_setup(model_type, jax_params):
    cfg = MODEL_REGISTRY[model_type](BertConfig.tiny(), head_dim=HEAD_DIM)
    model = DualEncoder(cfg)
    model.load_state_dict(convert.params_from_jax(jax.device_get(jax_params),
                                                  cfg))
    opt = Lamb(model.parameters(), warmup_linear(LR, WARMUP, N_STEPS),
               eps=1e-6)
    return TrainState(model, opt), cfg


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def assert_params_match(jax_params, model, cfg):
    want = convert.params_from_jax(jax.device_get(jax_params), cfg)
    got = model.state_dict()
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("model_type", ["rdot_nll", "rdot_nll_condenser"])
def test_trajectory_matches_jax_train_step(model_type):
    """10 steps, dropout off: the loss and accuracy sequences and the final
    params (converted from the JAX tree) agree to 1e-5. The first update
    has learning rate 0 (the schedule read at count 0), so the params
    move from step 2 on; they do move."""
    jstate, jstep = jax_setup(model_type)
    state, cfg = port_setup(model_type, jstate.params)
    step = build_train_step(TrainStepConfig(max_grad_norm=1.0))
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    j_losses, losses, j_accs, accs = [], [], [], []
    for b in batches():
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        loss, acc = step(state, to_torch(b))
        j_losses.append(float(m["loss"]))
        j_accs.append(float(m["acc"]))
        losses.append(float(loss))
        accs.append(float(acc))
    np.testing.assert_allclose(losses, j_losses, **TOL)
    assert accs == j_accs
    assert state.step == int(jstate.step) == N_STEPS
    assert_params_match(jstate.params, state.model, cfg)
    moved = max((state.model.state_dict()[k] - v).abs().max().item()
                for k, v in start.items())
    assert moved > 1e-3


@pytest.mark.parametrize("kind,item", [("dro-greedy", "item 9"),
                                       ("idro", "item 9"),
                                       ("nll_multichunk", "item 3")])
def test_other_loss_kinds_name_their_roadmap_item(kind, item):
    """The other loss kinds came with their ROADMAP items and now build:
    nll_multichunk (item 3) builds without a DroConfig and refuses
    single-chunk documents with a ValueError, as the JAX step cannot
    score them (its trajectory is held against the JAX package in
    tests/test_torch_multichunk.py); the DRO kinds (item 9) build given a
    DroConfig (their steps are held in tests/test_torch_ance.py)."""
    if item == "item 3":
        step = build_train_step(TrainStepConfig(loss_kind=kind))
        state, _ = port_setup("rdot_nll", jax_setup("rdot_nll")[0].params)
        with pytest.raises(ValueError, match="multi-chunk"):
            step(state, to_torch(batches(1)[0]))
        return
    from cocodr_tpu_torch.losses.dro import DroConfig

    with pytest.raises(ValueError, match="TrainStepConfig.dro"):
        build_train_step(TrainStepConfig(loss_kind=kind))
    assert callable(build_train_step(TrainStepConfig(
        loss_kind=kind, dro=DroConfig(n_groups=4))))


def test_bf16_step_runs_and_keeps_float32_params():
    """The card's compute dtype on the CPU: parameters stay float32 (no
    cast_matmul_weights in training), the loss is finite and the update
    reaches every tower weight."""
    cfg = MODEL_REGISTRY["rdot_nll_condenser"](
        BertConfig.tiny(dtype=torch.bfloat16))
    model = DualEncoder(cfg)
    state = TrainState(model, Lamb(model.parameters(), lambda c: 1e-3))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss, _ = build_train_step()(state, to_torch(batches(1)[0]))
    assert torch.isfinite(loss)
    for name, p in model.state_dict().items():
        assert p.dtype == torch.float32, name
    changed = [k for k, v in model.state_dict().items()
               if not torch.equal(v, before[k])]
    assert "encoder.encoder.layer.1.output.dense.weight" in changed


def _compare_setup(dtype):
    """A 2-layer model at H = 128 in eval mode with fused attention (the
    card-against-CPU step of chip_smoke.py takes K1 and K8), its batch."""
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder

    bert = BertConfig(vocab_size=1000, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=512,
                      max_position_embeddings=64, dtype=dtype,
                      attention_impl="fused")
    model = build_dual_encoder("rdot_nll_condenser", bert, device="cpu",
                               generator=torch.Generator().manual_seed(3))
    rng = np.random.RandomState(8)
    batch = {}
    for k in ("q", "pos", "neg"):
        ids = rng.randint(5, 1000, size=(4, 32))
        lens = rng.randint(8, 33, size=4)
        mask = (np.arange(32)[None, :] < lens[:, None]).astype(np.int64)
        batch[f"{k}_ids"] = torch.from_numpy(ids * mask)
        batch[f"{k}_mask"] = torch.from_numpy(mask)
    return model, batch


def _clipped_step(model, batch):
    from cocodr_tpu_torch.pipelines.train_step import (
        clip_by_global_norm_,
        nll_loss,
    )

    loss, _ = nll_loss(model, batch)
    loss.backward()
    clip_by_global_norm_(model.parameters(), 1.0)
    return loss.item(), {k: p.grad.clone() for k, p in
                         model.named_parameters()}


@pytest.mark.parametrize("variant", [
    "bf16", "ffn_block_input_ignored", "ffn_block_no_residual",
    "attention_input_ignored", "attention_unnormalised"])
def test_compare_bounds_separate_wrong_backwards(monkeypatch, variant):
    """chip_smoke.py holds one train step on the card (K1, K8, bf16,
    BERT-base) against the same step on the CPU through the plain
    versions by the relative loss difference (<= 5%), the global cosine
    of the clipped gradients (>= 0.98) and the worst tensor's cosine
    (>= 0.8). Here,
    against a float32 step: the same step in bf16 (more rounding than
    card against CPU, both bf16) stays inside all three, while a backward
    that ignores a kernel's input (r of K1, q of K8), or differentiates
    another formulation (no residual in K1, no softmax normalisation in
    K8), falls outside. Measured here: bf16 1.3% loss, global 0.99992,
    worst 0.9996; the wrong backwards give a worst tensor of -0.09 to
    0.32 (an ignored q leaves the global cosine at 0.999998, so the worst
    tensor's bound is the one that catches it)."""
    import chip_smoke
    from cocodr_tpu_torch.ops import attention as tatt
    from cocodr_tpu_torch.ops import ffn as tffn

    ref_model, batch = _compare_setup(torch.float32)
    ref = _clipped_step(ref_model, batch)
    if variant == "bf16":
        model, _ = _compare_setup(torch.bfloat16)
    else:
        model, _ = _compare_setup(torch.float32)
        real_block, real_att = tffn.xla_ffn_block, tatt.xla_attention_seq
        if variant == "ffn_block_input_ignored":
            monkeypatch.setattr(tffn, "xla_ffn_block",
                                lambda r, *a: real_block(r * 0, *a))
        elif variant == "ffn_block_no_residual":
            def no_residual(r, s1, c1, w1, b1, w2, b2, s2, c2, act, eps):
                u = tffn.layer_norm_f32(r.float(), s1, c1, eps).to(r.dtype)
                y = tffn.xla_ffn(u, w1, b1, w2, b2, act)
                return tffn.layer_norm_f32(y.float(), s2, c2, eps)
            monkeypatch.setattr(tffn, "xla_ffn_block", no_residual)
        elif variant == "attention_input_ignored":
            monkeypatch.setattr(tatt, "xla_attention_seq",
                                lambda q, *a: real_att(q * 0, *a))
        else:
            def unnormalised(q, k, v, bias, scale):
                s = torch.einsum("bqnd,bknd->bnqk", q, k) * scale
                s = s + bias[:, None, None, :]
                e = torch.exp(s - s.amax(-1, keepdim=True).detach())
                return torch.einsum("bnqk,bknd->bqnd", e, v)
            monkeypatch.setattr(tatt, "xla_attention_seq", unnormalised)
    got = _clipped_step(model, batch)
    rel, glob, worst, cos = chip_smoke.step_agreement(*got, *ref)
    assert chip_smoke.steps_agree(rel, glob, cos) == (variant == "bf16")
