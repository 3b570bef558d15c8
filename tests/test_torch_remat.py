"""Remat in the port (models/bert.py: BertConfig.remat, remat_policy,
`checkpointed`): for every policy the loss and every gradient equal the
run without remat bit for bit on the CPU in float32 with dropout on, the
masks of the forward and of the recompute equal those without remat, and
the caller's generators end where they end without remat. The JAX
package's remat=True model is the oracle of the loss and the gradients
(dropout off, where random bits cannot match; 1e-5, sums in another
order). Also: an unknown policy raises; the Condenser with its hidden
states, the COCO direct and grad-cache steps, the DPR two-tower model and
the iDRO step (whose group-pass layers run without remat) under remat;
what each policy recomputes, counted by the products the backward runs."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu_torch.losses.dro import DroConfig, idro_init
from cocodr_tpu_torch.models import bert as tbert
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import REMAT_POLICIES, BertConfig
from cocodr_tpu_torch.models.condenser import build_condenser
from cocodr_tpu_torch.models.dual_encoder import (
    MODEL_REGISTRY,
    DualEncoder,
    build_dual_encoder,
)
from cocodr_tpu_torch.optim import Lamb
from cocodr_tpu_torch.pipelines import coco
from cocodr_tpu_torch.pipelines import train_step as ts
from cocodr_tpu_torch.utils.train_state import TrainState

torch.set_num_threads(1)

B, SQ, SD, VOCAB = 4, 8, 16, 128
TOL = dict(rtol=1e-5, atol=1e-5)
POLICIES = list(REMAT_POLICIES)


def triplet_batch(seed=0, groups=None):
    rng = np.random.RandomState(seed)
    out = {}
    for k, S in (("q", SQ), ("pos", SD), ("neg", SD)):
        ids = rng.randint(1, VOCAB, size=(B, S))
        lens = rng.randint(S // 2, S + 1, size=B)
        mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int64)
        out[f"{k}_ids"] = torch.from_numpy(ids * mask)
        out[f"{k}_mask"] = torch.from_numpy(mask)
    if groups is not None:
        out["groups"] = torch.from_numpy(rng.randint(0, groups, size=B))
    return out


def dual_encoder(model_type="rdot_nll_condenser", **bert_kw):
    return build_dual_encoder(model_type, BertConfig.tiny(**bert_kw),
                              device="cpu",
                              generator=torch.Generator().manual_seed(1))


def grads_of(model):
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def assert_bit_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


class MaskRecorder:
    """Wraps models.bert.dropout: keeps every keep-mask drawn, in order."""

    def __init__(self, monkeypatch):
        self.masks = []
        real = tbert.dropout

        def recording(x, p, generator):
            out = real(x, p, generator)
            self.masks.append(out != 0)
            return out

        monkeypatch.setattr(tbert, "dropout", recording)


def nll_step(model, batch, seed=3):
    """Loss, gradients and the generators' end states of one nll forward
    and backward with dropout drawn from dropout_generators(seed, 0)."""
    gens = ts.dropout_generators(seed, 0, "cpu")
    loss, _ = ts.nll_loss(model, batch, gens)
    loss.backward()
    return loss.detach(), grads_of(model), [g.get_state() for g in gens]


@pytest.mark.parametrize("policy", POLICIES)
def test_gradients_masks_and_generators_equal_no_remat(policy, monkeypatch):
    """Dropout on: the loss and every gradient bit-equal; the forward's
    masks equal the no-remat masks, and the recompute draws them again
    (the layer-level policies re-draw every layer's masks, no_save the
    attention's); the three generators end in the same states."""
    batch = triplet_batch()
    rec = MaskRecorder(monkeypatch)
    want = nll_step(dual_encoder(), batch)
    plain_masks, rec.masks = rec.masks, []
    got = nll_step(dual_encoder(remat=True, remat_policy=policy), batch)
    assert torch.equal(got[0], want[0])
    assert_bit_equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)
    n = len(plain_masks)
    assert len(rec.masks) > n
    for a, b in zip(rec.masks[:n], plain_masks):
        assert torch.equal(a, b)
    replayed = rec.masks[n:]
    for m in replayed:
        assert any(m.shape == p.shape and torch.equal(m, p)
                   for p in plain_masks)


@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_from_the_callers_generator_changes_the_gradients(
        policy, monkeypatch):
    """The planted fault of chip_smoke.py's recipe phase: a recompute that
    draws from the caller's generator (moved on past the later layers)
    instead of the saved state gives other gradients, and the compare
    catches it."""
    batch = triplet_batch()
    want = nll_step(dual_encoder(), batch)
    monkeypatch.setattr(tbert, "recompute_generator", lambda g, state: g)
    got = nll_step(dual_encoder(remat=True, remat_policy=policy), batch)
    assert torch.equal(got[0], want[0])  # the forward is untouched
    assert any(not torch.equal(got[1][k], want[1][k]) for k in want[1])


def test_unknown_policy_raises():
    """As the JAX package raises for a name it does not know; remat off
    leaves the policy unread, as there."""
    with pytest.raises(ValueError, match="unknown remat_policy"):
        BertConfig.tiny(remat=True, remat_policy="checkpoint_dots")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        BertConfig.tiny(remat=True, remat_policy="no_save:attn_scores")
    BertConfig.tiny(remat=False, remat_policy="anything")


def jax_loss_and_grads(jmodel, params, batch):
    from cocodr_tpu.losses.nll import triplet_nll

    def loss_fn(p):
        q = jmodel.apply({"params": p}, batch["q_ids"], batch["q_mask"],
                         method=jmodel.query_emb)
        a = jmodel.apply({"params": p}, batch["pos_ids"], batch["pos_mask"],
                         method=jmodel.body_emb)
        b = jmodel.apply({"params": p}, batch["neg_ids"], batch["neg_mask"],
                         method=jmodel.body_emb)
        losses, _, _ = triplet_nll(q, a, b)
        return jnp.mean(losses)

    return jax.value_and_grad(loss_fn)(params)


@pytest.mark.parametrize("policy", POLICIES)
def test_loss_and_gradients_match_the_jax_remat_model(policy):
    """The JAX dual encoder built with remat=True and the same policy is
    the oracle: the loss and every gradient, dropout off, 1e-5."""
    jcfg = JaxBertConfig.tiny(remat=True, remat_policy=policy)
    jmodel = jax_build("rdot_nll_condenser", jcfg)
    ones = jnp.ones((2, SD), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(0), ones, ones)["params"]
    batch = triplet_batch(seed=1)
    jloss, jgrads = jax_loss_and_grads(
        jmodel, params, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    cfg = MODEL_REGISTRY["rdot_nll_condenser"](
        BertConfig.tiny(remat=True, remat_policy=policy))
    model = DualEncoder(cfg)
    model.load_state_dict(convert.params_from_jax(jax.device_get(params),
                                                  cfg))
    loss, _ = ts.nll_loss(model, batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    want = convert.params_from_jax(jax.device_get(jgrads), cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)


class OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def backward_products(policy):
    """{op name: calls} of the matrix products the backward runs (the
    recompute's included), at remat off (policy None) or on."""
    kw = {} if policy is None else dict(remat=True, remat_policy=policy)
    model = dual_encoder(**kw)
    gens = ts.dropout_generators(3, 0, "cpu")
    loss, _ = ts.nll_loss(model, triplet_batch(), gens)
    with OpCounter() as c:
        loss.backward()
    ops = torch.ops.aten
    return {name: c.counts.get(getattr(ops, name).default, 0)
            for name in ("mm", "addmm", "bmm")}


def test_what_each_policy_recomputes():
    """Counted in the backward: '' runs every layer's forward products
    again (each tower's 2 layers: 4 addmm projections and 2 bmm einsums a
    layer, the FFN's 2 products as mm in its plain version); dots_saveable
    none of them; no_save the two attention einsums of each layer."""
    plain = backward_products(None)
    towers_layers = 3 * 2
    full = backward_products("")
    assert full["addmm"] - plain["addmm"] == 4 * towers_layers
    assert full["bmm"] - plain["bmm"] == 2 * towers_layers
    assert full["mm"] - plain["mm"] == 2 * towers_layers
    assert backward_products("dots_saveable") == plain
    no_save = backward_products("no_save:attn_scores,attn_probs")
    assert no_save["bmm"] - plain["bmm"] == 2 * towers_layers
    assert (no_save["mm"], no_save["addmm"]) == (plain["mm"], plain["addmm"])


@pytest.mark.parametrize("policy", POLICIES)
def test_condenser_hidden_states_and_coco_steps_under_remat(policy):
    """The Condenser reads hidden_states[skip_from]: under remat every
    layer's output is returned as without it; the direct step and the
    grad cache (4 spans a chunk, generators replayed per chunk) give
    bit-equal losses and gradients with dropout on, and pass 2's CLS
    equals pass 1's."""
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(5, 100, size=(8, 12)))
    mask = torch.ones_like(ids)
    labels = torch.where(torch.from_numpy(rng.rand(8, 12) < 0.3), ids,
                         torch.full_like(ids, -100))
    batch = {"input_ids": ids, "attention_mask": mask, "labels": labels}

    def model(**kw):
        return build_condenser(BertConfig.tiny(**kw), "cpu",
                               torch.Generator().manual_seed(3),
                               n_head_layers=1, skip_from=1, late_mlm=True)

    remat = dict(remat=True, remat_policy=policy)
    plain, re = model().train(), model(**remat).train()
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    with torch.enable_grad():
        a = plain.encode(ids, mask, g1)
        b = re.encode(ids, mask, g2)
    assert len(a[1]) == len(b[1]) == 3
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)
    for chunk in (0, 4):
        out = []
        for m in (model(), model(**remat)):
            state = TrainState(m, NoUpdate(m.parameters()))
            step = coco.build_coco_train_step(coco.CocoConfig(
                cache_chunk_size=chunk, max_grad_norm=0))
            metrics = step(state, batch, 7)
            out.append((metrics, grads_of(m)))
        for k in ("loss", "mlm_loss", "co_loss"):
            assert torch.equal(out[0][0][k], out[1][0][k]), (chunk, k)
        assert_bit_equal(out[0][1], out[1][1])


class NoUpdate(torch.optim.Optimizer):
    """Leaves the parameters and their .grad as the step made them."""

    def __init__(self, params):
        super().__init__(params, {})

    def step(self, closure=None):
        pass


@pytest.mark.parametrize("policy", POLICIES)
def test_dpr_two_tower_under_remat(policy):
    """Both towers and poolers of the DPR model: bit-equal loss and
    gradients with dropout on."""
    out = []
    for kw in ({}, dict(remat=True, remat_policy=policy)):
        out.append(nll_step(dual_encoder("dpr", **kw), triplet_batch()))
    assert torch.equal(out[0][0], out[1][0])
    assert_bit_equal(out[0][1], out[1][1])


class LayerCounter:
    def __init__(self, monkeypatch):
        self.calls = 0
        real = tbert.BertLayer.forward

        def counting(layer, *a, **k):
            self.calls += 1
            return real(layer, *a, **k)

        monkeypatch.setattr(tbert.BertLayer, "forward", counting)


@pytest.mark.parametrize("policy", ["", "dots_saveable"])
def test_idro_group_pass_layers_run_without_remat(policy, monkeypatch):
    """Three iDRO steps (G 4, K 1 of 2 layers, dropout on) equal the
    steps without remat bit for bit (loss, h_fun, parameters); the group
    pass's products run through the last layer's stored activations: a
    step runs 3 towers x 2 layers forward and recomputes only the first
    layer of each tower in the final backward, 9 layer forwards, where
    products through a remat'd last layer would add 3 for each group
    present. The encoders' no_remat_last is 0 again after the step."""
    cfg = ts.TrainStepConfig(loss_kind="idro", dro=DroConfig(n_groups=4),
                             idro_last_k_layers=1)
    runs = []
    counter = LayerCounter(monkeypatch)
    for kw in ({}, dict(remat=True, remat_policy=policy)):
        model = dual_encoder(**kw)
        state = TrainState(model, Lamb(model.parameters(), lambda c: 1e-3),
                           extra=idro_init(cfg.dro, device="cpu"))
        step = ts.build_train_step(cfg)
        losses, calls = [], []
        for i in range(3):
            before = counter.calls
            m = step(state, triplet_batch(seed=i, groups=4),
                     ts.dropout_generators(3, i, "cpu"))
            calls.append(counter.calls - before)
            losses.append(m["loss"])
        runs.append((losses, state, calls))
        assert model.encoder.encoder.no_remat_last == 0
    (la, sa, ca), (lb, sb, cb) = runs
    for x, y in zip(la, lb):
        assert torch.equal(x, y)
    assert torch.equal(sa.extra.h_fun, sb.extra.h_fun)
    assert_bit_equal(dict(sa.model.named_parameters()),
                     dict(sb.model.named_parameters()))
    assert ca == [6, 6, 6]
    assert cb == [9, 9, 9]


def test_remat_keeps_the_bf16_forward():
    """A bf16 compute dtype under remat: the same loss and gradients as
    without it (the recompute rounds as the forward did)."""
    out = []
    for kw in ({}, dict(remat=True)):
        out.append(nll_step(dual_encoder(dtype=torch.bfloat16, **kw),
                            triplet_batch()))
    assert torch.equal(out[0][0], out[1][0])
    assert_bit_equal(out[0][1], out[1][1])


def test_remat_off_without_gradients():
    """Under torch.no_grad (an encode, the grad cache's pass 1) the layers
    run plainly: no recompute, the same embeddings."""
    batch = triplet_batch()
    a, b = dual_encoder().eval(), dual_encoder(remat=True).eval()
    with torch.no_grad():
        ea = a.body_emb(batch["pos_ids"], batch["pos_mask"])
        eb = b.body_emb(batch["pos_ids"], batch["pos_mask"])
    assert torch.equal(ea, eb)
    assert dataclasses.replace(b.cfg.bert, remat=False) == a.cfg.bert
