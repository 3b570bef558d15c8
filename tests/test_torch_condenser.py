"""The port's COCO model (models/condenser.py, the hidden states, MLM
transform and tied decoder of models/bert.py, losses/contrastive.py,
models/convert.py::condenser_state_dict_from_jax) against the JAX
package's on the same weights and inputs: float32 on the CPU, dropout off
(eval mode here, deterministic=True there), except where a test says
otherwise."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.losses.contrastive import (
    co_contrastive_loss as jax_co_loss,
    flipped_pair_targets as jax_targets,
)
from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.bert import BertModel as JaxBertModel
from cocodr_tpu.models.condenser import (
    CoCondenserForPretraining as JaxCoCondenser,
    condenser_params_to_torch,
    mlm_cross_entropy as jax_mlm_ce,
)
from cocodr_tpu_torch.losses.contrastive import (
    co_contrastive_loss,
    flipped_pair_targets,
)
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig, BertModel
from cocodr_tpu_torch.models.condenser import (
    CoCondenserForPretraining,
    build_condenser,
    join_state_dict,
    mlm_cross_entropy,
    split_state_dict,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)  # float32, sums in another order
B, S, HEADS, SKIP = 8, 32, 2, 1


def jax_condenser(late_mlm, frac=0.25, dtype=jnp.float32):
    return JaxCoCondenser(JaxBertConfig.tiny(dtype=dtype), n_head_layers=HEADS,
                          skip_from=SKIP, late_mlm=late_mlm,
                          mlm_budget_frac=frac)


def port_condenser(jax_params, late_mlm, frac=0.25, dtype=torch.float32):
    cfg = BertConfig.tiny(dtype=dtype)
    model = CoCondenserForPretraining(cfg, n_head_layers=HEADS,
                                      skip_from=SKIP, late_mlm=late_mlm,
                                      mlm_budget_frac=frac)
    model.load_state_dict(convert.condenser_state_dict_from_jax(
        jax.device_get(jax_params), cfg, HEADS))
    return model.eval()


def batch(seed=3, p_mask=0.15):
    """ids, a mask with padding, labels at ~p_mask of the real positions
    (T = 256: the 0.25 budget is 128 rows, a real gather)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 120, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 20:] = 0
    mask[5, 9:] = 0
    labels = np.full((B, S), -100, np.int32)
    pos = (rng.random((B, S)) < p_mask) & (mask == 1)
    pos[:, 0] = False
    labels[pos] = rng.integers(5, 120, pos.sum())
    return ids, mask, labels


def jax_init(model, ids, mask, labels, seed=0):
    return model.init(jax.random.PRNGKey(seed), ids[:2], mask[:2],
                      labels[:2])["params"]


def to_torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_contrastive_loss_values_and_gradients_match_jax():
    """flipped_pair_targets and co_contrastive_loss (mean and per row) and
    the loss's gradient against the JAX ones, 1e-6 relative (float32)."""
    assert flipped_pair_targets(6).tolist() == np.asarray(
        jax_targets(6)).tolist() == [1, 0, 3, 2, 5, 4]
    x = np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32)
    t = torch.from_numpy(x).requires_grad_()
    loss = co_contrastive_loss(t)
    loss.backward()
    jl, jg = jax.value_and_grad(jax_co_loss)(jnp.asarray(x))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(
        co_contrastive_loss(torch.from_numpy(x), reduction="none").numpy(),
        np.asarray(jax_co_loss(jnp.asarray(x), reduction="none")),
        rtol=1e-6)


def test_contrastive_axis_name_names_its_item():
    """axis_name raised naming item 11 until the multi-device slice; over
    a world of one process the gathered form's loss and gradient equal the
    global form's bit for bit (W = 2 and 4 against JAX's shard_map form:
    tests/test_torch_sharded_train.py)."""
    import torch_mesh_workers as workers

    x = torch.from_numpy(np.random.RandomState(1).randn(6, 4)
                         .astype(np.float32))
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    want = co_contrastive_loss(a)
    want.backward()
    with workers.world_of_one() as mesh:
        got = co_contrastive_loss(b, axis_name=mesh)
        got.backward()
    assert torch.equal(got.detach(), want.detach())
    assert torch.equal(b.grad, a.grad)


def test_mlm_cross_entropy_ignore_index_matches_jax():
    """Positions labelled -100 are left out of the mean; all -100 gives 0
    (as the JAX function's max(count, 1)); 1e-6 relative."""
    logits = np.random.default_rng(0).normal(size=(2, 3, 7)).astype(np.float32)
    for labels in (np.array([[1, -100, 2], [-100, -100, 3]]),
                   np.full((2, 3), -100)):
        got = mlm_cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels))
        want = jax_mlm_ce(jnp.asarray(logits), jnp.asarray(labels))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert mlm_cross_entropy(torch.from_numpy(logits),
                             torch.full((2, 3), -100)).item() == 0.0


def test_hidden_states_match_flax():
    """output_hidden_states: the embeddings output and each layer's output,
    equal to the flax [L + 1, B, S, H] stack row by row (1e-5)."""
    ids, mask, _ = batch()
    jm = JaxBertModel(JaxBertConfig.tiny())
    params = jm.init(jax.random.PRNGKey(0), ids, mask)["params"]
    last_j, hs_j, _ = jm.apply({"params": params}, ids, mask,
                               output_hidden_states=True)
    cfg = BertConfig.tiny()
    model = BertModel(cfg).eval()
    model.load_state_dict(convert.bert_state_dict_from_jax(
        jax.device_get(params), cfg))
    last, hs = model(*to_torch(ids, mask), output_hidden_states=True)
    assert isinstance(hs, tuple) and len(hs) == cfg.num_hidden_layers + 1
    assert hs[-1] is last
    for got, want in zip(hs, np.asarray(hs_j)):
        np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(last.detach().numpy(), np.asarray(last_j),
                               **TOL)


def _logit_params(dtype):
    """A JAX Condenser in `dtype` with a random decoder bias and its port
    twin, and one transformed [64, H] input in `dtype` for both."""
    ids, mask, labels = batch()
    jm = jax_condenser(True, dtype=dtype)
    params = jax.device_get(jax_init(jm, ids, mask, labels))
    params = dict(params)
    params["decoder_bias"] = np.random.default_rng(1).normal(
        0, 0.5, 128).astype(np.float32)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    model = port_condenser(params, True, dtype=tdt)
    h = np.random.default_rng(2).normal(size=(64, 32)).astype(np.float32)
    return jm, params, model, h


def test_mlm_logits_match_flax_in_float32():
    """mlm_transform + tied decoder + bias, float32: 1e-5."""
    jm, params, model, h = _logit_params(jnp.float32)
    want = jm.apply({"params": params}, jnp.asarray(h),
                    method=jm.mlm_logits)
    got = model.mlm_logits(torch.from_numpy(h))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _decoder_logits(model, h_bf16, decoder_dtype):
    emb = model.bert.embeddings.word_embeddings.weight
    prod = torch.nn.functional.linear(h_bf16.to(decoder_dtype),
                                      emb.to(decoder_dtype))
    return prod.float() + model.cls["predictions"].bias


def test_tied_decoder_rounds_as_flax_in_bf16():
    """flax's nn.Embed.attend casts both operands to the compute dtype, so
    in bf16 the decoder's logits are a bf16 product's bf16 values, and the
    float32 bias is added after. The port's decoder agrees with flax's to
    within one bf16 ulp of the logits (sums in another order; 99% of them
    equal), while a float32 decoder product on the same inputs is off on
    most of them by up to half an ulp and fails the share."""
    jm, params, model, h = _logit_params(jnp.bfloat16)
    h_b = jnp.asarray(h, jnp.bfloat16)
    want = np.asarray(jm.apply(
        {"params": params}, h_b,
        method=lambda m, x: m.bert.mlm_logits_from_embed(x) + m.decoder_bias))
    assert want.dtype == np.float32
    h_t = torch.from_numpy(np.asarray(h_b.astype(jnp.float32))).bfloat16()
    got = (model.bert.mlm_logits_from_embed(h_t)
           + model.cls["predictions"].bias).detach().numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        got, _decoder_logits(model, h_t, torch.bfloat16).detach().numpy())
    prod = want - params["decoder_bias"]
    ulp = np.abs(prod) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(got - want) <= ulp)
    assert np.mean(got != want) <= 0.01
    f32 = _decoder_logits(model, h_t, torch.float32).detach().numpy()
    assert np.mean(f32 != want) > 0.5


@pytest.mark.parametrize("late_mlm", [True, False])
@pytest.mark.parametrize("frac", [0.25, 1.0], ids=["budget", "dense"])
def test_condenser_loss_aux_and_grads_match_jax(late_mlm, frac):
    """loss_with_contrastive's loss, aux (cls, head_mlm_loss,
    backbone_mlm_loss, co_loss) and the gradient of every parameter
    against the JAX model's through condenser_state_dict_from_jax, with
    the budget gather (frac 0.25 of T = 256: 128 rows) and the dense
    decoder (frac 1.0); float32, 1e-5."""
    ids, mask, labels = batch()
    jm = jax_condenser(late_mlm, frac)
    params = jax_init(jm, ids, mask, labels)

    def jloss(p):
        return jm.apply({"params": p}, ids, mask, labels,
                        method=jm.loss_with_contrastive)

    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    model = port_condenser(params, late_mlm, frac)
    loss, aux = model.loss_with_contrastive(*to_torch(ids, mask, labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    for k in ("head_mlm_loss", "backbone_mlm_loss", "co_loss"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), **TOL,
                                   err_msg=k)
    if not late_mlm:
        assert aux["backbone_mlm_loss"].item() == 0.0
    np.testing.assert_allclose(aux["cls"].detach().numpy(),
                               np.asarray(jaux["cls"]), **TOL)
    want = convert.condenser_state_dict_from_jax(jax.device_get(jg),
                                                 model.cfg, HEADS)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_budget_gather_equals_dense_path():
    """The budget's gather (frac 0.25: 128 of T = 256 rows, ~38 masked)
    gives the dense [T, vocab] path's loss and gradients, late_mlm on (the
    paired product); 1e-6 relative, 1e-7 absolute in the gradients."""
    ids, mask, labels = batch(seed=9)
    jm = jax_condenser(True)
    params = jax_init(jm, ids, mask, labels)
    out = {}
    for frac in (1.0, 0.25):
        model = port_condenser(params, True, frac)
        assert (model._mlm_budget(torch.from_numpy(labels)) is None) == (
            frac == 1.0)
        loss, _ = model(*to_torch(ids, mask, labels))
        loss.backward()
        out[frac] = (loss.item(), {k: p.grad.clone()
                                   for k, p in model.named_parameters()})
    assert out[0.25][0] == pytest.approx(out[1.0][0], rel=1e-6)
    for k, g in out[1.0][1].items():
        np.testing.assert_allclose(out[0.25][1][k].numpy(), g.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_budget_order_puts_masked_positions_first_in_order():
    """The stable argsort: masked positions first in their order, then the
    others in theirs, cut to ceil(int(T * frac) / 128) * 128 rows, and
    None when that is not smaller than T (the JAX _mlm_budget's order)."""
    model = CoCondenserForPretraining(BertConfig.tiny(), 1, 1,
                                      mlm_budget_frac=0.3)
    labels = np.full((4, 100), -100, np.int32)
    labels[0, 5] = labels[2, 7] = labels[3, 99] = 1
    order, l_sel = model._mlm_budget(torch.from_numpy(labels))
    assert order.shape == (128,)  # int(400 * 0.3) = 120 -> 128
    assert order[:3].tolist() == [5, 207, 399]
    assert order[3:].tolist() == [i for i in range(400)
                                  if i not in (5, 207, 399)][:125]
    assert l_sel[:3].tolist() == [1, 1, 1] and (l_sel[3:] == -100).all()
    model.mlm_budget_frac = 0.32  # int(128) -> 128 >= T
    assert model._mlm_budget(torch.from_numpy(labels[:, :32])) is None


def test_split_state_dict_matches_condenser_params_to_torch():
    """(backbone_sd, c_head_sd) key for key and value for value against
    the JAX condenser_params_to_torch (HuggingFace BertModel + MLM head
    names, the model.pt c_head names); join_state_dict is its inverse."""
    ids, mask, labels = batch()
    jm = jax_condenser(True)
    params = jax.device_get(jax_init(jm, ids, mask, labels))
    model = port_condenser(params, True)
    backbone, head = split_state_dict(model.state_dict())
    want_b, want_h = condenser_params_to_torch(params, JaxBertConfig.tiny())
    assert sorted(backbone) == sorted(want_b)
    assert sorted(head) == sorted(want_h)
    for got, want in ((backbone, want_b), (head, want_h)):
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    joined = join_state_dict(backbone, head)
    assert joined.keys() == model.state_dict().keys()
    fresh = CoCondenserForPretraining(model.cfg, HEADS, SKIP, True)
    fresh.load_state_dict(joined)
    with pytest.raises(KeyError):
        split_state_dict({"pooler.dense.weight": torch.zeros(1)})


def test_build_condenser_draws_bert_init(monkeypatch):
    """build_condenser: normal(0, 0.02) weights from the generator, zero
    biases (the decoder's too), unit LayerNorm scales, eval mode; the same
    seed gives the same weights; no card and no device='cpu' raises."""
    cfg = BertConfig.tiny()
    a = build_condenser(cfg, "cpu", torch.Generator().manual_seed(4),
                        n_head_layers=HEADS, skip_from=SKIP)
    b = build_condenser(cfg, "cpu", torch.Generator().manual_seed(4),
                        n_head_layers=HEADS, skip_from=SKIP)
    assert not a.training and isinstance(a, CoCondenserForPretraining)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    sd = a.state_dict()
    assert (sd["cls.predictions.bias"] == 0).all()
    assert (sd["c_head.1.output.LayerNorm.weight"] == 1).all()
    assert abs(sd["c_head.0.intermediate.dense.weight"].std().item()
               - 0.02) < 0.003
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_condenser(cfg)


def test_mlm_budget_frac_is_the_stage_default():
    """The model default and the stage preset, as in the JAX package."""
    from cocodr_tpu.models.condenser import CondenserForPretraining as J

    assert CoCondenserForPretraining(BertConfig.tiny()).mlm_budget_frac == \
        J(JaxBertConfig.tiny()).mlm_budget_frac == 0.25
    jfields = {f.name: f.default
               for f in dataclasses.fields(J)
               if f.name in ("n_head_layers", "skip_from", "late_mlm")}
    port = CoCondenserForPretraining(BertConfig.tiny())
    assert jfields == {"n_head_layers": len(port.c_head),
                       "skip_from": port.skip_from,
                       "late_mlm": port.late_mlm}
