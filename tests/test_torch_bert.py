"""BERT encoder and dual-encoder towers: the port against the flax models
in float32 on the CPU, on the same weights (models/convert.py) and inputs,
with padded (masked) rows."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.bert import BertModel as JaxBertModel
from cocodr_tpu.models.bert import make_attention_bias as jax_bias
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig, BertModel, make_attention_bias
from cocodr_tpu_torch.models.dual_encoder import (
    DualEncoder,
    MODEL_REGISTRY,
    build_dual_encoder,
    masked_mean,
)

torch.set_num_threads(1)

F_TINY = 128  # tiny: 2 layers, H=32, 4 heads, F=128
TOL = dict(atol=2e-5, rtol=2e-5)  # float32, sums in another order


def _tokens(B=3, S=12, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, 128, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 7:] = 0  # padded rows
    mask[2, 3:] = 0
    ids[mask == 0] = 0
    return ids, mask


def _flax_bert(seed=0):
    cfg = dataclasses.replace(JaxBertConfig.tiny(), intermediate_size=F_TINY)
    model = JaxBertModel(cfg)
    ids, mask = _tokens()
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(ids),
                        jnp.asarray(mask))["params"]
    return cfg, model, jax.device_get(params)


def test_bert_model_matches_flax():
    jcfg, jmodel, params = _flax_bert()
    ids, mask = _tokens()
    want, _, _ = jmodel.apply({"params": params}, jnp.asarray(ids),
                              jnp.asarray(mask))
    cfg = BertConfig.tiny(intermediate_size=F_TINY)
    model = BertModel(cfg).eval()
    model.load_state_dict(convert.bert_state_dict_from_jax(params, cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert got.shape == (3, 12, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bert_token_types_match_flax():
    jcfg, jmodel, params = _flax_bert(seed=1)
    ids, mask = _tokens(seed=1)
    tt = (np.arange(12)[None, :] >= 6).astype(np.int32).repeat(3, 0)
    want, _, _ = jmodel.apply({"params": params}, jnp.asarray(ids),
                              jnp.asarray(mask), jnp.asarray(tt))
    cfg = BertConfig.tiny(intermediate_size=F_TINY)
    model = BertModel(cfg).eval()
    model.load_state_dict(convert.bert_state_dict_from_jax(params, cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                    torch.from_numpy(tt).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_bias_matches_flax():
    _, mask = _tokens()
    want = np.asarray(jax_bias(jnp.asarray(mask)))
    got = make_attention_bias(torch.from_numpy(mask))
    assert got.shape == (3, 1, 1, 12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_masked_mean_ignores_padding():
    h = torch.arange(24, dtype=torch.float32).view(2, 3, 4)
    m = torch.tensor([[1, 1, 0], [1, 0, 0]])
    got = masked_mean(h, m)
    assert torch.allclose(got[0], h[0, :2].mean(0))
    assert torch.equal(got[1], h[1, 0])


@pytest.mark.parametrize("model_type", ["rdot_nll", "rdot_nll_condenser"])
@pytest.mark.parametrize("tower", ["query_emb", "body_emb"])
def test_dual_encoder_matches_flax(model_type, tower):
    jcfg = dataclasses.replace(JaxBertConfig.tiny(), intermediate_size=F_TINY)
    jmodel = jax_build(model_type, jcfg, head_dim=16)
    ids, mask = _tokens(seed=2)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(3),
                                        jnp.asarray(ids),
                                        jnp.asarray(mask))["params"])
    want = jmodel.apply({"params": params}, jnp.asarray(ids),
                        jnp.asarray(mask), method=getattr(jmodel, tower))
    cfg = MODEL_REGISTRY[model_type](BertConfig.tiny(intermediate_size=F_TINY),
                                     head_dim=16)
    model = DualEncoder(cfg).eval()
    model.load_state_dict(convert.params_from_jax(params, cfg))
    with torch.no_grad():
        got = getattr(model, tower)(torch.from_numpy(ids).long(),
                                    torch.from_numpy(mask))
    assert got.shape == (3, 16 if cfg.use_head else 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_build_dual_encoder_is_seeded_and_in_eval_mode():
    cfg = BertConfig.tiny(intermediate_size=F_TINY)
    a = build_dual_encoder("rdot_nll", cfg, device="cpu",
                           generator=torch.Generator().manual_seed(7))
    b = build_dual_encoder("rdot_nll", cfg, device="cpu",
                           generator=torch.Generator().manual_seed(7))
    assert not a.training
    for (na, pa), (_, pb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(pa, pb), na
    w = a.encoder.encoder.layer[0].intermediate.dense.weight.detach()
    assert abs(float(w.std()) - cfg.initializer_range) < 0.005
    with pytest.raises(KeyError):
        build_dual_encoder("dpr", cfg, device="cpu")


def test_training_mode_with_dropout_raises(monkeypatch):
    """A training-mode forward with dropout raises without a generator (the
    port never draws from the global RNG, whose state stays as it was);
    with one it runs and takes the semi-fused path: K5's `ffn` once a
    layer, K1's `ffn_block` never."""
    import cocodr_tpu_torch.models.bert as tbert

    model = BertModel(BertConfig.tiny()).train()
    ids = torch.ones((1, 4), dtype=torch.long)
    rng = torch.get_rng_state()
    with pytest.raises(ValueError, match="generator"):
        model(ids)
    assert torch.equal(torch.get_rng_state(), rng)
    calls = {"ffn": 0, "ffn_block": 0}
    for name in calls:
        real = getattr(tbert, name)
        monkeypatch.setattr(
            tbert, name,
            lambda *a, _n=name, _f=real: calls.__setitem__(_n, calls[_n] + 1)
            or _f(*a))
    out = model(ids, generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, 4, 32) and torch.isfinite(out).all()
    assert calls == {"ffn": 2, "ffn_block": 0}
    assert torch.equal(torch.get_rng_state(), rng)


def test_bf16_compute_stays_close_to_f32():
    """The bf16 compute path (the card's dtype) on the CPU: same weights,
    embeddings within bf16 resolution of the float32 ones."""
    ids, mask = _tokens(seed=4)
    gen = torch.Generator().manual_seed(0)
    f32 = build_dual_encoder("rdot_nll_condenser",
                             BertConfig.tiny(intermediate_size=F_TINY),
                             device="cpu", generator=gen)
    bf16 = DualEncoder(MODEL_REGISTRY["rdot_nll_condenser"](
        BertConfig.tiny(intermediate_size=F_TINY, dtype=torch.bfloat16)))
    bf16.load_state_dict(f32.state_dict())
    bf16.eval()
    args = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    with torch.no_grad():
        a, b = f32.query_emb(*args), bf16.query_emb(*args)
    assert b.dtype == torch.bfloat16
    assert float((a - b.float()).abs().max()) < 0.1


def test_token_type_one_hot_equals_the_lookup():
    """BertEmbeddings takes the token-type rows by a one-hot product (a
    GEMM backward, which sums in one order on the card): the rows equal
    nn.Embedding's lookup bit for bit, with float32 weights and with
    weights held in bf16 (cast_matmul_weights), and the gradient equals
    the lookup's to 1e-6 (float32, sums in another order)."""
    from cocodr_tpu_torch.models.bert import BertEmbeddings

    cfg = BertConfig.tiny(type_vocab_size=3)
    emb = BertEmbeddings(cfg).eval()
    tt = torch.randint(0, 3, (4, 9), generator=torch.Generator().manual_seed(0))
    ids = torch.randint(5, 128, (4, 9), generator=torch.Generator().manual_seed(1))
    pos = torch.arange(9)[None, :]
    out = emb(ids, tt, pos)
    out.square().sum().backward()
    got = emb.token_type_embeddings.weight.grad.clone()
    emb.zero_grad()
    ref = emb.LayerNorm(emb.word_embeddings(ids) + emb.position_embeddings(pos)
                        + emb.token_type_embeddings(tt))
    assert torch.equal(out, ref)
    ref.square().sum().backward()
    np.testing.assert_allclose(got.numpy(),
                               emb.token_type_embeddings.weight.grad.numpy(),
                               rtol=1e-6, atol=1e-6)
    emb.token_type_embeddings.to(torch.bfloat16)
    w = emb.token_type_embeddings.weight
    one_hot = torch.nn.functional.one_hot(tt, 3).to(w.dtype) @ w
    assert torch.equal(one_hot, emb.token_type_embeddings(tt))
