"""The dropout path of the port's BERT: the semi-fused half-layer (K5's
plain version on the CPU) against the flax model in train mode, with
dropout made the identity on both sides (the two packages' random bits
cannot match: threefry keys are not torch generators), and the masks'
statistics on their own."""
import dataclasses

import flax.linen
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu_torch.models import bert as tbert
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig, dropout
from cocodr_tpu_torch.models.dual_encoder import MODEL_REGISTRY, DualEncoder
from cocodr_tpu_torch.pipelines.train_step import dropout_generators

torch.set_num_threads(1)


def _tokens(B=3, S=12, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, 128, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 7:] = 0
    mask[2, 3:] = 0
    return ids * mask, mask


@pytest.mark.parametrize("ffn_impl", ["fused", "dense"])
def test_dropout_path_matches_flax_train_mode(monkeypatch, ffn_impl):
    """hidden and attention dropout 0.1, both models in train mode, dropout
    patched to the identity (flax.linen.Dropout here, the port's `dropout`
    helper there): the towers take the semi-fused path (K5's `ffn`, or the
    dense pair) and the einsum attention with its dropout site. Embeddings
    and the gradients of sum(emb * ct) for every parameter agree, float32,
    tolerance 2e-5 (embeddings) and 1e-5 (gradients)."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    monkeypatch.setattr(tbert, "dropout", lambda x, p, generator: x)

    def no_k1(*a):
        raise AssertionError("the dropout path must not take K1")

    monkeypatch.setattr(tbert, "ffn_block", no_k1)
    jcfg = dataclasses.replace(JaxBertConfig.tiny(), ffn_impl=ffn_impl)
    assert jcfg.hidden_dropout_prob == 0.1
    jmodel = jax_build("rdot_nll", jcfg, head_dim=16)
    ids, mask = _tokens()
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                        jnp.asarray(ids),
                                        jnp.asarray(mask))["params"])
    ct = np.random.RandomState(1).randn(3, 16).astype(np.float32)

    def loss(p):
        emb = jmodel.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                           deterministic=False, method=jmodel.body_emb)
        return jnp.sum(emb * ct), emb

    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    cfg = MODEL_REGISTRY["rdot_nll"](BertConfig.tiny(ffn_impl=ffn_impl),
                                     head_dim=16)
    model = DualEncoder(cfg).train()
    model.load_state_dict(convert.params_from_jax(params, cfg))
    got = model.body_emb(torch.from_numpy(ids), torch.from_numpy(mask),
                         generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    (got * torch.from_numpy(ct)).sum().backward()
    want_g = convert.params_from_jax(jax.device_get(jgrads), cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mask_keep_rate_and_scale(dtype):
    """200,000 elements at p = 0.1: the kept share lies within 4 standard
    errors of 0.9; kept elements are x / 0.9 in x's dtype (flax divides by
    the keep probability), the rest are zero."""
    n, p = 200_000, 0.1
    x = (torch.randn(n, generator=torch.Generator().manual_seed(3)) + 3.0
         ).to(dtype)  # no zeros among the inputs
    out = dropout(x, p, torch.Generator().manual_seed(4))
    kept = out != 0
    rate = kept.float().mean().item()
    assert abs(rate - (1 - p)) < 4 * np.sqrt(p * (1 - p) / n)
    assert out.dtype == dtype
    assert torch.equal(out[kept], (x / (1 - p))[kept])
    assert torch.equal(out[kept].float(),
                       (x.float() / (1 - p)).to(dtype).float()[kept])


def test_tower_generators_draw_independent_reproducible_masks():
    """dropout_generators(seed, step) gives the three towers different
    masks; the same (seed, step) gives the same masks again, another step
    or seed other masks. Through the tower: one input, train mode."""
    cfg = MODEL_REGISTRY["rdot_nll_condenser"](BertConfig.tiny())
    model = DualEncoder(cfg).train()
    ids, mask = (torch.from_numpy(a) for a in _tokens(seed=2))

    def emb(gen):
        with torch.no_grad():
            return model.body_emb(ids, mask, generator=gen)

    q, a, b = (emb(g) for g in dropout_generators(5, 10, "cpu"))
    assert not torch.equal(a, b) and not torch.equal(q, a)
    a2 = emb(dropout_generators(5, 10, "cpu")[1])
    assert torch.equal(a, a2)
    assert not torch.equal(a, emb(dropout_generators(5, 11, "cpu")[1]))
    assert not torch.equal(a, emb(dropout_generators(6, 10, "cpu")[1]))
    model.eval()
    e1 = emb(None)
    assert torch.equal(e1, emb(dropout_generators(5, 10, "cpu")[1]))
