"""Corpus encoding: the port's pipelines/encode.py against the JAX
package's on the same tiny record file and flax weights (float32, CPU),
with and without length buckets, through both towers, and in the int8
and fused-attention configurations; the prefetch thread and the
embedding noise."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.bert import BertModel as JaxBertModel
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu.pipelines import encode as jenc
from cocodr_tpu_torch.data.prefetch import _to_device, prefetch
from cocodr_tpu_torch.data.records import RecordWriter, TokenCache
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig, BertModel
from cocodr_tpu_torch.models.dual_encoder import DualEncoder, MODEL_REGISTRY
from cocodr_tpu_torch.pipelines import encode as tenc
from cocodr_tpu_torch.utils.misc import NOISE_SCALE, add_embedding_noise

torch.set_num_threads(1)

MAX_LEN = 24
N_DOCS = 29  # batches of 8: the last one ragged
TOL = dict(atol=2e-5, rtol=2e-5)  # float32 sums in another order


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    rng = np.random.RandomState(0)
    path = str(tmp_path_factory.mktemp("recs") / "passages")
    with RecordWriter(path, MAX_LEN) as w:
        for _ in range(N_DOCS):
            n = rng.randint(2, MAX_LEN + 1)
            w.write([2] + rng.randint(5, 128, n - 1).tolist())
    return TokenCache(path)


def _pair(**cfg_kw):
    """(JAX Encoder factory, port model factory) on the same flax weights
    of a tiny rdot_nll tower (projection head on)."""
    jcfg = dataclasses.replace(JaxBertConfig.tiny(), intermediate_size=128,
                               **cfg_kw)
    jmodel = jax_build("rdot_nll", jcfg, head_dim=16)
    ones = jnp.ones((1, 8), jnp.int32)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), ones,
                                        ones)["params"])
    cfg = MODEL_REGISTRY["rdot_nll"](
        BertConfig.tiny(intermediate_size=128, **cfg_kw), head_dim=16)
    state = convert.params_from_jax(params, cfg)

    def port_model():
        model = DualEncoder(cfg)
        model.load_state_dict(state)
        return model

    def jax_encoder(**kw):
        return jenc.Encoder(jmodel, params, **kw)

    return jax_encoder, port_model


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.mark.parametrize("buckets", [(), (8, 16, 24)])
@pytest.mark.parametrize("is_query", [False, True])
def test_encode_cache_matches_jax(cache, pair, buckets, is_query):
    jax_encoder, port_model = pair
    cfg_j = jenc.EncodeConfig(batch_size=8, length_buckets=buckets)
    cfg_t = tenc.EncodeConfig(batch_size=8, length_buckets=buckets)
    want = jenc.encode_cache(jax_encoder(is_query=is_query), cache, cfg_j)
    enc = tenc.Encoder(port_model(), is_query=is_query, device="cpu")
    got = tenc.encode_cache(enc, cache, cfg_t)
    assert got.shape == (N_DOCS, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def test_bucketed_equals_unbucketed_and_reports_progress(cache, pair):
    """Bucketing only drops padding columns, which the attention bias
    masks: the same embeddings up to float32 sums over fewer zeros."""
    enc = tenc.Encoder(pair[1](), device="cpu")
    calls = []
    flat = tenc.encode_cache(enc, cache, tenc.EncodeConfig(batch_size=8),
                             progress=lambda d, n: calls.append((d, n)))
    assert calls == [(8, 29), (16, 29), (24, 29), (29, 29)]
    calls.clear()
    bucketed = tenc.encode_cache(
        enc, cache, tenc.EncodeConfig(batch_size=8, length_buckets=(16, 24)),
        progress=lambda d, n: calls.append((d, n)))
    assert calls == [(16, 24), (24, 24)]
    np.testing.assert_allclose(bucketed, flat, **TOL)
    with pytest.raises(AssertionError):
        tenc.encode_cache(enc, cache, tenc.EncodeConfig(length_buckets=(8,)))


@pytest.mark.parametrize("buckets", [(), (8, 24)])
def test_indices_ragged_batches_and_no_prefetch(cache, pair, buckets):
    jax_encoder, port_model = pair
    idx = np.array([28, 3, 3, 17, 0, 9, 21, 4, 11, 26, 1])  # 8 + 3
    want = jenc.encode_cache(jax_encoder(), cache,
                             jenc.EncodeConfig(batch_size=8,
                                               length_buckets=buckets),
                             indices=idx)
    enc = tenc.Encoder(port_model(), device="cpu")
    cfg = tenc.EncodeConfig(batch_size=8, length_buckets=buckets)
    got = tenc.encode_cache(enc, cache, cfg, indices=idx)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(
        tenc.encode_cache(enc, cache, cfg, indices=idx, prefetch_depth=0),
        got)


@pytest.mark.parametrize("cfg_kw", [{"matmul_int8": True},
                                    {"attention_impl": "fused"}],
                         ids=["int8", "fused_attention"])
def test_int8_and_fused_attention_encoders_match_jax(cache, cfg_kw):
    """The int8 (K7) and fused-attention (K8) towers against their JAX
    twins on the same weights, with buckets (widths 8 and 16 take K8, 24
    does too). Tolerance 2e-5: float32 sums and LayerNorm statistics in
    another order; a quantized activation that moved by one step would
    show as ~1e-3."""
    jax_encoder, port_model = _pair(**cfg_kw)
    for buckets in ((), (8, 16, 24)):
        want = jenc.encode_cache(
            jax_encoder(), cache,
            jenc.EncodeConfig(batch_size=8, length_buckets=buckets))
        got = tenc.encode_cache(
            tenc.Encoder(port_model(), device="cpu"), cache,
            tenc.EncodeConfig(batch_size=8, length_buckets=buckets))
        np.testing.assert_allclose(got, want, **TOL)


def test_noise(cache, pair):
    """Level 0 is bit-equal to no noise. Level 0.1 adds N(0, 1) * 26.8 *
    0.1 per element, fresh for every batch: 928 draws give the sample mean
    within 4 standard errors of 0 and the sample std within 10% of 2.68,
    as the JAX package's noise does on the same inputs."""
    jax_encoder, port_model = pair
    cfg = tenc.EncodeConfig(batch_size=8)
    model = port_model()
    clean = tenc.encode_cache(tenc.Encoder(model, device="cpu"), cache, cfg)
    zero = tenc.encode_cache(tenc.Encoder(model, noise_level=0.0,
                                          noise_seed=3, device="cpu"),
                             cache, cfg)
    np.testing.assert_array_equal(zero, clean)
    want_std = NOISE_SCALE * 0.1
    jclean = jenc.encode_cache(jax_encoder(), cache,
                               jenc.EncodeConfig(batch_size=8))
    jnoisy = jenc.encode_cache(jax_encoder(noise_level=0.1), cache,
                               jenc.EncodeConfig(batch_size=8))
    noisy = tenc.encode_cache(tenc.Encoder(model, noise_level=0.1,
                                           noise_seed=3, device="cpu"),
                              cache, cfg)
    for d in (noisy - clean, jnoisy - jclean):
        assert abs(d.mean()) < 4 * want_std / np.sqrt(d.size)
        assert abs(d.std() / want_std - 1) < 0.1
    # the same 8 records twice: two batches, two draws
    idx = np.concatenate([np.arange(8), np.arange(8)])
    twice = tenc.encode_cache(tenc.Encoder(model, noise_level=0.1,
                                           device="cpu"), cache, cfg,
                              indices=idx)
    assert not np.allclose(twice[:8], twice[8:])
    # seeded: the same seed gives the same draws
    again = tenc.encode_cache(tenc.Encoder(model, noise_level=0.1,
                                           noise_seed=3, device="cpu"),
                              cache, cfg)
    np.testing.assert_array_equal(again, noisy)


def test_add_embedding_noise_keeps_dtype():
    emb = torch.zeros(64, 32, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    assert add_embedding_noise(emb, gen, 0.0) is emb
    out = add_embedding_noise(emb, gen, 1.0)
    assert out.dtype == torch.bfloat16
    assert 20 < float(out.float().std()) < 34


def test_mesh_raises(pair):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        tenc.Encoder(pair[1](), mesh=object(), device="cpu")


def test_encoder_without_cuda_raises(pair, monkeypatch):
    """No CPU fallback: without a card the Encoder (and so encode_cache)
    and a prefetch that puts batches on the device raise unless asked for
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tenc.Encoder(pair[1]())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prefetch(iter([]), device_put=True)


def test_prefetch_order_devices_and_errors():
    batches = [(i, np.full((2, 3), i, np.int32)) for i in range(5)]
    host = list(prefetch(iter(batches), depth=2, device_put=False))
    assert [b[0] for b in host] == list(range(5))
    assert all(isinstance(b[1], np.ndarray) for b in host)
    # what the producer does to a batch with device_put=True, here on the
    # CPU (the thread itself asks for the card)
    moved = [_to_device(b, torch.device("cpu")) for b in batches]
    assert all(b[0] == a[0] and torch.equal(b[1], torch.from_numpy(a[1]))
               for b, a in zip(moved, batches))

    def broken():
        yield batches[0]
        raise KeyError("bad record")

    it = prefetch(broken(), device_put=False)
    assert next(it)[0] == 0
    with pytest.raises(KeyError, match="bad record"):
        next(it)


def test_params_from_jax_at_bert_large_widths():
    """A bert-large-shaped flax tree (N = 16, D = 64, H = 1024, F = 4096;
    one layer, vocab 128) maps onto the port's BertModel, whose forward
    agrees with flax in float32 (tolerance 2e-5, sums in another
    order)."""
    jcfg = dataclasses.replace(JaxBertConfig.large(vocab_size=128),
                               num_hidden_layers=1)
    jmodel = JaxBertModel(jcfg)
    rng = np.random.RandomState(0)
    ids = rng.randint(5, 128, (2, 8)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 5:] = 0
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                        jnp.asarray(ids),
                                        jnp.asarray(mask))["params"])
    want, _, _ = jmodel.apply({"params": params}, jnp.asarray(ids),
                              jnp.asarray(mask))
    cfg = BertConfig.large(num_hidden_layers=1, vocab_size=128)
    assert (cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size,
            cfg.intermediate_size) == (16, 64, 1024, 4096)
    model = BertModel(cfg).eval()
    model.load_state_dict(convert.bert_state_dict_from_jax(params, cfg))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
