"""K7 (the W8A8 FFN half-layer) and its building blocks: the port's
ops/int8_matmul.py and plain K7 against the JAX package's int8_matmul.py
and Pallas kernel (interpret mode), and the port's int8 encoder against
the checks of tests/test_int8_encode.py, on the same numpy inputs and
flax weights."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu.ops import int8_matmul as jq
from cocodr_tpu.ops.pallas_ffn import ffn_block_int8 as jax_ffn_block_int8
from cocodr_tpu.ops.pallas_ffn import fused_ffn_block_int8 as jax_kernel
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig, cast_matmul_weights
from cocodr_tpu_torch.models.dual_encoder import DualEncoder, MODEL_REGISTRY
from cocodr_tpu_torch.ops import ffn as tffn
from cocodr_tpu_torch.ops import int8_matmul as tq

torch.set_num_threads(1)

# the widths of tests/test_int8_encode.py
TINY = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("shape", [(16, 24), (7, 128)])
def test_quantize_rows_bit_equal(shape):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    x[1] = 0.0  # an all-zero row: scale 1e-30 / 127, values 0
    x[2, :3] = [0.5, -0.5, 1.5]  # ties round to even
    jv, js = jq.quantize_rows(jnp.asarray(x))
    tv, ts = tq.quantize_rows(_t(x))
    assert tv.dtype == torch.int8 and ts.shape == (shape[0], 1)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_cols_bit_equal_per_output_channel():
    """The port's weight is the transpose of the JAX kernel: an output
    channel is a row here and a column there."""
    w = np.random.RandomState(1).randn(24, 40).astype(np.float32)  # [H, F]
    jv, js = jq.quantize_cols(jnp.asarray(w))
    tv, ts = tq.quantize_cols(_t(w.T))
    assert ts.shape == (40, 1)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).T)


def test_dense_w8a8_bit_equal_and_numpy_reference():
    """Bit-equal to the JAX function (integer sums are exact in both); the
    numpy reference of tests/test_int8_encode.py:31 within its 1e-5."""
    rng = np.random.RandomState(0)
    x = rng.randn(16, 24).astype(np.float32)
    w = rng.randn(24, 40).astype(np.float32)
    b = rng.randn(40).astype(np.float32)
    want = np.asarray(jq.dense_w8a8(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), out_dtype=jnp.float32))
    got = tq.dense_w8a8(_t(x), _t(w.T), _t(b), out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    sx = np.maximum(np.abs(x).max(axis=1, keepdims=True), 1e-30) / 127.0
    xq = np.clip(np.round(x / sx), -127, 127).astype(np.int32)
    sw = np.maximum(np.abs(w).max(axis=0, keepdims=True), 1e-30) / 127.0
    wq = np.clip(np.round(w / sw), -127, 127).astype(np.int32)
    ref = (xq @ wq).astype(np.float32) * (sx * sw) + b
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    exact = x @ w + b
    assert (np.abs(got.numpy() - exact).max() / np.abs(exact).max()) < 0.02
    # leading dims and the default out dtype, as in the JAX function
    got3 = tq.dense_w8a8(_t(x).view(4, 4, 24), _t(w.T), _t(b))
    assert got3.shape == (4, 4, 40) and got3.dtype == torch.float32


def _block_inputs(T, H, F, seed):
    rng = np.random.RandomState(seed)
    f = np.float32
    return dict(
        r=rng.randn(T, H).astype(f),
        s1=(1 + 0.1 * rng.randn(H)).astype(f), c1=(0.1 * rng.randn(H)).astype(f),
        w1=(0.1 * rng.randn(H, F)).astype(f), b1=(0.1 * rng.randn(F)).astype(f),
        w2=(0.1 * rng.randn(F, H)).astype(f), b2=(0.1 * rng.randn(H)).astype(f),
        s2=(1 + 0.1 * rng.randn(H)).astype(f), c2=(0.1 * rng.randn(H)).astype(f),
    )


def test_plain_k7_matches_pallas_kernel():
    """T = 32, H = 128, F = 256, float32 r. The port's plain version on
    the JAX package's quantized weights against the Pallas kernel in
    interpret mode. Tolerance 2e-5: LayerNorm statistics and float32 sums
    in another order, and the kernel's A&S erf polynomial (|error| <=
    1.5e-7) against erf; a quantized value that moved by one would show as
    an error of ~1e-3."""
    x = _block_inputs(32, 128, 256, seed=0)
    w1q, sw1 = jq.quantize_cols(jnp.asarray(x["w1"]))
    w2q, sw2 = jq.quantize_cols(jnp.asarray(x["w2"]))
    want = jax_kernel(jnp.asarray(x["r"]), jnp.asarray(x["s1"]),
                      jnp.asarray(x["c1"]), w1q, sw1[0], jnp.asarray(x["b1"]),
                      w2q, sw2[0], jnp.asarray(x["b2"]), jnp.asarray(x["s2"]),
                      jnp.asarray(x["c2"]), token_tile=16, interpret=True)
    got = tffn.ffn_block_int8_reference(
        _t(x["r"]), _t(x["s1"]), _t(x["c1"]), _t(np.asarray(w1q).T),
        _t(np.asarray(sw1)[0]), _t(x["b1"]), _t(np.asarray(w2q).T),
        _t(np.asarray(sw2)[0]), _t(x["b2"]), _t(x["s2"]), _t(x["c2"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_dispatcher_matches_jax_dispatcher_and_counts_nothing_on_cpu():
    """ffn_block_int8 from float weights (nn.Linear layout) against the JAX
    dispatcher, which off the TPU runs dense_w8a8 twice and adds the bias
    before the residual (u32 + (y + b2), where the TPU kernel and the port
    take (u32 + y) + b2). Tolerance 2e-5 as above."""
    x = _block_inputs(20, 32, 64, seed=1)
    want = jax_ffn_block_int8(*(jnp.asarray(x[k]) for k in
                                ("r", "s1", "c1", "w1", "b1", "w2", "b2",
                                 "s2", "c2")), "gelu", 1e-12)
    before = tffn.fused_ffn_block_int8.launches
    got = tffn.ffn_block_int8(_t(x["r"]), _t(x["s1"]), _t(x["c1"]),
                              _t(x["w1"].T), _t(x["b1"]), _t(x["w2"].T),
                              _t(x["b2"]), _t(x["s2"]), _t(x["c2"]))
    assert tffn.fused_ffn_block_int8.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def _towers(int8: bool, seed=0):
    """The JAX tower (float or int8) with its flax params, and the port's
    tower on the same weights."""
    jcfg = dataclasses.replace(JaxBertConfig(**TINY), matmul_int8=int8)
    jmodel = jax_build("rdot_nll_condenser", jcfg)
    ids = jnp.ones((1, 16), jnp.int32)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(seed), ids,
                                        ids)["params"])
    cfg = MODEL_REGISTRY["rdot_nll_condenser"](
        BertConfig(**TINY, matmul_int8=int8))
    model = DualEncoder(cfg).eval()
    model.load_state_dict(convert.params_from_jax(params, cfg))
    return jmodel, params, model


def _emb(model, ids, mask, tower="body_emb"):
    with torch.inference_mode():
        return getattr(model, tower)(_t(ids), _t(mask)).numpy()


def test_int8_tower_matches_jax_int8_tower():
    """Same flax params through both int8 towers. Tolerance 2e-5: float32
    sums and LayerNorm statistics in another order (observed ~5e-7); an
    activation that moved by one quantization step would show as ~1e-3."""
    jmodel, params, model = _towers(int8=True)
    rng = np.random.RandomState(0)
    ids = rng.randint(5, 128, (6, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[2, 9:] = 0
    want = jmodel.apply({"params": params}, jnp.asarray(ids),
                        jnp.asarray(mask), method="body_emb")
    np.testing.assert_allclose(_emb(model, ids, mask), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def test_int8_encoder_same_param_tree_and_close_embeddings():
    """tests/test_int8_encode.py:50 through the port: the int8 and float
    towers take the same state dict (and so the same flax tree), and their
    embeddings agree to cosine > 0.99."""
    _, params, model = _towers(int8=False)
    cfg8 = MODEL_REGISTRY["rdot_nll_condenser"](
        BertConfig(**TINY, matmul_int8=True))
    model8 = DualEncoder(cfg8).eval()
    assert ({k: v.shape for k, v in model8.state_dict().items()}
            == {k: v.shape for k, v in model.state_dict().items()})
    model8.load_state_dict(convert.params_from_jax(params, cfg8))
    ids = np.random.RandomState(0).randint(5, 128, (4, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    e, e8 = _emb(model, ids, mask), _emb(model8, ids, mask)
    cos = np.sum(e * e8, 1) / (np.linalg.norm(e, axis=1)
                               * np.linalg.norm(e8, axis=1) + 1e-9)
    assert cos.min() > 0.99, cos


def test_int8_encoder_ranking_agreement_small():
    """tests/test_int8_encode.py:74 through the port: top-10 overlap of
    int8 and float rankings >= 0.9 on a synthetic corpus."""
    _, params, model = _towers(int8=False)
    cfg8 = MODEL_REGISTRY["rdot_nll_condenser"](
        BertConfig(**TINY, matmul_int8=True))
    model8 = DualEncoder(cfg8).eval()
    model8.load_state_dict(convert.params_from_jax(params, cfg8))
    rng = np.random.RandomState(1)
    ids = rng.randint(5, 128, (64, 16)).astype(np.int32)
    q_ids = rng.randint(5, 128, (8, 12)).astype(np.int32)
    ones, q_ones = np.ones_like(ids), np.ones_like(q_ids)
    docs, docs8 = _emb(model, ids, ones), _emb(model8, ids, ones)
    q = _emb(model, q_ids, q_ones, "query_emb")
    q8 = _emb(model8, q_ids, q_ones, "query_emb")
    top = np.argsort(-(q @ docs.T), axis=1)[:, :10]
    top8 = np.argsort(-(q8 @ docs8.T), axis=1)[:, :10]
    overlap = np.mean([len(np.intersect1d(a, b)) / 10
                       for a, b in zip(top, top8)])
    assert overlap >= 0.9, overlap


def test_int8_weights_stay_float32_when_cast():
    """cast_matmul_weights keeps a matmul_int8 layer's FFN weights float32
    (the JAX package quantizes float32 weights), and the guard matters:
    quantizing the bf16-rounded weights gives other int8 values and
    scales."""
    _, _, model = _towers(int8=True)
    w = model.encoder.encoder.layer[0].intermediate.dense.weight.detach()
    w = w.clone()
    cast_matmul_weights(model, torch.bfloat16)
    layer = model.encoder.encoder.layer[0]
    assert layer.intermediate.dense.weight.dtype == torch.float32
    assert layer.output.dense.bias.dtype == torch.float32
    assert layer.attention.self.query.weight.dtype == torch.bfloat16
    assert torch.equal(layer.intermediate.dense.weight, w)
    q32, s32 = tq.quantize_cols(w)
    q16, s16 = tq.quantize_cols(w.to(torch.bfloat16))
    assert not torch.equal(s32, s16)
    assert not torch.equal(q32, q16)


def _k7_variant(variant, r, s1, c1, w1, b1, w2, b2, s2, c2):
    """K7's function with its float sums in float64 (another order, the
    same quantization points), or with one quantization point moved."""
    dt = torch.float64 if variant == "sum_order" else torch.float32
    w1q, sw1 = tq.quantize_cols(w1)
    w2q, sw2 = tq.quantize_cols(w2)
    u32 = tffn.layer_norm_f32(r.float().to(dt), s1.to(dt), c1.to(dt), 1e-12)

    def product(x, wq, sw, w):
        if variant == "bf16_weights":
            return x.to(torch.bfloat16).to(dt) @ w.to(torch.bfloat16).to(dt).t()
        if variant == "unquantized" and wq is w2q:
            return x @ (wq.to(dt) * sw.to(dt)).t()
        xq, sx = tq.quantize_rows(x)
        return tq.int8_matmul(xq, wq).to(dt) * (sx.to(dt) * sw.to(dt).t())

    h = tffn.activation("gelu")(product(u32, w1q, sw1, w1) + b1.to(dt))
    z = u32 + product(h, w2q, sw2, w2) + b2.to(dt)
    return tffn.layer_norm_f32(z, s2.to(dt), c2.to(dt), 1e-12).to(r.dtype)


@pytest.mark.parametrize("variant", ["sum_order", "unquantized",
                                     "bf16_weights"])
def test_k7_share_limit_separates_quantization_points(variant):
    """chip_smoke.py holds K7 to its plain version by two bounds: two bf16
    ulps of the largest output, and at most 1% of outputs differing at
    all. Here, at bert-base widths (T = 128, bf16 r), float sums taken in
    another order (float64) stay under 1%, while a kernel that skipped the
    re-quantization of h, or multiplied by bf16 weights in place of the
    int8 ones, moves more than 10% of the outputs although it stays inside
    the max-abs bound."""
    rng = np.random.RandomState(0)
    H, F, T = 768, 3072, 128
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    r = t(rng.randn(T, H)).to(torch.bfloat16)
    s1, c1 = t(1 + 0.1 * rng.randn(H)), t(0.1 * rng.randn(H))
    w1, b1 = t(0.02 * rng.randn(F, H)), t(0.02 * rng.randn(F))
    w2, b2 = t(0.02 * rng.randn(H, F)), t(0.02 * rng.randn(H))
    s2, c2 = t(1 + 0.1 * rng.randn(H)), t(0.1 * rng.randn(H))
    args = (r, s1, c1, w1, b1, w2, b2, s2, c2)
    ref = tffn.ffn_block_int8(*args).float()
    diff = (_k7_variant(variant, *args).float() - ref).abs()
    share = (diff > 0).float().mean().item()
    assert diff.max().item() <= 2.0 ** -6 * ref.abs().max().item()
    if variant == "sum_order":
        assert share < 0.01
    else:
        assert share > 0.10
