"""K8 (fused seq-major attention): the port's plain version against the
JAX package's Pallas kernel in interpret mode, and the port's BERT with
attention_impl="fused" against the flax model with the same setting, on
the same numpy inputs and weights."""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import jax
import torch

from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.bert import BertModel as JaxBertModel
from cocodr_tpu.ops.pallas_attention import attention as jax_attention
from cocodr_tpu.ops.pallas_attention import fused_attention_seq_major as jax_k8
from cocodr_tpu_torch.models import bert as tbert
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig, BertModel
from cocodr_tpu_torch.ops import attention as tatt

torch.set_num_threads(1)


def _qkv(B=4, S=16, N=2, D=8, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, S, N, D).astype(np.float32) for _ in range(3))
    lens = [S, S - 4, 5, 1][:B]  # padded keys in three batch elements
    bias = np.where(np.arange(S)[None, :] < np.array(lens)[:, None], 0.0,
                    -1e9).astype(np.float32)
    return q, k, v, bias


def test_plain_k8_matches_pallas_kernel_f32():
    """float32 q, k, v with a padding bias. Tolerance 1e-5: float32 sums
    and the softmax's sum in another order."""
    q, k, v, bias = _qkv()
    want = jax_k8(*(jnp.asarray(a) for a in (q, k, v, bias)), 0.3,
                  interpret=True)
    got = tatt.attention_reference(*(torch.from_numpy(a)
                                     for a in (q, k, v, bias)), 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_plain_k8_matches_pallas_kernel_bf16():
    """bf16 q, k, v: both round the normalised probabilities and the
    output to bf16. Tolerance: one bf16 ulp of the output (2^-8 relative
    to |out| <= 4 here) plus one ulp of a probability times max |v|, for
    a rounding that lands on the other side of a bf16 boundary; nearly all
    elements agree exactly."""
    q, k, v, bias = _qkv(B=4, S=24, N=3, D=16, seed=1)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jax_k8(*jb, jnp.asarray(bias), 0.25, interpret=True),
                      np.float32)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = tatt.attention_reference(*tb, torch.from_numpy(bias), 0.25)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    tol = 2.0 ** -8 * np.abs(want).max() + 2.0 ** -8 * np.abs(v).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert np.mean(got != want) < 0.02


def test_wrapper_on_cpu_takes_plain_version_and_counts_nothing():
    q, k, v, bias = (torch.from_numpy(a) for a in _qkv(seed=2))
    before = tatt.fused_attention_seq_major.launches
    out = tatt.fused_attention_seq_major(q, k, v, bias, 0.5)
    assert torch.equal(out, tatt.attention_reference(q, k, v, bias, 0.5))
    assert tatt.fused_attention_seq_major.launches == before


def test_fused_normalises_before_pv():
    """The rounding point of the TPU kernel: in bf16 the fused attention
    differs from the einsum path's deferred division."""
    cfg = BertConfig.tiny(dtype=torch.bfloat16)
    cfg_f = dataclasses.replace(cfg, attention_impl="fused")
    torch.manual_seed(0)
    model = BertModel(cfg).eval()
    model_f = BertModel(cfg_f).eval()
    model_f.load_state_dict(model.state_dict())
    ids = torch.randint(5, 128, (3, 16))
    with torch.inference_mode():
        a, b = model(ids), model_f(ids)
    assert not torch.equal(a, b)
    assert (a.float() - b.float()).abs().max() < 0.1


def _flax(cfg_kw, S, seed=0):
    jcfg = dataclasses.replace(JaxBertConfig.tiny(), intermediate_size=128,
                               **cfg_kw)
    jmodel = JaxBertModel(jcfg)
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, 128, (3, S)).astype(np.int32)
    mask = np.ones((3, S), np.int32)
    mask[1, S // 2:] = 0
    mask[2, 3:] = 0
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(seed),
                                        jnp.asarray(ids),
                                        jnp.asarray(mask))["params"])
    want, _, _ = jmodel.apply({"params": params}, jnp.asarray(ids),
                              jnp.asarray(mask))
    return params, ids, mask, np.asarray(want)


@pytest.mark.parametrize("S", [16, 12])
def test_bert_fused_attention_matches_flax(S):
    """float32, attention_impl="fused" in both packages. S = 16 takes K8
    (the JAX package's XLA formulation of it off the TPU, with the same
    rounding points); S = 12 is not a multiple of 8 and takes the einsum
    path in both. Tolerance 2e-5: float32 sums in another order."""
    params, ids, mask, want = _flax({"attention_impl": "fused"}, S)
    cfg = BertConfig.tiny(intermediate_size=128, attention_impl="fused")
    model = BertModel(cfg).eval()
    model.load_state_dict(convert.bert_state_dict_from_jax(params, cfg))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_attention_impl_is_validated():
    with pytest.raises(ValueError, match="attention_impl"):
        BertConfig.tiny(attention_impl="flash")


def _k8_variant(variant, q, k, v, bias, scale):
    """K8's function with its sums in float64 (another order, the same
    rounding points), or with the normalisation or the probabilities'
    rounding moved."""
    dt = torch.float64 if variant == "sum_order" else torch.float32
    s = (torch.einsum("bqnd,bknd->bnqk", q.to(dt), k.to(dt)) * scale
         + bias.to(dt)[:, None, None, :])
    e = torch.exp(s - s.amax(-1, keepdim=True))
    total = e.sum(-1, keepdim=True)
    if variant == "normalised_after_pv":  # an online softmax's order
        ctx = torch.einsum("bnqk,bknd->bnqd", e.to(q.dtype).to(dt), v.to(dt))
        return (ctx / total).permute(0, 2, 1, 3).to(q.dtype)
    probs = e / total
    if variant != "float32_probs":
        probs = probs.to(q.dtype).to(dt)
    return torch.einsum("bnqk,bknd->bqnd", probs, v.to(dt)).to(q.dtype)


@pytest.mark.parametrize("variant", ["sum_order", "normalised_after_pv",
                                     "float32_probs"])
def test_k8_share_limit_separates_rounding_points(variant):
    """chip_smoke.py holds K8 to its plain version by two bounds: one bf16
    ulp of the output plus one of a probability times max |v|, and at most
    1% of outputs differing at all. Here, at the encode path's S = 128,
    N = 12, D = 64 (B = 16, bf16, padding bias), sums taken in another
    order (float64) stay under 1%, while a softmax normalised after the PV
    product, or probabilities left in float32, move more than 10% of the
    outputs although they stay inside the max-abs bound."""
    rng = np.random.RandomState(0)
    B, S, N, D = 16, 128, 12, 64
    q, k, v = (torch.from_numpy(rng.randn(B, S, N, D).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    lens = rng.randint(16, S + 1, B)
    bias = torch.from_numpy(np.where(np.arange(S)[None, :] < lens[:, None],
                                     0.0, -1e9).astype(np.float32))
    ref = tatt.attention_reference(q, k, v, bias, 0.125).float()
    diff = (_k8_variant(variant, q, k, v, bias, 0.125).float() - ref).abs()
    share = (diff > 0).float().mean().item()
    tol = 2.0 ** -8 * (ref.abs().max().item() + v.float().abs().max().item())
    assert diff.max().item() <= tol
    if variant == "sum_order":
        assert share < 0.01
    else:
        assert share > 0.10


def test_attention_grads_match_jax_dispatcher():
    """K8's autograd.Function: gradients for q, k, v against jax.grad of
    pallas_attention.attention (a custom_vjp whose backward is the einsum
    formulation's), and a zero bias gradient, as there. float32 with a
    padding bias, tolerance 1e-5."""
    q, k, v, bias = _qkv(B=3, S=16, N=2, D=8, seed=5)
    ct = np.random.RandomState(6).randn(*q.shape).astype(np.float32)

    def loss(q, k, v, bias):
        return jnp.sum(jax_attention(q, k, v, bias, 0.35) * ct)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (q, k, v, bias)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    out = tatt.attention(*leaves, 0.35)
    assert torch.equal(out.detach(), tatt.attention_reference(
        *(t.detach() for t in leaves), 0.35))
    (out * torch.from_numpy(ct)).sum().backward()
    for name, w, t in zip("qkv", want, leaves):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    assert not np.asarray(want[3]).any()
    assert torch.equal(leaves[3].grad, torch.zeros_like(leaves[3]))


def test_bert_fused_attention_trains_through_k8_without_attention_dropout(
        monkeypatch):
    """A training-mode BERT with attention_impl="fused" and attention
    dropout 0 takes `attention` (K8's autograd.Function; its plain version
    on the CPU); with attention dropout it keeps the einsum path, as the
    JAX package does. Gradients reach the query projection either way."""
    calls = []
    monkeypatch.setattr(tbert, "attention",
                        lambda *a: calls.append(1) or tatt.attention(*a))
    for p_att, want_calls in ((0.0, 2), (0.1, 0)):
        cfg = BertConfig.tiny(attention_impl="fused", hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=p_att)
        model = BertModel(cfg).train()
        calls.clear()
        out = model(torch.randint(5, 100, (2, 8)),
                    generator=torch.Generator().manual_seed(0))
        out.sum().backward()
        assert len(calls) == want_calls
        g = model.encoder.layer[0].attention.self.query.weight.grad
        assert g is not None and g.abs().sum() > 0


K8_MAX_SHARE = 0.01  # chip_smoke.py's limit on the share of outputs that differ
K8_KEY_TILE = 64  # keys a tile of csrc/attention.cu's two passes holds


def _k8_key_tile_schedule(q, k, v, bias, scale):
    """csrc/attention.cu's order of the softmax at S > 128, emulated in
    torch per row: pass 1 walks key tiles of 64 and keeps each row's running max and a running
    sum of exponentials, rescaled whenever the max moves; pass 2 takes the
    scores again, normalises them by the final max and sum, rounds the
    probabilities to the compute dtype and multiplies them by V in
    float32. With S <= 128 the kernel holds all of a row's scores at once
    and takes the plain sum; the emulation still walks two tiles there."""
    s = (torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
         + bias.float()[:, None, None, :])
    m = torch.full(s.shape[:-1] + (1,), -float("inf"))
    total = torch.zeros_like(m)
    for t0 in range(0, s.shape[-1], K8_KEY_TILE):
        tile = s[..., t0:t0 + K8_KEY_TILE]
        tm = tile.amax(-1, keepdim=True)
        ts = torch.exp(tile - tm).sum(-1, keepdim=True)
        new = torch.maximum(m, tm)
        total = total * torch.exp(m - new) + ts * torch.exp(tm - new)
        m = new
    probs = (torch.exp(s - m) / total).to(q.dtype)
    ctx = torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float())
    return ctx.to(q.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [128, 200, 512])
def test_k8_key_tile_schedule_keeps_the_rounding_point(S, dtype):
    """The kernel's two-pass schedule for S > 128 (one pass at S <= 128)
    against attention_reference and the Pallas kernel in interpret mode,
    B = 2, N = 2, D = 64, with a padding bias. float32: tolerance 1e-5, a
    rescaled sum differs from the plain one only as a reordered sum does.
    bf16: one bf16 ulp of the output plus one of a probability times
    max |v| (a rounding that lands on the other side of a bf16 boundary),
    and the share of outputs that differ at all under chip_smoke.py's
    K8_MAX_SHARE, which a softmax rounded elsewhere exceeds
    (test_k8_share_limit_separates_rounding_points)."""
    rng = np.random.RandomState(S)
    B, N, D = 2, 2, 64
    q, k, v = (rng.randn(B, S, N, D).astype(np.float32) for _ in range(3))
    lens = np.array([S, S - 8 * rng.randint(1, S // 8)])
    bias = np.where(np.arange(S)[None, :] < lens[:, None], 0.0,
                    -1e9).astype(np.float32)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    tbias = torch.from_numpy(bias)
    got = _k8_key_tile_schedule(tq, tk, tv, tbias, 0.125).float()
    ref = tatt.attention_reference(tq, tk, tv, tbias, 0.125).float()
    jdt = getattr(jnp, dtype)
    pallas = torch.from_numpy(np.array(jax_k8(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(bias), 0.125,
        interpret=True), np.float32))
    for want in (ref, pallas):
        diff = (got - want).abs()
        if dtype == "float32":
            assert diff.max().item() <= 1e-5
        else:
            tol = 2.0 ** -8 * (want.abs().max().item()
                               + tv.float().abs().max().item())
            assert diff.max().item() <= tol
            assert (diff > 0).float().mean().item() < K8_MAX_SHARE
