"""K1 (fused FFN half-layer) and K5 (the FFN of the dropout path): the
port's plain versions against the JAX package's Pallas kernels in
interpret mode and its XLA references, and the gradients of the port's
`ffn_block` and `ffn` against jax.grad of the JAX dispatchers, on the same
numpy inputs."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.ops import pallas_ffn
from cocodr_tpu.ops.pallas_ffn import _xla_ffn_block, fused_ffn_block
from cocodr_tpu_torch.ops import ffn as tffn

torch.set_num_threads(1)

H, F = 32, 128


def _inputs(T, seed=0):
    rng = np.random.RandomState(seed)
    f = np.float32
    return dict(
        r=rng.randn(T, H).astype(f),
        s1=(1 + 0.1 * rng.randn(H)).astype(f), c1=(0.1 * rng.randn(H)).astype(f),
        w1=(0.1 * rng.randn(H, F)).astype(f), b1=(0.1 * rng.randn(F)).astype(f),
        w2=(0.1 * rng.randn(F, H)).astype(f), b2=(0.1 * rng.randn(H)).astype(f),
        s2=(1 + 0.1 * rng.randn(H)).astype(f), c2=(0.1 * rng.randn(H)).astype(f),
    )


def _jax_args(x, dt):
    return (jnp.asarray(x["r"], dt), jnp.asarray(x["s1"]), jnp.asarray(x["c1"]),
            jnp.asarray(x["w1"], dt), jnp.asarray(x["b1"], dt),
            jnp.asarray(x["w2"], dt), jnp.asarray(x["b2"], dt),
            jnp.asarray(x["s2"]), jnp.asarray(x["c2"]))


def _torch_args(x, dt):
    """Same inputs for the port: weights in nn.Linear layout [out, in]."""
    t = torch.from_numpy
    return (t(x["r"]).to(dt), t(x["s1"]), t(x["c1"]),
            t(x["w1"].T.copy()).to(dt), t(x["b1"]).to(dt),
            t(x["w2"].T.copy()).to(dt), t(x["b2"]).to(dt),
            t(x["s2"]), t(x["c2"]))


@pytest.mark.parametrize("T", [37, 64])
@pytest.mark.parametrize("act", ["gelu", "gelu_new", "relu"])
def test_plain_matches_pallas_kernel_f32(T, act):
    """f32, ragged and aligned T. Tolerance 2e-5: float32 sums in another
    order, and the Pallas kernel's GELU uses the A&S erf polynomial
    (|error| <= 1.5e-7) where the port uses erf."""
    x = _inputs(T)
    want = fused_ffn_block(*_jax_args(x, jnp.float32), act=act, token_tile=16,
                           interpret=True)
    got = tffn.ffn_block_reference(*_torch_args(x, torch.float32), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("T", [37, 64])
def test_plain_matches_pallas_kernel_bf16(T):
    """bf16, ragged T. Tolerance: one bf16 ulp of the output (2^-7
    relative; |out| < 8 here), for a rounding of h or out that lands on the
    other side of a bf16 boundary."""
    x = _inputs(T, seed=1)
    want = fused_ffn_block(*_jax_args(x, jnp.bfloat16), token_tile=16,
                           interpret=True)
    got = tffn.ffn_block_reference(*_torch_args(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 ** -7 * 8,
                               rtol=0)
    # nearly all elements agree exactly
    assert np.mean(got.float().numpy() != want) < 0.01


def test_plain_matches_xla_reference_f32():
    """In float32 the f32-residual kernel and the bf16-residual XLA
    sequence compute the same function. Tolerance 2e-5."""
    x = _inputs(50, seed=2)
    want = _xla_ffn_block(*_jax_args(x, jnp.float32), act="gelu", eps=1e-12)
    got = tffn.ffn_block_reference(*_torch_args(x, torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_wrapper_on_cpu_takes_plain_version_and_counts_nothing():
    """ffn_block (K1's autograd.Function) and ffn (K5's) take the plain
    versions on CPU tensors, with and without gradients, and launch
    nothing."""
    x = _inputs(20, seed=3)
    args = _torch_args(x, torch.float32)
    before = (tffn.fused_ffn_block.launches, tffn.fused_ffn.launches)
    out = tffn.ffn_block(*args)
    assert torch.equal(out, tffn.ffn_block_reference(*args))
    assert torch.equal(tffn.fused_ffn_block(*args), out)
    w = [a.clone().requires_grad_() for a in args]
    tffn.ffn_block(*w).sum().backward()
    assert all(a.grad is not None for a in w)
    k5 = (args[0], args[3], args[4], args[5], args[6])
    assert torch.equal(tffn.ffn(*k5), tffn.ffn_reference(*k5))
    assert torch.equal(tffn.fused_ffn(*k5), tffn.ffn_reference(*k5))
    assert (tffn.fused_ffn_block.launches, tffn.fused_ffn.launches) == before


def test_residual_is_float32():
    """The residual into LN2 is LN1's float32 output: in bf16 the result
    differs from a variant that adds the bf16-rounded u."""
    x = _inputs(64, seed=4)
    args = _torch_args(x, torch.bfloat16)
    r, s1, c1, w1, b1, w2, b2, s2, c2 = args
    u32 = tffn.layer_norm_f32(r.float(), s1, c1, 1e-12)
    u = u32.to(torch.bfloat16)
    h = tffn.activation("gelu")(u.float() @ w1.float().t() + b1.float())
    y = h.to(torch.bfloat16).float() @ w2.float().t()
    bf16_res = tffn.layer_norm_f32(u.float() + y + b2.float(), s2, c2,
                                   1e-12).to(torch.bfloat16)
    f32_res = tffn.ffn_block_reference(*args)
    assert not torch.equal(f32_res, bf16_res)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_chunked_kernel_at_bert_large_widths(dtype):
    """K4: the JAX package streams bert-large's FFN weights through VMEM
    in F chunks (`fused_ffn_block` with f_chunks > 1, the chunked Pallas
    kernel); the port's K1 takes H = 1024, F = 4096 whole. T = 16, weights
    at BERT's init scale (std 0.02). The chunked kernel sums
    (u32 + b2) + y_0 + y_1 where K1 sums (u32 + y) + b2. Tolerance:
    float32, 2e-5 for sums in another order and the A&S erf polynomial;
    bf16, one bf16 ulp of the output (2^-7 relative, |out| < 8), for a
    rounding of h or out on the other side of a bf16 boundary."""
    H_L, F_L = 1024, 4096
    rng = np.random.RandomState(5)
    f = np.float32
    x = dict(
        r=rng.randn(16, H_L).astype(f),
        s1=(1 + 0.1 * rng.randn(H_L)).astype(f),
        c1=(0.1 * rng.randn(H_L)).astype(f),
        w1=(0.02 * rng.randn(H_L, F_L)).astype(f),
        b1=(0.02 * rng.randn(F_L)).astype(f),
        w2=(0.02 * rng.randn(F_L, H_L)).astype(f),
        b2=(0.02 * rng.randn(H_L)).astype(f),
        s2=(1 + 0.1 * rng.randn(H_L)).astype(f),
        c2=(0.1 * rng.randn(H_L)).astype(f),
    )
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = fused_ffn_block(*_jax_args(x, jdt), token_tile=16, f_chunks=2,
                           interpret=True)
    want = np.asarray(want, np.float32)
    got = tffn.ffn_block_reference(*_torch_args(x, tdt)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:
        np.testing.assert_allclose(got, want, atol=2 ** -7 * 8, rtol=0)
        assert np.mean(got != want) < 0.01


def _bert_base_block(T=128, seed=0):
    """r [T, 768] and a half-layer's weights at BERT's init scale (std
    0.02), float32, in nn.Linear layout."""
    rng = np.random.RandomState(seed)
    H_, F_ = 768, 3072
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    return (t(rng.randn(T, H_)), t(1 + 0.1 * rng.randn(H_)),
            t(0.1 * rng.randn(H_)), t(0.02 * rng.randn(F_, H_)),
            t(0.02 * rng.randn(F_)), t(0.02 * rng.randn(H_, F_)),
            t(0.02 * rng.randn(H_)), t(1 + 0.1 * rng.randn(H_)),
            t(0.1 * rng.randn(H_)))


def _k1_variant(variant, r, s1, c1, w1, b1, w2, b2, s2, c2):
    """K1's function with its sums in float64 (another order, the same
    rounding points), or with one rounding point moved."""
    bf = torch.bfloat16
    dt = torch.float64 if variant == "sum_order" else torch.float32
    u32 = tffn.layer_norm_f32(r.float().to(dt), s1.to(dt), c1.to(dt), 1e-12)
    u = u32 if variant == "u_unrounded" else u32.to(bf).to(dt)
    h = tffn.activation("gelu")(u @ w1.to(dt).t() + b1.to(dt))
    h = h if variant == "h_unrounded" else h.to(bf).to(dt)
    res = u32.to(bf).to(dt) if variant == "residual_rounded" else u32
    z = res + h @ w2.to(dt).t() + b2.to(dt)
    return tffn.layer_norm_f32(z, s2.to(dt), c2.to(dt), 1e-12).to(bf)


@pytest.mark.parametrize("variant", ["sum_order", "h_unrounded",
                                     "u_unrounded", "residual_rounded"])
def test_k1_share_limit_separates_rounding_points(variant):
    """chip_smoke.py holds K1 to its plain version by two bounds: two bf16
    ulps of the largest output, and at most 5% of outputs differing at
    all. Here, at bert-base widths (T = 128, bf16), sums taken in another
    order (float64) stay under 5%, while a kernel that moved one rounding
    point (h or u left in float32, or a bf16 residual) moves more than 10%
    of the outputs although it stays inside the max-abs bound."""
    x = _bert_base_block()
    bf = torch.bfloat16
    args = (x[0].to(bf), x[1], x[2], x[3].to(bf), x[4].to(bf), x[5].to(bf),
            x[6].to(bf), x[7], x[8])
    ref = tffn.ffn_block_reference(*args).float()
    diff = (_k1_variant(variant, *args).float() - ref).abs()
    share = (diff > 0).float().mean().item()
    assert diff.max().item() <= 2.0 ** -6 * ref.abs().max().item()
    if variant == "sum_order":
        assert share < 0.05
    else:
        assert share > 0.10


# --- K5 --------------------------------------------------------------------

def _k5_inputs(T, seed=0):
    """x [T, H] and the FFN weights in the JAX layout (w1 [H, F], w2
    [F, H]), float32 numpy."""
    rng = np.random.RandomState(seed)
    f = np.float32
    return dict(x=rng.randn(T, H).astype(f),
                w1=(0.1 * rng.randn(H, F)).astype(f),
                b1=(0.1 * rng.randn(F)).astype(f),
                w2=(0.1 * rng.randn(F, H)).astype(f),
                b2=(0.1 * rng.randn(H)).astype(f))


def _k5_jax(x, dt):
    return tuple(jnp.asarray(x[k], dt) for k in ("x", "w1", "b1", "w2", "b2"))


def _k5_torch(x, dt):
    t = torch.from_numpy
    return (t(x["x"]).to(dt), t(x["w1"].T.copy()).to(dt), t(x["b1"]).to(dt),
            t(x["w2"].T.copy()).to(dt), t(x["b2"]).to(dt))


@pytest.mark.parametrize("act", ["gelu", "gelu_new", "relu"])
def test_k5_plain_matches_pallas_kernel_f32(act):
    """float32, T = 37 (the Pallas kernel pads it to its token tile).
    Tolerance 2e-5: float32 sums in another order, and the Pallas GELU's
    A&S erf polynomial (|error| <= 1.5e-7) against erf."""
    x = _k5_inputs(37)
    want = pallas_ffn.fused_ffn(*_k5_jax(x, jnp.float32), act=act,
                                token_tile=16, interpret=True)
    got = tffn.ffn_reference(*_k5_torch(x, torch.float32), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("act", ["gelu", "gelu_new", "relu"])
def test_k5_plain_matches_pallas_kernel_bf16(act):
    """bf16, T = 37. Tolerance: one bf16 ulp of the output (2^-7 relative
    to max |out|), for a rounding of h or out on the other side of a bf16
    boundary; nearly all elements agree exactly."""
    x = _k5_inputs(37, seed=1)
    want = pallas_ffn.fused_ffn(*_k5_jax(x, jnp.bfloat16), act=act,
                                token_tile=16, interpret=True)
    got = tffn.ffn_reference(*_k5_torch(x, torch.bfloat16), act=act)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=2 ** -7 * np.abs(want).max(),
                               rtol=0)
    assert np.mean(got != want) < 0.02


def test_k5_plain_is_not_the_xla_pair_in_bf16():
    """K5 rounds h once after a float32 activation; the XLA pair
    (`xla_ffn`, whose gradient `ffn` returns) rounds the products and the
    pre-activation to bf16. They agree in float32 (2e-5) and differ in
    bf16."""
    x = _k5_inputs(64, seed=2)
    f32 = _k5_torch(x, torch.float32)
    np.testing.assert_allclose(tffn.ffn_reference(*f32).numpy(),
                               tffn.xla_ffn(*f32).numpy(), atol=2e-5,
                               rtol=2e-5)
    bf = _k5_torch(x, torch.bfloat16)
    assert not torch.equal(tffn.ffn_reference(*bf), tffn.xla_ffn(*bf))


def _k5_variant(variant, x, w1, b1, w2, b2):
    """K5's function with its sums in float64 (another order, the same
    rounding points), or with one rounding point moved."""
    bf = torch.bfloat16
    dt = torch.float64 if variant == "sum_order" else torch.float32
    pre = x.to(dt) @ w1.to(dt).t() + b1.to(dt)
    if variant == "preact_rounded":
        pre = pre.to(bf).to(dt)
    h = tffn.activation("gelu")(pre)
    h = h if variant == "h_unrounded" else h.to(bf).to(dt)
    y = h @ w2.to(dt).t()
    if variant == "y_rounded":
        y = y.to(bf).to(dt)
    return (y + b2.to(dt)).to(bf)


@pytest.mark.parametrize("variant", ["sum_order", "h_unrounded",
                                     "preact_rounded", "y_rounded"])
def test_k5_share_limit_separates_rounding_points(variant):
    """chip_smoke.py holds K5 to its plain version by two bounds: two bf16
    ulps of the largest output, and at most 5% of outputs differing at
    all. Here, at bert-base widths (T = 128, bf16, weights at BERT's init
    scale), sums taken in another order (float64) stay under 5%, while a
    kernel that moved one rounding point (h left in float32, the
    pre-activation rounded to bf16, or y rounded before b2) moves more
    than 20% of the outputs although it stays inside the max-abs bound."""
    rng = np.random.RandomState(6)
    H_, F_ = 768, 3072
    bf = torch.bfloat16
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(bf)  # noqa: E731
    args = (t(rng.randn(128, H_)), t(0.02 * rng.randn(F_, H_)),
            t(0.02 * rng.randn(F_)), t(0.02 * rng.randn(H_, F_)),
            t(0.02 * rng.randn(H_)))
    ref = tffn.ffn_reference(*args).float()
    diff = (_k5_variant(variant, *args).float() - ref).abs()
    share = (diff > 0).float().mean().item()
    assert diff.max().item() <= 2.0 ** -6 * ref.abs().max().item()
    if variant == "sum_order":
        assert share < 0.05
    else:
        assert share > 0.20


def _grad_pair(jax_fn, port_fn, jax_args, port_args, ct):
    """Gradients of sum(out * ct) through both packages."""
    def loss(*a):
        return jnp.sum(jax_fn(*a) * jnp.asarray(ct))
    want = jax.grad(loss, argnums=tuple(range(len(jax_args))))(*jax_args)
    leaves = [a.clone().requires_grad_() for a in port_args]
    (port_fn(*leaves) * torch.from_numpy(ct)).sum().backward()
    return [np.asarray(w) for w in want], [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_ffn_grads_match_jax_dispatcher(act):
    """K5's autograd.Function: gradients for x, w1, b1, w2, b2 against
    jax.grad of pallas_ffn.ffn (a custom_vjp whose backward is _xla_ffn's).
    float32, tolerance 1e-5."""
    x = _k5_inputs(24, seed=3)
    ct = np.random.RandomState(7).randn(24, H).astype(np.float32)
    want, got = _grad_pair(
        lambda *a: pallas_ffn.ffn(*a, act),
        lambda *a: tffn.ffn(*a, act),
        _k5_jax(x, jnp.float32), _k5_torch(x, torch.float32), ct)
    for name, w, g in zip(("x", "w1", "b1", "w2", "b2"), want, got):
        if g.ndim == 2 and name != "x":
            g = g.T  # nn.Linear layout
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=name)


def test_ffn_block_grads_match_jax_dispatcher():
    """K1's autograd.Function: gradients for r, both LayerNorms, both
    weights and biases against jax.grad of pallas_ffn.ffn_block (a
    custom_vjp whose backward is _xla_ffn_block's). float32, tolerance
    1e-5."""
    x = _inputs(24, seed=8)
    ct = np.random.RandomState(9).randn(24, H).astype(np.float32)
    want, got = _grad_pair(
        lambda *a: pallas_ffn.ffn_block(*a, "gelu", 1e-12),
        lambda *a: tffn.ffn_block(*a, "gelu", 1e-12),
        _jax_args(x, jnp.float32), _torch_args(x, torch.float32), ct)
    names = ("r", "s1", "c1", "w1", "b1", "w2", "b2", "s2", "c2")
    for name, w, g in zip(names, want, got):
        if name in ("w1", "w2"):
            g = g.T
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=name)


def test_backward_differentiates_the_xla_formulation_in_bf16():
    """In bf16 the forward is K5's plain version and the gradient that of
    the XLA pair: the recomputed pair's own gradient, bit for bit."""
    x = _k5_inputs(32, seed=4)
    args = _k5_torch(x, torch.bfloat16)
    ct = torch.from_numpy(np.random.RandomState(5).randn(32, H)
                          .astype(np.float32)).to(torch.bfloat16)
    a = [t.clone().requires_grad_() for t in args]
    b = [t.clone().requires_grad_() for t in args]
    out = tffn.ffn(*a)
    assert torch.equal(out, tffn.ffn_reference(*args))
    (out * ct).sum().backward()
    (tffn.xla_ffn(*b) * ct).sum().backward()
    for ga, gb in zip(a, b):
        assert torch.equal(ga.grad, gb.grad)
