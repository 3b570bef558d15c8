"""K1 (fused FFN half-layer): the port's plain version against the JAX
package's Pallas kernel in interpret mode and its XLA reference, on the
same numpy inputs."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

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
    x = _inputs(20, seed=3)
    args = _torch_args(x, torch.float32)
    before = tffn.fused_ffn_block.launches
    out = tffn.ffn_block(*args)
    assert tffn.ffn_block is tffn.fused_ffn_block
    assert torch.equal(out, tffn.ffn_block_reference(*args))
    assert tffn.fused_ffn_block.launches == before


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
