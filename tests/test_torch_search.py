"""K2 pack=True, K6, K9, K10 and the searches built on them (fast, int8,
exact2, flat block-max): the port's plain versions and search functions
against the JAX package's Pallas kernels in interpret mode, on the same
numpy inputs. Mirrors tests/test_pallas_mips.py case for case."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cocodr_tpu.ops.mips import mips_topk as jax_mips_topk
from cocodr_tpu.ops.pallas_mips import (
    _dual_sweep_mixed,
    _int8_sweep,
    _top2_sweep,
    blockmax_sweep_pallas as jax_blockmax_sweep,
    mips_topk_blockmax_pallas as jax_blockmax_pallas,
    mips_topk_exact2 as jax_exact2,
    mips_topk_fast as jax_fast,
    mips_topk_hierarchical as jax_hierarchical,
    mips_topk_int8 as jax_int8,
    quantize_corpus_int8 as jax_quantize,
)
from cocodr_tpu_torch.ops import mips_blockmax, mips_exact2, mips_hier, mips_int8

torch.set_num_threads(1)

# float32 sums of exact bf16 products, taken in another order than XLA's
TOL = 2e-6


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _clear(x, n):
    return (_bits(x) & ~((1 << n) - 1)).view(np.float32)


def _bf16_scores(q, c):
    """The JAX side's scores: bf16 operands, float32 sums."""
    return np.asarray(jnp.matmul(jnp.asarray(q, jnp.bfloat16),
                                 jnp.asarray(c, jnp.bfloat16).T,
                                 preferred_element_type=jnp.float32))


def _assert_packed_equal(got, want, n):
    """Packed floats: values with their n low bits cleared within TOL; the
    packed argmax bits equal."""
    np.testing.assert_allclose(_clear(got, n), _clear(want, n), atol=TOL,
                               rtol=TOL)
    mask = (1 << n) - 1
    np.testing.assert_array_equal(_bits(got) & mask, _bits(want) & mask)


def _np_topk(q, c, k):
    """bf16-consistent reference scores + exact top-k (ties: lowest id),
    as tests/test_pallas_mips.py::_np_topk."""
    s = _bf16_scores(q, c)
    ids = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, ids, axis=1), ids


# --- kernels' plain versions against the Pallas kernels ---------------

def test_dual_sweep_pack_plain_matches_pallas():
    """K2 pack=True: fine maxima with the 3-bit argmax, coarse maxima of
    the packed values (JAX coarse is corpus-major)."""
    rng = np.random.RandomState(0)
    Q, N, D = 12, 512, 16
    q = rng.randn(Q, D).astype(np.float32)
    c = rng.randn(N, D).astype(np.float32)
    fj, cj = _dual_sweep_mixed(jnp.asarray(q), jnp.asarray(c), tile=128,
                               fine=4, coarse=4, q_tile=8, interpret=True,
                               pack=True)
    ft, ct = mips_hier.dual_sweep_reference(_t(q), _t(c), 4, 4, pack=True)
    assert ft.shape == (Q, N // 4) and ct.shape == (Q, N // 16)
    _assert_packed_equal(ft.numpy(), np.asarray(fj), 3)
    _assert_packed_equal(ct.numpy(), np.asarray(cj).T, 3)


def test_int8_sweep_plain_matches_pallas_exactly():
    """K6: integer sums are exact, so both outputs are bit-equal."""
    rng = np.random.RandomState(1)
    Q, N, D = 12, 512, 32
    q = rng.randint(-127, 128, (Q, D)).astype(np.int8)
    c = rng.randint(-127, 128, (N, D)).astype(np.int8)
    c[8:16] = c[8]  # equal rows: the first occurrence wins the argmax
    fj, cj = _int8_sweep(jnp.asarray(q), jnp.asarray(c), tile=128, fine=4,
                         coarse=4, q_tile=8, interpret=True)
    ft, ct = mips_int8.int8_sweep_reference(_t(q), _t(c), 4, 4)
    assert ft.dtype == torch.int32 and ct.dtype == torch.int32
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj).T)


@pytest.mark.parametrize("cb", [16, 64])
def test_top2_sweep_plain_matches_pallas(cb):
    """K9: exact block max, and the second best with the 6-bit argmax."""
    rng = np.random.RandomState(2)
    Q, N, D = 12, 1024, 16
    q = rng.randn(Q, D).astype(np.float32)
    c = rng.randn(N, D).astype(np.float32)
    c[cb:2 * cb] = c[cb + 3]  # a block of equal rows: second == best
    bj, pj = _top2_sweep(jnp.asarray(q), jnp.asarray(c), tile=256, cb=cb,
                         q_tile=8, interpret=True)
    bt, pt = mips_exact2.top2_sweep_reference(_t(q), _t(c), cb)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj)[:, :Q].T,
                               atol=TOL, rtol=TOL)
    _assert_packed_equal(pt.numpy(), np.asarray(pj)[:, :Q].T, 6)
    # block 1 holds equal rows: argmax row 0, second == best
    assert (_bits(pt.numpy())[:, 1] & 63 == 0).all()
    np.testing.assert_array_equal(_clear(pt.numpy()[:, 1], 6),
                                  _clear(bt.numpy()[:, 1], 6))


def test_block_sweep_plain_matches_pallas():
    """K10, as tests/test_pallas_mips.py::test_pallas_sweep_matches_xla."""
    rng = np.random.RandomState(0)
    Q, N, D, L = 16, 512, 32, 8
    q = rng.randn(Q, D).astype(np.float32)
    c = rng.randn(N, D).astype(np.float32)
    bj = jax_blockmax_sweep(jnp.asarray(q), jnp.asarray(c), tile=128,
                            block=L, q_tile=8, interpret=True)
    bt = mips_blockmax.blockmax_sweep_pallas(_t(q), _t(c), tile=128, block=L)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=TOL,
                               rtol=TOL)
    ref = _bf16_scores(q, c).reshape(Q, N // L, L).max(-1)
    np.testing.assert_allclose(bt.numpy(), ref, atol=TOL, rtol=TOL)
    with pytest.raises(ValueError):
        mips_blockmax.blockmax_sweep_pallas(_t(q), _t(c[:500]), tile=128)


@pytest.mark.parametrize("kernel", ["K2pack", "K6", "K9", "K10"])
def test_wrappers_on_cpu_use_plain_versions(kernel):
    """A CPU tensor takes the plain version and counts no launch."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(3, 64, generator=g)
    c = torch.randn(256, 64, generator=g)
    if kernel == "K2pack":
        fn, counter = mips_hier.dual_sweep, "pack_launches"
        got = fn(q, c, pack=True)
        want = mips_hier.dual_sweep_reference(q, c, pack=True)
    elif kernel == "K6":
        fn, counter = mips_int8.int8_sweep, "launches"
        ci8, ds = mips_int8.quantize_corpus_int8(c)
        qi8, _ = mips_int8.quantize_queries(q, ds)
        got = fn(qi8, ci8)
        want = mips_int8.int8_sweep_reference(qi8, ci8)
    elif kernel == "K9":
        fn, counter = mips_exact2.top2_sweep, "launches"
        got = fn(q, c)
        want = mips_exact2.top2_sweep_reference(q, c)
    else:
        fn, counter = mips_blockmax.block_sweep, "launches"
        got = (fn(q, c),)
        want = (mips_blockmax.block_sweep_reference(q, c),)
    assert getattr(fn, counter) == 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# --- fast search ------------------------------------------------------

def test_fast_mode_block_argmax():
    """Every id is its fine block's argmax, values are the block max with
    3 low bits cleared, and the results equal the JAX fast mode."""
    rng = np.random.RandomState(7)
    Q, N, D, K, FINE = 8, 1000, 32, 20, 4
    q = rng.randn(Q, D).astype(np.float32)
    c = rng.randn(N, D).astype(np.float32)
    kw = dict(k=K, tile=128, fine=FINE, coarse=4)
    vj, ij = jax_fast(jnp.asarray(q), jnp.asarray(c), q_tile=8,
                      interpret=True, **kw)
    vt, it = mips_hier.mips_topk_fast(_t(q), _t(c), **kw)
    vt, it = vt.numpy(), it.numpy()
    np.testing.assert_array_equal(it, np.asarray(ij))
    np.testing.assert_allclose(vt, np.asarray(vj), atol=TOL, rtol=TOL)
    s = _bf16_scores(q, c)
    for qi in range(Q):
        for j in range(K):
            doc = it[qi, j]
            blk = doc // FINE
            assert s[qi, doc] == s[qi, blk * FINE:(blk + 1) * FINE].max()
            assert vt[qi, j] == _clear(np.float32(s[qi, doc]), 3) or abs(
                vt[qi, j] - s[qi, doc]) <= 1e-5 * abs(s[qi, doc])
    exact_ids = np.argsort(-s, axis=1)[:, :K]
    rec = np.mean([len(set(it[qi]) & set(exact_ids[qi])) / K
                   for qi in range(Q)])
    assert rec >= 0.9, rec


def test_fast_mode_nonaligned_tail():
    """Pad rows (replicas of the last row) never give out-of-range ids."""
    rng = np.random.RandomState(8)
    Q, N, D = 4, 130, 16
    q = rng.randn(Q, D).astype(np.float32)
    c = np.abs(rng.randn(N, D)).astype(np.float32)
    kw = dict(k=8, tile=64, fine=4, coarse=4)
    vj, ij = jax_fast(jnp.asarray(q), jnp.asarray(c), q_tile=4,
                      interpret=True, **kw)
    vt, it = mips_hier.mips_topk_fast(_t(q), _t(c), **kw)
    assert it.min() >= 0 and it.max() < N
    assert len(set(it[0].tolist())) == 8
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=TOL,
                               rtol=TOL)


def test_fast_prepadded_n_real_matches_unpadded():
    rng = np.random.RandomState(12)
    Q, N, D = 4, 700, 16
    q = rng.randn(Q, D).astype(np.float32)
    c = rng.randn(N, D).astype(np.float32)
    c[-1] = q[0] * 10
    c_p = np.concatenate([c, np.broadcast_to(c[-1:], ((-N) % 128, D))])
    kw = dict(k=10, tile=128, fine=4, coarse=4)
    vj, ij = jax_fast(jnp.asarray(q), jnp.asarray(c_p), n_real=N, q_tile=4,
                      interpret=True, **kw)
    v, i = mips_hier.mips_topk_fast(_t(q), _t(c_p), n_real=N, **kw)
    v0, i0 = mips_hier.mips_topk_fast(_t(q), _t(c), **kw)
    assert torch.equal(i, i0) and torch.equal(v, v0)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), atol=TOL,
                               rtol=TOL)


def test_fast_super_level_and_tiny_corpus():
    """The super-level selection (K3 over packed maxima), and a corpus with
    fewer fine blocks than k: the result is padded to width k with -inf
    and id 0, and -inf slots keep the ids their bits give, as in JAX."""
    rng = np.random.RandomState(13)
    q = rng.randn(6, 16).astype(np.float32)
    c = rng.randn(5000, 16).astype(np.float32)
    kw = dict(k=5, tile=256, fine=4, coarse=4, supers=4)
    vj, ij = jax_fast(jnp.asarray(q), jnp.asarray(c), q_tile=8,
                      interpret=True, **kw)
    vt, it = mips_hier.mips_topk_fast(_t(q), _t(c), **kw)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=TOL,
                               rtol=TOL)
    c_small = c[:10]
    kw = dict(k=6, tile=64, fine=4, coarse=4)
    vj, ij = jax_fast(jnp.asarray(q), jnp.asarray(c_small), q_tile=8,
                      interpret=True, **kw)
    vt, it = mips_hier.mips_topk_fast(_t(q), _t(c_small), **kw)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(np.isinf(vt.numpy()),
                                  np.isinf(np.asarray(vj)))


# --- int8 search ------------------------------------------------------

def test_int8_quantization_bit_equal():
    rng = np.random.RandomState(9)
    c = rng.randn(1000, 32).astype(np.float32)
    c[:, 3] = 0.0  # an all-zero dimension takes the 1e-30 floor
    cj, dj = jax_quantize(jnp.asarray(c))
    ct, dt = mips_int8.quantize_corpus_int8(_t(c))
    assert ct.dtype == torch.int8 and dt.dtype == torch.float32
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_int8_mode_matches_jax():
    """ids and scores equal the JAX int8 search (tolerance 0: integer
    scores, one float32 scale multiply)."""
    rng = np.random.RandomState(9)
    Q, N, D, K = 8, 1000, 32, 20
    q = rng.randn(Q, D).astype(np.float32)
    c = rng.randn(N, D).astype(np.float32)
    cj, dj = jax_quantize(jnp.asarray(c))
    kw = dict(k=K, tile=128, fine=4, coarse=4)
    vj, ij = jax_int8(jnp.asarray(q), cj, dj, q_tile=8, interpret=True, **kw)
    ct, dt = mips_int8.quantize_corpus_int8(_t(c))
    vt, it = mips_int8.mips_topk_int8(_t(q), ct, dt, **kw)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert it.min() >= 0 and it.max() < N
    s = q @ c.T
    exact_ids = np.argsort(-s, axis=1)[:, :K]
    rec = np.mean([len(set(it[qi].tolist()) & set(exact_ids[qi])) / K
                   for qi in range(Q)])
    assert rec >= 0.85, rec
    assert np.all(np.diff(vt.numpy(), axis=1) <= 1e-6)


def test_int8_super_level_and_n_real():
    """Super-level selection over packed int32 maxima (iinfo.min masks),
    and a pre-padded corpus with n_real equal to the unpadded call."""
    rng = np.random.RandomState(14)
    Q, N, D = 6, 4999, 32
    q = rng.randn(Q, D).astype(np.float32)
    c = rng.randn(N, D).astype(np.float32)
    cj, dj = jax_quantize(jnp.asarray(c))
    kw = dict(k=5, tile=256, fine=4, coarse=4, supers=4)
    vj, ij = jax_int8(jnp.asarray(q), cj, dj, q_tile=8, interpret=True, **kw)
    ct, dt = mips_int8.quantize_corpus_int8(_t(c))
    vt, it = mips_int8.mips_topk_int8(_t(q), ct, dt, **kw)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    ct_p = mips_hier._pad_replicate(ct, 2048)
    vp, ip = mips_int8.mips_topk_int8(_t(q), ct_p, dt, n_real=N, **kw)
    assert torch.equal(ip, it) and torch.equal(vp, vt)


# --- exact2 -------------------------------------------------------------

EXACT2_KW = dict(tile=256, cb=16, supers=4)


def _exact2_pair(q, c, k, **extra):
    vj, ij = jax_exact2(jnp.asarray(q), jnp.asarray(c), k, q_tile=8,
                        interpret=True, **EXACT2_KW, **extra)
    vt, it = mips_exact2.mips_topk_exact2(_t(q), _t(c), k, **EXACT2_KW,
                                          **extra)
    return vt.numpy(), it.numpy(), np.asarray(vj), np.asarray(ij)


def test_exact2_matches_naive():
    rng = np.random.RandomState(0)
    Q, N, D, k = 16, 2048, 32, 10
    q = rng.randn(Q, D).astype(np.float32)
    c = rng.randn(N, D).astype(np.float32)
    vt, it, vj, ij = _exact2_pair(q, c, k)
    rv, ri = _np_topk(q, c, k)
    np.testing.assert_array_equal(it, ri)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(vt, rv, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(vt, vj, atol=TOL, rtol=TOL)


def test_exact2_boundary_block():
    rng = np.random.RandomState(1)
    Q, N, D, k = 8, 2048 - 37, 32, 8
    q = rng.randn(Q, D).astype(np.float32)
    c = rng.randn(N, D).astype(np.float32)
    c[-1] = q[0] * 3.0
    vt, it, vj, ij = _exact2_pair(q, c, k)
    rv, ri = _np_topk(q, c, k)
    np.testing.assert_array_equal(it, ri)
    np.testing.assert_array_equal(it, ij)
    assert len(set(it[0].tolist())) == k


def test_exact2_two_docs_same_block():
    rng = np.random.RandomState(2)
    Q, N, D, k = 4, 2048, 32, 5
    q = rng.randn(Q, D).astype(np.float32)
    c = rng.randn(N, D).astype(np.float32)
    for col in range(Q):
        c[100] += q[col] * 2.0
        c[101] += q[col] * 1.9
    before = mips_exact2.mips_topk_exact2.fallbacks
    vt, it, vj, ij = _exact2_pair(q, c, k)
    rv, ri = _np_topk(q, c, k)
    np.testing.assert_array_equal(it, ri)
    np.testing.assert_array_equal(it, ij)
    assert mips_exact2.mips_topk_exact2.fallbacks == before
    for col in range(Q):
        assert 100 in it[col] and 101 in it[col]


def test_exact2_overflow_falls_back():
    """More flagged blocks than the rescore budget: the certificate fails
    on the device, the search falls back, and stays exact."""
    rng = np.random.RandomState(3)
    Q, N, D, k = 4, 2048, 16, 8
    q = rng.randn(Q, D).astype(np.float32)
    c = rng.randn(N, D).astype(np.float32) * 0.01
    strong = q[0] / np.linalg.norm(q[0])
    for b in range(8):
        c[b * 256] = strong * (3.0 + 0.1 * b)
        c[b * 256 + 1] = strong * (2.95 + 0.1 * b)
    before = mips_exact2.mips_topk_exact2.fallbacks
    vt, it, vj, ij = _exact2_pair(q, c, k, rescore_blocks=2)
    assert mips_exact2.mips_topk_exact2.fallbacks == before + 1
    rv, ri = _np_topk(q, c, k)
    np.testing.assert_array_equal(it, ri)
    np.testing.assert_array_equal(it, ij)


def test_exact2_small_corpus_delegates():
    rng = np.random.RandomState(4)
    q = rng.randn(4, 16).astype(np.float32)
    c = rng.randn(96, 16).astype(np.float32)
    vt, it, vj, ij = _exact2_pair(q, c, 5)
    rv, ri = _np_topk(q, c, 5)
    np.testing.assert_array_equal(it, ri)
    np.testing.assert_array_equal(it, ij)


def test_exact2_core_certificate_holds():
    """Without a fallback, the core's own result is exact and ok is a
    device boolean."""
    rng = np.random.RandomState(0)
    q = rng.randn(16, 32).astype(np.float32)
    c = rng.randn(2048, 32).astype(np.float32)
    v, i, ok = mips_exact2._exact2_core(_t(q), _t(c), n_real=2048, k=10,
                                        cb=16, supers=4, rescore_blocks=4)
    assert ok.dtype == torch.bool and ok.dim() == 0 and bool(ok)
    rv, ri = _np_topk(q, c, 10)
    np.testing.assert_array_equal(i.numpy(), ri)


# --- flat block-max search ----------------------------------------------

def test_blockmax_pallas_topk_matches_jax():
    """Unaligned N: zero-row padding, masked padded blocks, the extra
    block slot."""
    rng = np.random.RandomState(1)
    Q, N, D = 8, 700, 16
    q = rng.randn(Q, D).astype(np.float32)
    c = rng.randn(N, D).astype(np.float32)
    vj, ij = jax_blockmax_pallas(jnp.asarray(q), jnp.asarray(c), k=20,
                                 tile=128, block=8, q_tile=8, interpret=True)
    vt, it = mips_blockmax.mips_topk_blockmax_pallas(_t(q), _t(c), k=20,
                                                     tile=128, block=8)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=TOL,
                               rtol=TOL)
    v_ref, _ = jax_mips_topk(jnp.asarray(q), jnp.asarray(c), k=20, tile=128)
    np.testing.assert_allclose(vt.numpy(), np.asarray(v_ref), atol=2e-5,
                               rtol=1e-5)
    assert it.max() < N and it.min() >= 0


def test_blockmax_pallas_packed_block():
    rng = np.random.RandomState(2)
    Q, N, D = 4, 256, 16
    q = rng.randn(Q, D).astype(np.float32)
    c = rng.randn(N, D).astype(np.float32)
    c[64:72] = q[0] * 10
    _, it = mips_blockmax.mips_topk_blockmax_pallas(_t(q), _t(c), k=10,
                                                    tile=64, block=8)
    assert set(range(64, 72)) <= set(it[0].tolist())


def test_hierarchical_super_level_boundary_block():
    """tests/test_pallas_mips.py::test_hierarchical_super_level_matches_naive
    through the port: the best docs of q3 in the replicate-padded boundary
    block."""
    rng = np.random.RandomState(7)
    Q, N, D = 8, 3000, 16
    q = rng.randn(Q, D).astype(np.float32)
    c = rng.randn(N, D).astype(np.float32)
    c[2996:] = q[3] * 10
    kw = dict(k=4, tile=256, fine=4, coarse=4, supers=4)
    vj, ij = jax_hierarchical(jnp.asarray(q), jnp.asarray(c), q_tile=8,
                              interpret=True, **kw)
    vt, it = mips_hier.mips_topk_hierarchical(_t(q), _t(c), **kw)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=TOL,
                               rtol=TOL)
    assert set(range(2996, 3000)) == set(it[3].tolist())
