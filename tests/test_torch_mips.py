"""K2 (dual block-max sweep), K3 (extract-max top-k) and the hierarchical
search: the port's plain versions against the JAX package's Pallas kernels
in interpret mode, on the same numpy inputs."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cocodr_tpu.ops.mips import mips_topk
from cocodr_tpu.ops.pallas_mips import (
    _dual_sweep_mixed,
    _pad_replicate as jax_pad_replicate,
    mips_topk_hierarchical as jax_hierarchical,
    pallas_topk,
)
from cocodr_tpu_torch.ops import mips_hier

torch.set_num_threads(1)


# --- K2 ---------------------------------------------------------------

@pytest.mark.parametrize("supers", [0, 2])
def test_dual_sweep_plain_matches_pallas(supers):
    """Both JAX fine layouts (2D query-major, 3D super rows) against the
    port's query-major [Q, N/fine]; coarse maxima are corpus-major in JAX.
    Tolerance 2e-6: float32 sums of exact bf16 products in another order."""
    rng = np.random.RandomState(0)
    Q, N, D = 12, 512, 16
    q = rng.randn(Q, D).astype(np.float32)
    c = rng.randn(N, D).astype(np.float32)
    fj, cj = _dual_sweep_mixed(jnp.asarray(q), jnp.asarray(c), tile=128,
                               fine=4, coarse=4, q_tile=8, interpret=True,
                               supers=supers)
    fj = np.asarray(fj)
    if fj.ndim == 3:  # [n_super, Qp, fps] -> [Q, n_super * fps]
        fj = fj.transpose(1, 0, 2).reshape(fj.shape[1], -1)[:Q]
    ft, ct = mips_hier.dual_sweep_reference(torch.from_numpy(q),
                                            torch.from_numpy(c), 4, 4)
    assert ft.shape == (Q, N // 4) and ct.shape == (Q, N // 16)
    np.testing.assert_allclose(ft.numpy(), fj, atol=2e-6, rtol=2e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj).T, atol=2e-6,
                               rtol=2e-6)


def test_dual_sweep_wrapper_on_cpu_uses_plain_version():
    rng = np.random.RandomState(1)
    q = torch.from_numpy(rng.randn(3, 64).astype(np.float32))
    c = torch.from_numpy(rng.randn(256, 64).astype(np.float32))
    before = mips_hier.dual_sweep.launches
    got = mips_hier.dual_sweep(q, c)
    want = mips_hier.dual_sweep_reference(q, c)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert mips_hier.dual_sweep.launches == before


# --- K3 ---------------------------------------------------------------

def _topk_case(name):
    rng = np.random.RandomState(2)
    if name == "f32":
        return rng.randn(9, 300).astype(np.float32), 17
    if name == "i32":
        return rng.randint(-1000, 1000, (9, 260)).astype(np.int32), 12
    if name == "ties":  # many equal values: lowest index first
        return rng.randint(0, 4, (6, 200)).astype(np.float32), 30
    if name == "ties_i32":
        return rng.randint(0, 3, (6, 256)).astype(np.int32), 40
    if name == "neg_inf":
        # fewer than k entries above finfo.min: later rounds return an
        # already-extracted slot with value finfo.min; an all -inf row of
        # width 300 returns the first virtual pad index (300)
        x = rng.randn(5, 300).astype(np.float32)
        x[:, 10] = x[:, 20] = 5.0
        x[2, :] = -np.inf
        x[3, 5:] = -np.inf
        return x, 8
    if name == "finfo_min":
        x = rng.randn(4, 128).astype(np.float32)
        x[:, ::2] = np.finfo(np.float32).min
        return x, 70
    raise KeyError(name)


@pytest.mark.parametrize(
    "case", ["f32", "i32", "ties", "ties_i32", "neg_inf", "finfo_min"])
def test_topk_plain_matches_pallas_exactly(case):
    """Exact equality of values and ids (no tolerance): the plain version
    reproduces the TPU kernel's rounds, tie order and sentinel."""
    x, k = _topk_case(case)
    jv, ji = pallas_topk(jnp.asarray(x), k, interpret=True)
    tv, ti = mips_hier.topk_reference(torch.from_numpy(x), k)
    assert ti.dtype == torch.int32 and tv.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_topk_wrapper_on_cpu_and_bad_k():
    x = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    before = mips_hier.topk.launches
    v, i = mips_hier.topk(x, 5)
    assert torch.equal(i.long(), torch.topk(x, 5).indices)
    assert mips_hier.topk.launches == before
    with pytest.raises(ValueError):
        mips_hier.topk(x, 51)


# --- search -------------------------------------------------------------

def test_pad_replicate_matches_jax():
    c = np.arange(30, dtype=np.float32).reshape(10, 3)
    want = np.asarray(jax_pad_replicate(jnp.asarray(c), 8))
    got = mips_hier._pad_replicate(torch.from_numpy(c), 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert mips_hier._pad_replicate(torch.from_numpy(c), 5).shape == (10, 3)


def _same_topk_sets(vt, it, vj, ij, tol=2e-5):
    """Top-k as sets, up to near-ties: equal scores within tol, and any id
    that differs scores within tol of the k-th score."""
    vt, it = vt.numpy(), it.numpy()
    vj, ij = np.asarray(vj), np.asarray(ij)
    np.testing.assert_allclose(vt, vj, atol=tol, rtol=tol)
    for row in range(vt.shape[0]):
        a, b = set(it[row].tolist()), set(ij[row].tolist())
        assert len(a) == len(it[row]), "duplicate ids"
        for doc in a ^ b:
            assert abs(vt[row, -1] - vj[row, -1]) <= tol
            pos = np.where(it[row] == doc)[0]
            pos = pos if len(pos) else np.where(ij[row] == doc)[0]
            s = vt[row, pos[0]] if doc in a else vj[row, pos[0]]
            assert abs(s - vj[row, -1]) <= tol, (row, doc)


def _corpus(name):
    """The adversarial corpora of tests/test_pallas_mips.py."""
    rng = np.random.RandomState({"random": 5, "packed": 6, "tail": 8,
                                 "super": 13}[name])
    if name == "random":
        q, c = rng.randn(8, 16), rng.randn(700, 16)
        kw = dict(k=20, tile=128, fine=4, coarse=4)
    elif name == "packed":  # the 8 best docs for q0 in one block
        q, c = rng.randn(4, 16), rng.randn(256, 16)
        c[64:72] = q[0] * 10
        kw = dict(k=10, tile=64, fine=4, coarse=4)
    elif name == "tail":  # non-aligned tail, all-positive scores
        q, c = rng.randn(4, 16), np.abs(rng.randn(130, 16))
        kw = dict(k=8, tile=64, fine=4, coarse=4)
    else:  # large enough for the super level (n_coarse > supers * k_sel)
        q, c = rng.randn(6, 16), rng.randn(5000, 16)
        kw = dict(k=5, tile=256, fine=4, coarse=4, supers=4)
    return q.astype(np.float32), c.astype(np.float32), kw


@pytest.mark.parametrize("name", ["random", "packed", "tail", "super"])
def test_hierarchical_matches_jax(name):
    q, c, kw = _corpus(name)
    vj, ij = jax_hierarchical(jnp.asarray(q), jnp.asarray(c), q_tile=8,
                              interpret=True, **kw)
    vt, it = mips_hier.mips_topk_hierarchical(torch.from_numpy(q),
                                              torch.from_numpy(c), **kw)
    assert it.max() < c.shape[0] and it.min() >= 0
    _same_topk_sets(vt, it, vj, ij)
    if name == "packed":
        assert set(range(64, 72)) <= set(it[0].tolist())


def test_hierarchical_matches_naive_search():
    q, c, kw = _corpus("super")
    vt, it = mips_hier.mips_topk_hierarchical(torch.from_numpy(q),
                                              torch.from_numpy(c), **kw)
    vn, inn = mips_topk(jnp.asarray(q), jnp.asarray(c), k=kw["k"], tile=128)
    _same_topk_sets(vt, it, vn, inn)


def test_hierarchical_prepadded_n_real_matches_unpadded():
    """A caller that pre-pads the corpus (replicating the last row) and
    passes n_real gets the unpadded results: no pad-row ids, no dupes."""
    rng = np.random.RandomState(11)
    Q, N, D = 8, 700, 16
    q = rng.randn(Q, D).astype(np.float32)
    c = rng.randn(N, D).astype(np.float32)
    c[-1] = q[0] * 10  # pad replicas of a strong hit would show as dupes
    c_p = np.concatenate([c, np.broadcast_to(c[-1:], ((-N) % 128, D))])
    kw = dict(k=20, tile=128, fine=4, coarse=4)
    vj, ij = jax_hierarchical(jnp.asarray(q), jnp.asarray(c_p), n_real=N,
                              q_tile=8, interpret=True, **kw)
    v, i = mips_hier.mips_topk_hierarchical(torch.from_numpy(q),
                                            torch.from_numpy(c_p), n_real=N,
                                            **kw)
    v0, i0 = mips_hier.mips_topk_hierarchical(torch.from_numpy(q),
                                              torch.from_numpy(c), **kw)
    assert torch.equal(i, i0) and torch.equal(v, v0)
    assert i.max() < N
    _same_topk_sets(v, i, vj, ij)
