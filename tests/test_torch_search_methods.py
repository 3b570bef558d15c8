"""The port's ops/mips.py search methods and parallel/topk.py::search_topk
against the JAX package's, on the same numpy inputs (JAX on the CPU, its
Pallas kernels in interpret mode)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cocodr_tpu.ops import mips as jax_mips
from cocodr_tpu.ops.pallas_mips import mips_topk_fast as jax_fast
from cocodr_tpu.ops.pallas_mips import mips_topk_hierarchical as jax_hier
from cocodr_tpu.parallel.topk import search_topk as jax_search_topk
from cocodr_tpu_torch.ops import mips
from cocodr_tpu_torch.parallel.topk import search_topk

torch.set_num_threads(1)

# float32 sums of exact bf16 (or float32) products in another order
TOL = 2e-6


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _same_topk(vt, it, vj, ij, tol=TOL):
    """Equal scores within tol; ids equal as sets, except ids whose scores
    lie within tol of the k-th score (near-ties may order either way)."""
    vt, it = np.asarray(vt), np.asarray(it)
    vj, ij = np.asarray(vj), np.asarray(ij)
    assert vt.shape == vj.shape and it.shape == ij.shape
    np.testing.assert_allclose(vt, vj, atol=tol, rtol=tol)
    for row in range(vt.shape[0]):
        a, b = set(it[row].tolist()), set(ij[row].tolist())
        assert len(a) == it.shape[1], "duplicate ids"
        for doc in a ^ b:
            src = (it, vt) if doc in a else (ij, vj)
            pos = np.where(src[0][row] == doc)[0][0]
            assert abs(src[1][row, pos] - vj[row, -1]) <= tol, (row, doc)


def _data(seed, Q, N, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(Q, D).astype(np.float32),
            rng.randn(N, D).astype(np.float32))


# --- ops/mips.py ----------------------------------------------------------

@pytest.mark.parametrize("case", ["bf16", "fp32", "k_above_tile",
                                  "unaligned"])
def test_mips_topk_matches_jax(case):
    k, tile, exact = 17, 128, False
    q, c = _data(0, 13, 1000, 24)
    if case == "fp32":
        exact = True
    elif case == "k_above_tile":
        q, c = _data(1, 4, 300, 8)
        k, tile, exact = 100, 64, True
    elif case == "unaligned":
        q, c = _data(2, 3, 777, 16)
        k, tile = 10, 256
    vj, ij = jax_mips.mips_topk(jnp.asarray(q), jnp.asarray(c), k=k,
                                tile=tile, exact_fp32=exact)
    vt, it = mips.mips_topk(_t(q), _t(c), k, tile=tile, exact_fp32=exact)
    assert it.dtype == torch.int64 and it.max() < c.shape[0]
    _same_topk(vt, it, vj, ij, tol=1e-5 if exact else TOL)


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_rescore_topk_matches_jax(dtype):
    q, c = _data(3, 10, 400, 16)
    rng = np.random.RandomState(4)
    cand = rng.randint(0, 400, (10, 30)).astype(np.int32)
    cand[:, ::7] = -1  # padded candidate slots score -inf
    for row in cand:  # distinct candidates per query
        live = row >= 0
        row[live] = rng.choice(400, live.sum(), replace=False)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    vj, ij = jax_mips.rescore_topk(jnp.asarray(q), jnp.asarray(c),
                                   jnp.asarray(cand), 8, dtype=jd, q_chunk=4)
    vt, it = mips.rescore_topk(_t(q), _t(c), _t(cand), 8, dtype=td,
                               q_chunk=4)
    _same_topk(vt, it, vj, ij, tol=1e-5)


def test_refined_matches_jax():
    q, c = _data(5, 8, 700, 16)
    vj, ij = jax_mips.mips_topk_refined(jnp.asarray(q), jnp.asarray(c), 10,
                                        tile=128)
    vt, it = mips.mips_topk_refined(_t(q), _t(c), 10, tile=128)
    _same_topk(vt, it, vj, ij, tol=1e-5)


@pytest.mark.parametrize("n", [700, 1024])
def test_blockmax_xla_path_matches_jax(n):
    q, c = _data(6, 8, n, 16)
    vj, ij = jax_mips.mips_topk_blockmax(jnp.asarray(q), jnp.asarray(c), 20,
                                         tile=256, block=32)
    vt, it = mips.mips_topk_blockmax(_t(q), _t(c), 20, tile=256, block=32)
    _same_topk(vt, it, vj, ij)
    with pytest.raises(ValueError):
        mips.mips_topk_blockmax(_t(q), _t(c), 20, tile=100, block=32)


def test_resolve_search_method():
    """'auto' is 'pallas' on every device, and kernel methods stay
    themselves (the JAX package turns them into 'blockmax' off the TPU)."""
    assert mips.SEARCH_METHODS == jax_mips.SEARCH_METHODS
    assert mips.resolve_search_method("auto") == "pallas"
    for m in ("pallas", "exact2", "fast", "blockmax", "refined", "naive"):
        assert mips.resolve_search_method(m) == m
        assert mips.resolve_search_method(m, exact_fp32=True) == "naive"
    with pytest.raises(ValueError):
        mips.resolve_search_method("ivf")


def test_clamp_q_chunk(monkeypatch):
    """An explicit budget gives the JAX function's clamp; without one and
    without a card it raises."""
    for args in ((4096, 8_841_823, 768), (4096, 1_048_576, 768),
                 (1000, 100, 8)):
        assert (mips.clamp_q_chunk(*args, hbm_budget=15_000_000_000)
                == jax_mips.clamp_q_chunk(*args))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="hbm_budget"):
        mips.clamp_q_chunk(4096, 1000, 8)


@pytest.mark.parametrize("method", ["exact2", "blockmax", "refined",
                                    "naive"])
def test_chunked_queries_raises_on_ignored_n_real(method):
    q, c = _data(7, 4, 300, 8)
    with pytest.raises(ValueError, match="n_real"):
        mips.mips_topk_chunked_queries(q, _t(c), 5, method=method,
                                       n_real=200)


def test_chunked_queries_chunks_and_budget():
    """Query chunks give the unchunked results; a budget clamps the chunk
    of a kernel method (and here leaves the results alone)."""
    q, c = _data(8, 50, 2048, 16)
    v1, i1 = mips.mips_topk_chunked_queries(q, _t(c), 5, q_chunk=16,
                                            method="pallas")
    v2, i2 = mips.mips_topk_chunked_queries(q, _t(c), 5, q_chunk=4096,
                                            method="pallas", hbm_budget=1)
    assert isinstance(v1, np.ndarray) and v1.shape == (50, 5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(v1, v2)


# --- parallel/topk.py::search_topk ---------------------------------------

SEARCH_Q, SEARCH_N, SEARCH_D, SEARCH_K = 12, 4096, 16, 10


@pytest.fixture(scope="module")
def search_data():
    """bf16-representable inputs, so that the float32 rescores ('refined',
    and the JAX package's 'auto' off the TPU) score like the bf16 sweeps."""
    q, c = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
            for x in _data(9, SEARCH_Q, SEARCH_N, SEARCH_D))
    # exact search over the bf16 operands: the oracle of every exact method
    s = np.asarray(jnp.matmul(jnp.asarray(q, jnp.bfloat16),
                              jnp.asarray(c, jnp.bfloat16).T,
                              preferred_element_type=jnp.float32))
    ids = np.argsort(-s, axis=1, kind="stable")[:, :SEARCH_K]
    return q, c, np.take_along_axis(s, ids, axis=1), ids


@pytest.mark.parametrize("method", ["auto", "pallas", "exact2", "blockmax",
                                    "refined", "naive"])
def test_search_topk_exact_methods(search_data, method):
    """Every exact method against the JAX search_topk (which runs the exact
    block-max search for the kernel methods on the CPU) and the exact
    numpy search."""
    q, c, rv, ri = search_data
    vt, it = search_topk(q, c, SEARCH_K, method=method, q_chunk=8,
                         device="cpu")
    vj, ij = jax_search_topk(q, c, SEARCH_K, method=method, q_chunk=8)
    _same_topk(vt, it, vj, ij)
    _same_topk(vt, it, rv, ri)


def test_search_topk_fast_matches_jax_fast(search_data):
    q, c, rv, ri = search_data
    vt, it = search_topk(q, c, SEARCH_K, method="fast", device="cpu")
    vj, ij = jax_fast(jnp.asarray(q), jnp.asarray(c), SEARCH_K,
                      interpret=True)
    np.testing.assert_array_equal(it, np.asarray(ij))
    np.testing.assert_allclose(vt, np.asarray(vj), atol=TOL, rtol=TOL)
    rec = np.mean([len(set(it[r]) & set(ri[r])) / SEARCH_K
                   for r in range(SEARCH_Q)])
    assert rec >= 0.9, rec


def test_search_topk_exact_fp32_and_n_real(search_data):
    q, c, _, _ = search_data
    vt, it = search_topk(q, c, SEARCH_K, exact_fp32=True, method="fast",
                         device="cpu")
    vj, ij = jax_search_topk(q, c, SEARCH_K, exact_fp32=True)
    _same_topk(vt, it, vj, ij, tol=1e-5)
    c_p = np.concatenate([c, np.broadcast_to(c[-1:], (100, SEARCH_D))])
    vp, ip = search_topk(q, c_p, SEARCH_K, n_real=SEARCH_N, device="cpu")
    v0, i0 = search_topk(q, c, SEARCH_K, device="cpu")
    np.testing.assert_array_equal(ip, i0)
    np.testing.assert_array_equal(vp, v0)
    # ivf under exact_fp32 searches exactly, as in the JAX package
    vi, ii = search_topk(q, c, SEARCH_K, exact_fp32=True, method="ivf",
                         device="cpu")
    np.testing.assert_array_equal(ii, it)


def test_search_topk_raises_where_not_ported(search_data, monkeypatch):
    """A mesh of several devices raised here until the multi-device slice
    (its sharded search: tests/test_torch_sharded_search.py); over a world
    of one process a mesh searches on the one device, and the sharded
    search forced at W = 1 gives the same ids."""
    import torch_mesh_workers as workers
    from cocodr_tpu_torch.parallel.topk import mips_topk_sharded

    q, c, _, _ = search_data
    with workers.world_of_one() as mesh:
        vm, im = search_topk(q, c, 5, mesh=mesh, device="cpu")
        vs, i_s = mips_topk_sharded(q, c, 5, mesh, device="cpu")
    v0, i0 = search_topk(q, c, 5, device="cpu")
    np.testing.assert_array_equal(im, i0)
    np.testing.assert_array_equal(i_s, i0)
    np.testing.assert_array_equal(vs, v0)
    # ivf, which raised here until ops/ivf.py was ported, searches: at
    # full probe it equals the flat search of the same bf16 operands
    vi, ii = search_topk(q, c, 5, method="ivf", ivf_nprobe=10_000,
                         device="cpu")
    vf, i_f = search_topk(q, c, 5, method="pallas", device="cpu")
    _same_topk(vi, ii, vf, i_f, tol=1e-5)
    assert vm.shape == (SEARCH_Q, 5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        search_topk(q, c, 5)


@pytest.mark.parametrize("method", ["pallas", "fast"])
def test_padding_supers_give_no_duplicate_ids(method):
    """4,100 docs pad to 6,144 rows: 12 super blocks of 512 rows, 9 of them
    real, fewer than k_super = 11. The JAX package's hierarchical and fast
    searches return duplicate ids here (ROADMAP.md Queue 3), which the
    first assertion witnesses; the port bounds the super selection by the
    real supers."""
    q, c = _data(9, SEARCH_Q, 4100, SEARCH_D)
    jax_fn = jax_hier if method == "pallas" else jax_fast
    _, ij = jax_fn(jnp.asarray(q), jnp.asarray(c), SEARCH_K, interpret=True)
    assert any(len(set(row.tolist())) < SEARCH_K for row in np.asarray(ij))
    vt, it = search_topk(q, c, SEARCH_K, method=method, device="cpu")
    for row in it:
        assert len(set(row.tolist())) == SEARCH_K
    if method == "pallas":
        s = np.asarray(jnp.matmul(jnp.asarray(q, jnp.bfloat16),
                                  jnp.asarray(c, jnp.bfloat16).T,
                                  preferred_element_type=jnp.float32))
        ri = np.argsort(-s, axis=1, kind="stable")[:, :SEARCH_K]
        _same_topk(vt, it, np.take_along_axis(s, ri, axis=1), ri)
