"""The port's sharded search (cocodr_tpu_torch/parallel/topk.py:
distributed_topk, sharded_mips_topk, mips_topk_sharded, search_topk with a
mesh) at W = 2 and 4 spawned gloo ranks against the JAX package's on
tests/conftest.py's fake CPU devices and against numpy: ids exactly equal
on random float32 data (no ties), scores 1e-5 (sums in another order),
padding rows never surfacing. The tests/test_lifecycle.py sharded cases
(:229, :315) run on N = 51 rows, which neither 2 nor 4 divides."""
import numpy as np
import pytest

import jax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_mesh_workers as workers
from cocodr_tpu.core.mesh import MeshConfig, create_mesh
from cocodr_tpu.parallel import topk as jtopk
from cocodr_tpu_torch.core.mesh import spawn
from cocodr_tpu_torch.parallel.topk import search_topk

TOL = dict(rtol=1e-5, atol=1e-5)
N, D = 51, 16
METHODS = ["pallas", "fast", "blockmax", "refined", "naive"]


def lifecycle_data():
    rng = np.random.RandomState(0)
    corpus = rng.randn(N, D).astype(np.float32)
    queries = rng.randn(7, D).astype(np.float32)
    dup = corpus.copy()
    q4 = rng.randn(4, D).astype(np.float32)
    dup[N - 1] = q4[0] * 10  # the row the final shard's padding copies
    return corpus, queries, dup, q4


def merge_data(W, Q=6, K=5):
    rng = np.random.RandomState(W)
    vals = -np.sort(-rng.randn(W, Q, K).astype(np.float32), axis=2)
    ids = rng.permutation(W * Q * K * 3)[:W * Q * K].reshape(W, Q, K)
    return vals, ids.astype(np.int64)


def method_data():
    rng = np.random.RandomState(5)
    corpus = rng.randn(301, 64).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    return corpus, rng.randn(9, 64).astype(np.float32)


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    W = request.param
    corpus, queries, dup, q4 = lifecycle_data()
    mc, mq = method_data()
    vals, ids = merge_data(W)
    cases = [
        ("search", dict(queries=queries, corpus=corpus, k=5, q_chunk=4,
                        tile=8, exact_fp32=True)),
        ("search", dict(queries=q4, corpus=dup, k=3, q_chunk=4, tile=8,
                        exact_fp32=True)),
        ("dtopk", dict(vals=vals, ids=ids, k=5)),
        ("search", dict(queries=mq, corpus=mc, k=10, method="ivf")),
    ] + [("sharded", dict(queries=mq, corpus=mc, k=10, q_chunk=4,
                          method=m)) for m in METHODS]
    return W, spawn(workers.run_cases, W,
                    str(tmp_path_factory.mktemp(f"store{W}")), cases)


def jax_sharded(W, queries, corpus, k, **kw):
    mesh = create_mesh(MeshConfig(data=W, model=1), jax.devices()[:W])
    return jtopk.search_topk(queries, corpus, k, mesh=mesh, **kw)


def test_sharded_search_matches_numpy_and_jax(world):
    """tests/test_lifecycle.py::test_search_topk_sharded_matches_numpy at W
    ranks: ids equal numpy's brute force and the JAX sharded search's on
    every rank; no id reaches a padding row."""
    W, out = world
    corpus, queries, _, _ = lifecycle_data()
    s = queries @ corpus.T
    ref_ids = np.argsort(-s, axis=1)[:, :5]
    jv, ji = jax_sharded(W, queries, corpus, 5, q_chunk=4, tile=8,
                         exact_fp32=True)
    for rank_out in out:
        vals, ids = rank_out[0]
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(ids, ji)
        np.testing.assert_allclose(
            vals, np.take_along_axis(s, ref_ids, axis=1), **TOL)
        np.testing.assert_allclose(vals, jv, **TOL)
        assert ids.max() < N


def test_pad_duplicates_cannot_evict_hits(world):
    """tests/test_lifecycle.py::test_sharded_search_pad_duplicates_cannot_
    evict_hits at W ranks: the row the final shard's padding copies is q0's
    best document and stays in its list once; ids equal the JAX search's
    and numpy's."""
    W, out = world
    _, _, dup, q4 = lifecycle_data()
    s = q4 @ dup.T
    ref_ids = np.argsort(-s, axis=1)[:, :3]
    _, ji = jax_sharded(W, q4, dup, 3, q_chunk=4, tile=8, exact_fp32=True)
    for rank_out in out:
        vals, ids = rank_out[1]
        assert (N - 1) in set(ids[0].tolist())
        assert len(set(ids[0].tolist())) == 3
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(ids, ji)


def test_distributed_topk_matches_jax_shard_map(world):
    """Each rank's [Q, k] candidates merged: the port's distributed_topk on
    every rank against the JAX one under shard_map over W devices, values
    and ids exactly equal."""
    W, out = world
    vals, ids = merge_data(W)
    mesh = Mesh(np.asarray(jax.devices()[:W]), ("data",))
    f = shard_map(
        lambda v, i: jtopk.distributed_topk(v[0], i[0], 5, "data"),
        mesh=mesh, in_specs=(P("data"), P("data")), out_specs=(P(), P()))
    jv, ji = f(vals, ids.astype(np.int32))
    for rank_out in out:
        v, i = rank_out[2]
        np.testing.assert_array_equal(v, np.asarray(jv))
        np.testing.assert_array_equal(i, np.asarray(ji))


def test_ivf_over_a_sharded_mesh_searches_exactly(world):
    """search_topk(mesh=, method='ivf') with a data axis above 1 is the
    exact sharded search, as cocodr_tpu/parallel/topk.py:164-167 makes
    it: the ids equal the exact unsharded search's ('pallas', the plain
    versions on the CPU)."""
    _, out = world
    corpus, queries = method_data()
    _, want = search_topk(queries, corpus, 10, method="pallas",
                          device="cpu")
    for rank_out in out:
        np.testing.assert_array_equal(rank_out[3][1], want)


def fast_by_shards(queries, corpus, k, W):
    """'fast' is approximate (block argmax without a rescore), so a shard's
    blocks give other candidates than the whole corpus's: its sharded
    result is each shard's fast top-k (the corpus padded to a multiple of W
    by copies of its last row, the copies masked), merged."""
    import torch

    from cocodr_tpu_torch.ops.mips_hier import mips_topk_fast

    pad = (-len(corpus)) % W
    full = np.concatenate([corpus, np.repeat(corpus[-1:], pad, axis=0)])
    per = len(full) // W
    vals, ids = [], []
    for r in range(W):
        v, i = mips_topk_fast(torch.from_numpy(queries),
                              torch.from_numpy(full[r * per:(r + 1) * per]),
                              k + pad)
        i = i.numpy()
        valid = per - pad if r == W - 1 else per
        vals.append(np.where(i >= valid, -np.inf, v.numpy()))
        ids.append(np.where(i >= valid, -1, i + r * per))
    vals, ids = np.concatenate(vals, 1), np.concatenate(ids, 1)
    order = np.argsort(-vals, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(vals, order, 1),
            np.take_along_axis(ids, order, 1))


@pytest.mark.parametrize("method", METHODS)
def test_every_method_shards_like_one_device(world, method):
    """mips_topk_sharded by each method's per-shard path ('pallas', 'fast':
    the kernels' plain versions on the CPU) against the same method
    unsharded: ids exactly equal, scores 1e-5; for 'refined', whose
    rescore multiplies float32 rows, also numpy's ids (the others rank by
    bf16 products, which order two of these rows otherwise). 'fast' is
    held against its shards' searches merged (`fast_by_shards`), and its
    recall@10 against the exact search stays >= 0.9."""
    W, out = world
    corpus, queries = method_data()
    if method == "fast":
        fv, fi = fast_by_shards(queries, corpus, 10, W)
        ref = np.argsort(-(queries @ corpus.T), axis=1)[:, :10]
        for rank_out in out:
            v, i = rank_out[4 + METHODS.index(method)]
            np.testing.assert_array_equal(i, fi)
            np.testing.assert_allclose(v, fv, **TOL)
            hits = sum(len(set(a) & set(b)) for a, b in zip(i, ref))
            assert hits >= 0.9 * i.size
        return
    v1, i1 = search_topk(queries, corpus, 10, method=method, device="cpu",
                         q_chunk=4)
    ref = np.argsort(-(queries @ corpus.T), axis=1)[:, :10]
    for rank_out in out:
        v, i = rank_out[4 + METHODS.index(method)]
        np.testing.assert_array_equal(i, i1)
        np.testing.assert_allclose(v, v1, **TOL)
        if method == "refined":
            np.testing.assert_array_equal(i, ref)


def test_single_device_search_keeps_n_real():
    """Without a mesh, or with a data axis of 1, n_real is still honoured:
    rows past it never surface."""
    corpus, queries = method_data()
    padded = np.concatenate([corpus, np.repeat(corpus[-1:], 211, axis=0)])
    _, i = search_topk(queries, padded, 10, method="pallas", n_real=301,
                       device="cpu")
    _, want = search_topk(queries, corpus, 10, method="pallas",
                          device="cpu")
    np.testing.assert_array_equal(i, want)
    assert i.max() < 301
