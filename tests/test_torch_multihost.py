"""The port's multi-host mesh and two-level top-k merge
(cocodr_tpu_torch/parallel/multihost.py): tests/test_multihost.py's three
cases over 4 spawned gloo ranks split into force_replicas=2 pseudo-hosts
(the JAX test: 8 fake CPU devices in 2 replicas). The merged results equal
a single global exact top-k, values 1e-5 (sums in another order), and the
JAX two-level merge on its own mesh, ids exactly."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_mesh_workers as workers
from cocodr_tpu.parallel.multihost import hybrid_mesh as jax_hybrid_mesh
from cocodr_tpu.parallel.multihost import two_level_topk as jax_two_level
from cocodr_tpu_torch.core.mesh import spawn

TOL = dict(rtol=1e-5, atol=1e-5)
W = 4


def two_level_data():
    rng = np.random.RandomState(0)
    return (rng.randn(16, 32).astype(np.float32),
            rng.randn(512, 32).astype(np.float32))


def sharded_data():
    rng = np.random.RandomState(1)
    return (rng.randn(8, 16).astype(np.float32),
            rng.randn(256, 16).astype(np.float32))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    q, c = two_level_data()
    q2, c2 = sharded_data()
    cases = [("hybrid_shape", {}),
             ("two_level", dict(queries=q, corpus=c, k=10)),
             ("sharded_2level", dict(queries=q2, corpus=c2, k=5, tile=64))]
    return spawn(workers.run_cases, W, str(tmp_path_factory.mktemp("store")),
                 cases)


def test_hybrid_mesh_single_slice_and_forced(world):
    """One host without torchrun's variables: n_slices() is 1; forced
    replicas split the 4 ranks into a (2, 2, 1) mesh named as the JAX
    one."""
    jm = jax_hybrid_mesh(model=1, force_replicas=2)
    for shape in world:
        info = shape[0]
        assert info["slices"] == 1
        assert info["shape"] == (2, 2, 1)
        assert info["names"] == jm.axis_names


def test_two_level_topk_matches_global(world):
    """Each rank's exact top-10 of its 128 rows, merged over data then
    replica: values equal the global top-10, ids score them; ids equal the
    JAX two-level merge of the same shards over 8 devices."""
    q, c = two_level_data()
    s = q @ c.T
    ref_v = -np.sort(-s, axis=1)[:, :10]
    mesh = jax_hybrid_mesh(model=1, force_replicas=2)

    def body(qs, cs):
        shard = (jax.lax.axis_index("replica") * jax.lax.psum(1, "data")
                 + jax.lax.axis_index("data"))
        v, i = jax.lax.top_k(jnp.einsum("qd,nd->qn", qs, cs), 10)
        return jax_two_level(v, i + shard * cs.shape[0], 10)

    f = shard_map(body, mesh=mesh,
                  in_specs=(P(), P(("replica", "data"), None)),
                  out_specs=(P(), P()))
    _, ji = jax.jit(f)(q, c)
    for rank_out in world:
        v, i = rank_out[1]
        np.testing.assert_allclose(v, ref_v, **TOL)
        np.testing.assert_allclose(np.take_along_axis(s, i, axis=1), ref_v,
                                   **TOL)
        np.testing.assert_array_equal(i, np.asarray(ji))


def test_sharded_mips_2level(world):
    """sharded_mips_topk_2level (the bf16 sweep of ops.mips.mips_topk on
    each rank's 64 rows): the ranked ids equal the global exact ranking's,
    as sets a query (the JAX test's check)."""
    q, c = sharded_data()
    ref = np.argsort(-(q @ c.T), axis=1)[:, :5]
    for rank_out in world:
        _, i = rank_out[2]
        assert np.array_equal(np.sort(i, 1), np.sort(ref, 1))
