"""The port's mesh and process world (cocodr_tpu_torch/core/mesh.py)
against the JAX package's cocodr_tpu/core/mesh.py: MeshConfig.resolve over
a grid with its errors, the rows shard_batch gives each rank against the
shards a P("data") placement gives each JAX device (exactly equal), the
model axis's meshes against the JAX package's layout, and the spawner
failing a
world whose rank dies or hangs within its join timeout. The JAX side runs
on tests/conftest.py's 8 fake CPU devices; the port's ranks are spawned
gloo processes (tests/torch_mesh_workers.py), one world of each size for
the module."""
import time

import numpy as np
import pytest

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_mesh_workers as workers
from cocodr_tpu.core.mesh import MeshConfig as JaxMeshConfig
from cocodr_tpu_torch.core import mesh as tmesh

GRID = [(-1, 1, 1), (-1, 1, 4), (2, 1, 2), (4, 1, 4), (8, 1, 2),
        (3, 1, 4), (-1, 2, 4), (2, 2, 4), (-1, 3, 8), (1, 1, 1),
        (-1, 1, 8), (4, 2, 8)]

BATCH = {"ids": np.arange(8 * 3, dtype=np.int32).reshape(8, 3),
         "w": np.linspace(0, 1, 8).astype(np.float32)}


def _outcome(cfg, n):
    try:
        return cfg.resolve(n)
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("data,model,n", GRID)
def test_resolve_matches_jax(data, model, n):
    """The same (data, model) or the same ValueError text, exactly."""
    assert (_outcome(tmesh.MeshConfig(data, model), n)
            == _outcome(JaxMeshConfig(data, model), n))


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    W = request.param
    cases = [("world", {}), ("shard_rows", {"batch": BATCH}),
             ("shard_error", {"batch": {"x": np.zeros((W + 1, 2))}}),
             ("tp_mesh", {})]
    return W, tmesh.spawn(workers.run_cases, W,
                          str(tmp_path_factory.mktemp(f"store{W}")), cases)


def test_spawned_world_and_mesh(world):
    """Every rank sees the world's size and its own rank; the mesh's data
    axis fills the world."""
    W, out = world
    for r, (info, _, _, _) in enumerate(out):
        assert info == {"rank": r, "size": W, "data": W}


def test_shard_batch_rows_equal_jax_placement(world):
    """Rank r's rows equal the addressable shard of JAX device r under a
    P('data') placement over W devices, array for array (exactly)."""
    W, out = world
    mesh = Mesh(np.asarray(jax.devices()[:W]).reshape(W), ("data",))
    for key, x in BATCH.items():
        placed = jax.device_put(x, NamedSharding(mesh, P("data")))
        shards = sorted(placed.addressable_shards, key=lambda s: s.device.id)
        for r, (_, rows, _, _) in enumerate(out):
            np.testing.assert_array_equal(rows[key], np.asarray(shards[r].data))


def test_shard_batch_refuses_a_batch_the_axis_does_not_divide(world):
    """W + 1 rows over W ranks raise on every rank, as JAX's placement
    raises."""
    W, out = world
    mesh = Mesh(np.asarray(jax.devices()[:W]).reshape(W), ("data",))
    with pytest.raises(ValueError):
        jax.device_put(np.zeros((W + 1, 2)), NamedSharding(mesh, P("data")))
    for _, _, err, _ in out:
        assert f"of {W + 1} rows does not split over {W} devices" in err


def test_model_axis_meshes_match_the_jax_layout(world):
    """A model axis of 2 over W ranks: create_mesh(MeshConfig(model=2))
    is (W/2, 2), as the JAX create_mesh over W devices
    (tests/test_sharded_train.py's case); rank d * 2 + m sits at (d, m),
    the JAX devices.reshape(data, model) layout, so its model group is the
    consecutive ranks {2d, 2d + 1}, and both get the rows of data index d
    (a P("data") placement replicates them over "model"). hybrid_mesh with
    a model axis of 2 is (1, W/2, 2) (tests/test_multihost.py's
    (1, 4, 2) over 8), and at W = 4 with 2 forced replicas (2, 1, 2)."""
    from cocodr_tpu.core.mesh import create_mesh as jax_create_mesh

    W, out = world
    jmesh = jax_create_mesh(JaxMeshConfig(model=2), jax.devices()[:W])
    ids = np.asarray([[d.id for d in row] for row in jmesh.devices])
    for r, (_, _, _, tp) in enumerate(out):
        assert tp["shape"] == tuple(jmesh.devices.shape) == (W // 2, 2)
        assert tp["names"] == ("data", "model")
        d, m = tp["place"]
        assert ids[d, m] == r
        assert tp["model_size"] == 2
        assert tp["model_ranks"] == [2 * d, 2 * d + 1]
        n = 8 // (W // 2)
        np.testing.assert_array_equal(tp["rows"], np.arange(8)[d * n:
                                                              (d + 1) * n])
        assert tp["hybrid"] == (1, W // 2, 2)
        if W == 4:
            assert tp["hybrid_forced"] == (2, 1, 2)


def test_pad_to_multiple_matches_jax():
    from cocodr_tpu.core.mesh import pad_to_multiple

    for n in range(0, 20):
        for m in (1, 3, 8):
            assert tmesh.pad_to_multiple(n, m) == pad_to_multiple(n, m)


def test_a_dead_rank_fails_the_world(tmp_path):
    """A rank that raises ends the world at once (not at the timeout) with
    a RuntimeError naming a rank and carrying a traceback."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank \d died") as e:
        tmesh.spawn(workers.die_on_rank_1, 2, str(tmp_path), timeout=120)
    assert time.monotonic() - t0 < 60
    assert "Traceback" in str(e.value)


def test_a_hung_rank_fails_within_the_join_timeout(tmp_path):
    """A rank that never reaches the barrier: the world is terminated at
    the timeout (8 s here) and the spawner raises; no process is left."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="had not ended after 8"):
        tmesh.spawn(workers.hang_on_rank_1, 2, str(tmp_path), timeout=8)
    assert time.monotonic() - t0 < 40
