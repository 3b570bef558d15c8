"""Multi-host meshes and the two-level top-k merge: the counterpart of
cocodr_tpu/parallel/multihost.py.

The reference scales by adding NCCL ranks on one fabric, every collective
paying the same links (reference ANCE/drivers/run_ann.py:833-843). Across
hosts the fabric has two tiers, NVLink within a host and the network
between hosts; this module keeps them apart:

- `hybrid_mesh` builds a DeviceMesh whose leading `replica` axis spans
  hosts while `data` and `model` stay within one (torchrun numbers ranks
  host by host, so consecutive ranks share a host);
- `two_level_topk` merges the ranks' top-k candidates within the host
  first (an all-gather of [Q, k'] a rank over `data`), then across hosts
  (an all-gather of only [Q, k] a host over `replica`).

Training needs nothing more: the gradient all-reduce of
parallel/sharded_train.py runs over each model column of the world, and
the model axis (parallel/tp.py) over consecutive ranks of one host.
"""
from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist

from cocodr_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS
from cocodr_tpu_torch.ops.mips import mips_topk
from cocodr_tpu_torch.parallel.topk import distributed_topk

REPLICA_AXIS = "replica"


def n_slices() -> int:
    """Number of hosts of the world: WORLD_SIZE / LOCAL_WORLD_SIZE as
    torchrun sets them, 1 when the environment does not say."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    return max(1, world // max(local, 1))


def hybrid_mesh(data: int = -1, model: int = 1,
                force_replicas: Optional[int] = None, device="cuda"):
    """A DeviceMesh with axes ('replica', 'data', 'model') over the current
    world (a world of one is made when there is none, as in
    core/mesh.py::create_mesh). `replica` spans hosts (n_slices()), or
    `force_replicas` groups of consecutive ranks, which splits one host's
    ranks into pseudo-hosts for tests; data=-1 fills each host's ranks.
    Within a replica the layout is create_mesh's: the `model` ranks of one
    data index are consecutive, so tensor parallelism stays on a host."""
    from torch.distributed.device_mesh import init_device_mesh

    from cocodr_tpu_torch.core.mesh import ensure_world

    dev_type = ensure_world(device).type
    n_dev = dist.get_world_size()
    reps = force_replicas or n_slices()
    per = n_dev // reps
    if reps * per != n_dev:
        raise ValueError(f"{n_dev} devices do not split into {reps} "
                         "replicas")
    if data == -1:
        data = per // model
    if data * model != per:
        raise ValueError(f"mesh {data}x{model} != {per} devices a replica")
    return init_device_mesh(dev_type, (reps, data, model),
                            mesh_dim_names=(REPLICA_AXIS, DATA_AXIS,
                                            MODEL_AXIS))


def two_level_topk(local_vals, local_ids, k: int, mesh,
                   ici_axis: str = DATA_AXIS,
                   dcn_axis: str = REPLICA_AXIS):
    """Merge the ranks' candidates (local_vals, local_ids [Q, k'], global
    ids) over `ici_axis` first, then over `dcn_axis` -> (vals, ids) [Q, k]
    on every rank. The cross-host gather moves [Q, k] a host instead of
    [Q, n_ici * k]; an axis of size 1 is a gather of one."""
    vals, ids = distributed_topk(local_vals, local_ids, k,
                                 mesh.get_group(ici_axis))
    return distributed_topk(vals, ids, k, mesh.get_group(dcn_axis))


def sharded_mips_topk_2level(queries, corpus_shard, shard_offset: int,
                             k: int, mesh, ici_axis: str = DATA_AXIS,
                             dcn_axis: str = REPLICA_AXIS, **mips_kw):
    """One rank's part: the exact top-k of its shard (ops.mips.mips_topk,
    the corpus sharded over both axes), ids lifted by shard_offset, then
    the two-level merge."""
    vals, ids = mips_topk(queries, corpus_shard, k, **mips_kw)
    ids = ids.long()
    ids = ids.where(ids < 0, ids + shard_offset)
    return two_level_topk(vals.float(), ids, k, mesh, ici_axis, dcn_axis)
