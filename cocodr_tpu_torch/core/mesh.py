"""Device mesh and process world: the counterpart of cocodr_tpu/core/mesh.py.

The JAX package has one controller that sees every device; PyTorch runs
one process a device, joined by torch.distributed. The mesh is a
`torch.distributed.device_mesh.DeviceMesh` of shape (data, model) with the
JAX axis names; every collective of the port runs over its data axis.

How the world of processes is made:
- on the card, by torchrun (`init_world`: RANK, WORLD_SIZE and LOCAL_RANK
  from the environment, backend nccl, one card a process);
- on the CPU, by `spawn`: N processes joined over gloo through a FileStore
  in a directory the caller names (no TCP port, so that concurrent test
  workers cannot collide);
- a world of one, by `create_mesh` itself when no world exists, from a
  `torch.distributed.HashStore`: a library caller needs no environment.

Axes:
  data   batch and corpus sharding (the reference's only parallelism,
         DDP). Each rank holds rows [r * B / W, (r + 1) * B / W) of a
         global batch of B rows (`shard_batch`), the rows a
         `jax.device_put(x, NamedSharding(mesh, P("data")))` gives device r.
  model  tensor parallelism (parallel/tp.py): the Megatron split of every
         BERT layer's weights over M ranks. The device layout is the JAX
         package's reshape(data, model): global rank = d * M + m, so the M
         ranks of one data index are consecutive and get the same rows of
         a batch; the data axis of model rank m (its "model column") is
         the ranks m, M + m, 2M + m, ...

Only rank 0 writes files (checkpoints, ann files, eval outputs, logs);
the others wait at a barrier (`rank_zero_first`, `is_writer`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import multiprocessing
import os
import signal
import time
import traceback
import uuid
from typing import Callable, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1  # -1: all remaining devices
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = self.model
        data = self.data if self.data > 0 else n_devices // model
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} != {n_devices} devices"
            )
        return data, model


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def ensure_world(device="cuda") -> torch.device:
    """`device` resolved (ops/_device.py); with no world yet, a world of
    one is made from a HashStore (nccl on the card, gloo on the CPU)."""
    from cocodr_tpu_torch.ops._device import resolve_device

    dev = resolve_device(device)
    if dist.is_initialized():
        return dev
    kw = {}
    if dev.type == "cuda":  # the world's card: the current one by default
        dev = torch.device("cuda", torch.cuda.current_device()
                           if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(_backend(dev.type), store=dist.HashStore(),
                            rank=0, world_size=1, **kw)
    return dev


def create_mesh(config: MeshConfig = MeshConfig(), device="cuda"):
    """A (data, model) DeviceMesh over the current world, on `device`'s
    type (the card unless the caller passes device="cpu"): global rank
    d * model + m sits at (d, m), as the JAX package's
    devices.reshape(data, model). With no world yet, a world of one is made
    here (nccl on the card, gloo on the CPU). A shape that does not fill
    the world raises MeshConfig.resolve's ValueError before any world is
    made. Every rank must call it, in the same order (its groups are made
    collectively)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    data, model = config.resolve(n)
    dev = ensure_world(device)
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def data_group(mesh):
    """The process group of the mesh's data axis."""
    return mesh.get_group(DATA_AXIS)


def axis_group(axis):
    """A DeviceMesh (its data axis) or a ProcessGroup -> the group."""
    if hasattr(axis, "get_group"):
        return data_group(axis)
    return axis


def model_group(mesh):
    """The process group of the mesh's model axis: the M ranks that hold
    the slices of one set of weights."""
    return mesh.get_group(MODEL_AXIS)


def model_size(mesh) -> int:
    """Ranks on the model axis; 1 without a mesh."""
    return 1 if mesh is None else mesh[MODEL_AXIS].size()


def model_rank(mesh) -> int:
    """This process's place on the model axis; 0 without a mesh."""
    return 0 if mesh is None else mesh.get_local_rank(MODEL_AXIS)


def data_size(mesh) -> int:
    """Ranks on the data axis; 1 without a mesh."""
    return 1 if mesh is None else mesh[DATA_AXIS].size()


def data_rank(mesh) -> int:
    """This process's place on the data axis; 0 without a mesh."""
    return 0 if mesh is None else mesh.get_local_rank(DATA_AXIS)


def gather_rows(x, axis):
    """x [B, ...] of every rank of `axis` (a DeviceMesh's data axis or a
    process group), concatenated in rank order; no gradient. Without an
    axis (None), x itself."""
    if axis is None:
        return x
    group = axis_group(axis)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def psum(x, axis):
    """The sum of x over the ranks of `axis`, in float32 -> a new tensor
    (x itself is left as it is). Without an axis (None), x's own value."""
    out = x.detach().float().clone()
    if axis is not None:
        dist.all_reduce(out, group=axis_group(axis))
    return out


def is_writer(mesh=None) -> bool:
    """True where a call writes its files: without a mesh every process
    writes its own call's, with one only rank 0 of the world."""
    return mesh is None or dist.get_rank() == 0


def barrier(mesh=None) -> None:
    """Every rank of the mesh's world waits for the others; no mesh, no
    wait."""
    if mesh is not None:
        dist.barrier()


@contextlib.contextmanager
def rank_zero_first(mesh=None):
    """With a mesh, rank 0 runs the block first and the others wait at a
    barrier, then run it (a block that writes files once and reads them
    after); without one, the block runs."""
    if mesh is None:
        yield
        return
    if dist.get_rank() != 0:
        dist.barrier()
    yield
    if dist.get_rank() == 0:
        dist.barrier()


def shard_batch(mesh, batch: dict) -> dict:
    """This rank's rows of a global host batch (numpy arrays or tensors):
    rows [r * B / W, (r + 1) * B / W) of each, r the data rank and W the
    data axis's size; the ranks of one data index (its model axis) get the
    same rows, as P("data") replicates them over "model". A batch that W
    does not divide raises, as a jax.device_put onto P("data") does."""
    W, r = data_size(mesh), data_rank(mesh)
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % W:
            raise ValueError(
                f"batch {k!r} of {B} rows does not split over {W} devices "
                f"of the {DATA_AXIS!r} axis"
            )
        n = B // W
        out[k] = v[r * n:(r + 1) * n]
    return out


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def init_world(backend: Optional[str] = None, timeout: float = 1800.0):
    """Join the world torchrun describes (RANK, WORLD_SIZE, LOCAL_RANK and
    MASTER_ADDR / MASTER_PORT in the environment). backend None: nccl when
    a card is present, with torch.cuda.set_device(LOCAL_RANK), else gloo.
    -> the global rank."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(kw["device_id"])
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method="env://",
            timeout=datetime.timedelta(seconds=timeout), **kw)
    return dist.get_rank()


def _rank_entry(rank, world_size, store_path, result_dir, timeout, fn, args):
    err_path = os.path.join(result_dir, f"error-{rank}.txt")
    if rank:  # an interrupt stops rank 0; the others follow its lead
        signal.signal(signal.SIGINT, signal.SIG_IGN)
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world_size), rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        out = fn(*args)
        torch.save(out, os.path.join(result_dir, f"result-{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(err_path, "w") as f:
            f.write(traceback.format_exc())
        raise


def _wait(procs, deadline):
    """Poll the ranks -> (the first rank that died or None, the ranks
    still running at the deadline or None)."""
    while True:
        codes = [p.exitcode for p in procs]
        failed = next((r for r, c in enumerate(codes)
                       if c not in (None, 0)), None)
        if failed is not None or all(c == 0 for c in codes):
            return failed, None
        if time.monotonic() > deadline:
            return None, [r for r, c in enumerate(codes) if c is None]
        time.sleep(0.05)


def spawn(fn: Callable, world_size: int, store_dir: str, *args,
          timeout: float = 600.0) -> list:
    """Run fn(*args) on world_size new CPU processes joined over gloo (one
    thread each; their FileStore lives in store_dir) -> the list of the
    ranks' return values, by rank. fn must be importable by name (a
    module-level function). Every rank is joined within `timeout` seconds:
    a rank that dies, or a world that has not ended by then (a hung
    collective), has every rank terminated and raises RuntimeError naming
    the rank, with its traceback when it wrote one. An interrupt of the
    caller is passed to rank 0 alone (the other ranks ignore SIGINT and
    end as rank 0's work ends, as a served command's followers do), and
    the ranks are waited for again."""
    os.makedirs(store_dir, exist_ok=True)
    tag = uuid.uuid4().hex
    store_path = os.path.join(store_dir, f"store-{tag}")
    result_dir = os.path.join(store_dir, f"ranks-{tag}")
    os.makedirs(result_dir)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world_size, store_path, result_dir,
                               timeout, fn, args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        try:
            failed, hung = _wait(procs, deadline)
        except KeyboardInterrupt:
            if procs[0].exitcode is None:
                os.kill(procs[0].pid, signal.SIGINT)
            failed, hung = _wait(procs, deadline)
    finally:  # also on an interrupt: no rank outlives the call
        for p in procs:
            if p.exitcode is None:
                p.terminate()
        for p in procs:
            p.join(5)
            if p.exitcode is None:
                p.kill()
                p.join()
    if failed is not None:
        err = os.path.join(result_dir, f"error-{failed}.txt")
        tb = open(err).read() if os.path.exists(err) else ""
        raise RuntimeError(
            f"spawned world of {world_size}: rank {failed} died with exit "
            f"code {procs[failed].exitcode}\n{tb}")
    if hung:
        raise RuntimeError(
            f"spawned world of {world_size}: ranks {hung} had not ended "
            f"after {timeout} s (a hung collective?) and were terminated")
    return [torch.load(os.path.join(result_dir, f"result-{r}.pt"),
                       weights_only=False) for r in range(world_size)]
