"""Data-parallel training: the counterpart of
cocodr_tpu/parallel/sharded_train.py.

The reference trains with DDP (reference ANCE/drivers/run_ann.py:177-184,
833-843); the JAX package jit-compiles the global batch's step under a
mesh and lets GSPMD place the collectives. Here every rank holds the whole
model and optimizer, takes its rows of each global batch (`put_batch`),
and the step of pipelines/train_step.py and pipelines/coco.py computes the
global batch's math explicitly: the gradients' mean over the ranks
(`average_gradients`) before the global-norm clip and the optimizer, the
DRO group statistics from gathered data, the contrastive candidates from
every rank. Parameters, optimizer state and DroState stay bit-identical
on every rank.

With a model axis above 1 (tensor parallelism, parallel/tp.py) each rank
holds its slices of every BertLayer's split weights and their optimizer
state instead: the world's rank 0 supplies the whole parameters, which
every rank receives and cuts to its slices. The M ranks of one data index
take the same rows, and the gradients are averaged over each rank's data
axis, its model column (the ranks that hold the same slices).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from cocodr_tpu_torch.core.mesh import (
    data_group,
    data_size,
    model_size,
    psum,
    shard_batch,
)
from cocodr_tpu_torch.parallel.tp import shard_params_tp, split_optimizer_
from cocodr_tpu_torch.utils.train_state import TrainState


def _broadcast(tensors, mesh) -> None:
    """Rank 0's values of `tensors` to every rank, in place: over the data
    axis, or over the whole world when the model axis splits (the ranks
    then cut their slices from the whole tensors)."""
    if model_size(mesh) > 1:
        group, src = None, 0
    else:
        group = data_group(mesh)
        src = dist.get_global_rank(group, 0)
    for t in tensors:
        dist.broadcast(t.data, src=src, group=group)


def _batch_putter(mesh, device):
    def put_batch(batch: dict) -> dict:
        """A global host batch -> this rank's rows as tensors on the
        model's device."""
        return {k: torch.as_tensor(v).to(device, non_blocking=True)
                for k, v in shard_batch(mesh, batch).items()}

    return put_batch


def _extra_tensors(extra):
    return [] if extra is None else [extra.h_fun, extra.sum_losses,
                                     extra.count_cat]


def shard_train_init(mesh, model, tx, extra=None):
    """A TrainState for a data-parallel run -> (state, put_batch).

    model: a torch module on this rank's device; tx: its optimizer (over
    model.parameters()); extra: the DRO kinds' DroState. The parameters and
    the DroState are broadcast from rank 0, so every rank starts from
    rank 0's values; with a model axis above 1 each rank then cuts its
    slices (parallel/tp.py::shard_params_tp, in place: tx keeps its
    Parameters). put_batch(host batch) gives this rank's rows on the
    model's device (core/mesh.py::shard_batch)."""
    _broadcast(list(model.parameters()) + _extra_tensors(extra), mesh)
    shard_params_tp(model, mesh)
    state = TrainState(model, tx, extra=extra, mesh=mesh)
    device = next(model.parameters()).device
    return state, _batch_putter(mesh, device)


def shard_train_setup(mesh, state: TrainState):
    """Make a loaded or converted TrainState (utils/train_state.py, or
    models/convert.py::load_jax_train_state) data-parallel over the mesh:
    rank 0's parameters, optimizer state and DroState broadcast to every
    rank; with a model axis above 1 each rank then cuts its slices of the
    split parameters and of their optimizer state -> (state, put_batch).
    The state holds whole tensors here (a loaded or converted state)."""
    opt_tensors = [v for st in state.optimizer.state.values()
                   for v in st.values() if isinstance(v, torch.Tensor)]
    _broadcast(list(state.model.parameters()) + opt_tensors
               + _extra_tensors(state.extra), mesh)
    shard_params_tp(state.model, mesh)
    split_optimizer_(state.optimizer)
    state.mesh = mesh
    device = next(state.model.parameters()).device
    return state, _batch_putter(mesh, device)


def global_batch_size(mesh, per_device: int) -> int:
    return per_device * data_size(mesh)


@torch.no_grad()
def average_gradients(params, mesh) -> None:
    """The .grad of params replaced by its mean over the data axis (one
    all-reduce of the flattened gradients, summed then divided by W; a
    world of one leaves them bit-equal). Parameters without a gradient are
    left out, on every rank alike: every loss kind reaches the same
    parameters on every rank."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=data_group(mesh))
    flat.div_(data_size(mesh))
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view_as(g))
        off += n


def mean_over_ranks(mesh, *values):
    """The mean over the data axis of each 0-dim tensor (one all-reduce)
    -> a tuple of 0-dim float32 tensors."""
    flat = psum(torch.stack([torch.as_tensor(v) for v in values]), mesh)
    return tuple((flat / data_size(mesh)).unbind())

