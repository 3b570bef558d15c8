"""The training step of the dual-encoder stages: the counterpart of
cocodr_tpu/pipelines/train_step.py for the loss kinds

- 'nll': the triplet 2-way NLL with optional per-sample weights (the BM25
  warmup);
- 'nll_multichunk': the same over multi-chunk documents (a
  `rdot_nll_multi_chunk` model, documents [B, C * chunk_len]): a
  document scores by its best real chunk, a chunk being real iff its mask
  sums above 0 (reference NLL_MultiChunk, ANCE/model/models.py:307-399);
- 'dro-greedy': the DRO-greedy robust loss over query groups, the
  per-sample weights applied inside it;
- 'idro': iDRO, whose per-group gradients over the last K encoder layers
  feed the multiplicative weight update (reference
  ANCE/model/dro_loss.py:174-254); the weights are ignored, as in the JAX
  step. It takes every model type, multi-chunk documents included.

A step runs three tower forwards (query, positive, negative), the loss,
the backward, clipping by global norm with optax's rule, and one optimizer
update. The DRO kinds read and replace `state.extra`, a losses.dro.DroState.
'nll' and 'dro-greedy' raise ValueError on multi-chunk documents, which
the JAX step would feed to the single-vector NLL.

The iDRO group pass takes the reference's route rather than the JAX
package's per-sample Gram (`vmap` cannot batch through the kernels'
torch.autograd.Functions): G vector-Jacobian products of the per-sample
losses on the step's own graph, one per group present in the batch, each
restricted to the last K layers' parameters (`losses/dro.py::
per_group_grads`) of the query tower and, for a two-tower model, of the
document tower too; then one backward with the robust loss's cotangent
h_pre[g_i] / count[g_i] (the PRE-update weights) for the training
gradient. With dropout off this equals the JAX Gram path up to float
rounding. With dropout on, the products reuse the forward's masks, as the
reference does, where the JAX package re-runs the top K layers with fresh
masks; either way the group gradients feed an EMA'd weight update. The
models that the JAX package sends to its lane step (two towers, chunk_len,
the tanh pooler) keep the group rows in idro_lane_grad_dtype here too.
Under remat (models/bert.py) each tower's last K layers run without it in
an iDRO step (`no_remat_last`), so the G products read their stored
activations, as the JAX package's group pass runs with remat=False.

Dropout: a step takes three torch.Generators, one per tower, as the JAX
step folds the tower index 0/1/2 into its key, so the positive and
negative towers draw independent masks; `dropout_generators` seeds them
from (seed, step, tower), and on a data-parallel rank r > 0 from a child
sequence of those seeds, so that ranks draw different masks while rank 0
draws the single-device ones. Without generators the model runs in eval
mode (the JAX step's deterministic=True) and draws nothing.

Data parallelism: a state made by parallel/sharded_train.py carries its
mesh, each rank holds its rows of the global batch, and the step computes
the global batch's math, as the JAX step does under a mesh: the gradients'
mean over the ranks before the clip ('nll' and DRO-greedy: each rank's
mean loss; iDRO: the cotangents h_pre[g_i] / count[g_i] of the global
counts, times W); DRO-greedy's state from the all-gathered losses and
groups; iDRO's rows against the global counts, summed over the ranks
(losses/dro.py's axis forms; the rows take float32 rows, not the Gram);
the metrics those of the global batch.

Tensor parallelism (a mesh whose model axis is above 1, parallel/tp.py):
the clip's global norm sums the split parameters' squared norms over the
model axis and counts the replicated ones once; the iDRO group pass puts
the split parameters' columns first in its rows and sums their part of
the row norms and Gram entries over the model axis (losses/dro.py's
`split`), so the weight update is the unsplit model's.

Every loss kind reaches every parameter of the dual encoder (both towers
and poolers of a two-tower model), so the port's Lamb, which skips a None
gradient where optax would decay the moments, updates every parameter as
optax does.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from cocodr_tpu_torch.core.mesh import data_size, psum
from cocodr_tpu_torch.losses.dro import (
    DroConfig,
    _segment_sum,
    dro_greedy_loss,
    gram,
    idro_loss,
    per_group_grads,
)
from cocodr_tpu_torch.losses.nll import triplet_nll, triplet_nll_multichunk
from cocodr_tpu_torch.parallel.sharded_train import (
    average_gradients,
    mean_over_ranks,
)
from cocodr_tpu_torch.parallel.tp import model_sum_sq, split_axis, split_dim
from cocodr_tpu_torch.utils.logging import span
from cocodr_tpu_torch.utils.train_state import TrainState

DRO_KINDS = ("dro-greedy", "idro")


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    loss_kind: str = "nll"  # 'nll' | 'nll_multichunk' | 'dro-greedy' | 'idro'
    dro: Optional[DroConfig] = None
    max_grad_norm: float = 1.0  # 0 disables clipping
    # base: last 3; large: last 2 (reference dro_loss.py:179-183); clamped
    # to the model's depth
    idro_last_k_layers: int = 3
    # the JAX package's lane group pass: the per-group rows are stored in
    # idro_lane_grad_dtype and idro_loss reads the rows; off: float32 rows
    # and their Gram matrix, the JAX default's numerics
    idro_lane_group_pass: bool = False
    # accepted so that a JAX config's fields carry over; it has no effect
    # here, where each group's row is written as soon as its product returns
    idro_lane_chunk: int = 8
    idro_lane_grad_dtype: str = "bfloat16"


def dropout_generators(seed: int, step: int, device, rank: int = 0) -> tuple:
    """Three torch.Generators on `device`, one per tower, seeded from
    (seed, step, tower): a resumed run draws the same masks at the same
    step. rank > 0 (a data-parallel rank) seeds from the child sequence
    `rank` of each; rank 0 draws the single-device masks."""
    gens = []
    for tower in range(3):
        ss = np.random.SeedSequence([seed, step, tower],
                                    spawn_key=(rank,) if rank else ())
        g = torch.Generator(device=device)
        g.manual_seed(int(ss.generate_state(1, np.uint64)[0] >> 1))
        gens.append(g)
    return tuple(gens)


def embed_triplet(model, batch, generators: Optional[Sequence] = None):
    """The three towers' embeddings, each tower drawing dropout from its own
    generator (None: eval mode)."""
    model.train(generators is not None)
    g = generators or (None, None, None)
    q = model.query_emb(batch["q_ids"], batch["q_mask"], generator=g[0])
    a = model.body_emb(batch["pos_ids"], batch["pos_mask"], generator=g[1])
    b = model.body_emb(batch["neg_ids"], batch["neg_mask"], generator=g[2])
    return q, a, b


def chunked(model, batch) -> bool:
    """True when the batch's documents are multi-chunk for this model
    (wider than its chunk_len, DualEncoder.body_emb's dispatch)."""
    chunk_len = getattr(model.cfg, "chunk_len", 0)
    return bool(chunk_len) and batch["pos_ids"].shape[1] > chunk_len


def _chunk_mask(mask, C):
    """[B, C * L] token mask -> [B, C]: a chunk is real iff its mask sums
    above 0."""
    return mask.reshape(mask.shape[0], C, -1).sum(-1) > 0


def triplet_losses(model, batch, generators=None):
    """-> (per-sample NLL [B], mean accuracy), unweighted; multi-chunk
    documents score by their best real chunk."""
    q, a, b = embed_triplet(model, batch, generators)
    if a.dim() == 3:
        C = a.shape[1]
        losses, acc, _ = triplet_nll_multichunk(
            q, a, _chunk_mask(batch["pos_mask"], C),
            b, _chunk_mask(batch["neg_mask"], C))
    else:
        losses, acc, _ = triplet_nll(q, a, b)
    return losses, acc.mean()


def nll_loss(model, batch, generators=None):
    """-> (mean loss, mean accuracy), the loss weighted per sample by
    batch["weights"] when the batch has them."""
    losses, acc = triplet_losses(model, batch, generators)
    w = batch.get("weights")
    if w is not None:
        losses = losses * w
    return losses.mean(), acc


def _require_chunks(kind: str, model, batch, want: bool) -> None:
    if chunked(model, batch) != want:
        raise ValueError(
            f"loss_kind {kind!r} takes {'only' if want else 'no'} "
            f"multi-chunk documents (an rdot_nll_multi_chunk model with "
            f"documents wider than chunk_len), as in the JAX package"
            + ("" if want else "; use 'nll_multichunk' or 'idro'"))


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the .grad of params, in place: the
    gradients stay as they are when their global norm is below max_norm,
    else each becomes g / norm * max_norm (torch's clip_grad_norm_
    multiplies by max_norm / (norm + 1e-6) instead). A split parameter's
    squared norm is summed over its model axis first. -> the norm."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    sq = torch.stack([g.float().square().sum() for g in grads])
    norm = model_sum_sq(params, sq).sum().sqrt()
    keep = norm < max_norm
    one = torch.ones_like(norm)
    div = torch.where(keep, one, norm)
    mul = torch.where(keep, one, torch.full_like(norm, max_norm))
    for g in grads:  # g / 1 * 1 leaves g bit-equal
        g.div_(div).mul_(mul)
    return norm


def apply_gradients(state: TrainState, max_grad_norm: float) -> None:
    """Clip the model's gradients, take one optimizer step (an update, or
    with optim.MultiSteps an accumulation that updates every k-th time),
    count the micro-batch. A data-parallel state first replaces the
    gradients by their mean over the ranks, so that the clip's global norm
    is the global batch's. Span `cocodr.coco.update`."""
    with span("cocodr.coco.update"):
        if state.mesh is not None:
            average_gradients(state.model.parameters(), state.mesh)
        if max_grad_norm > 0:
            clip_by_global_norm_(state.model.parameters(), max_grad_norm)
        state.optimizer.step()
        state.step += 1


def last_k_layers(model, k: int) -> list:
    """The parameters of the encoder's last min(k, depth) layers, then,
    for a two-tower model, those of doc_encoder's (the JAX lane step's
    diff["q"] and diff["d"]): a model no deeper than k gives every layer,
    as the reference's last-k selection degenerates to the whole stack
    (the JAX package clamps K to the depth the same way). Poolers and
    heads stay out, as in the JAX group passes. A split model's split
    parameters come first, in the same order (`split_columns`)."""
    if k <= 0:
        raise ValueError("idro needs idro_last_k_layers > 0")
    towers = [model.encoder]
    if getattr(model, "doc_encoder", None) is not None:
        towers.append(model.doc_encoder)
    params = [p for tower in towers for layer in tower.encoder.layer[-k:]
              for p in layer.parameters()]
    return ([p for p in params if split_dim(p) is not None]
            + [p for p in params if split_dim(p) is None])


def split_columns(params):
    """(the row columns that split parameters fill, first, their model
    axis) for losses/dro.py's `split`; None for a whole model."""
    axis = split_axis(params)
    if axis is None:
        return None
    return sum(p.numel() for p in params if split_dim(p) is not None), axis


@contextlib.contextmanager
def no_remat_last(model, k: int):
    """Inside the block, each tower's last min(k, depth) layers run without
    remat: the iDRO group pass takes its G products through them, which
    would otherwise recompute them once a product (the JAX package runs
    its K-layer group pass with remat=False)."""
    towers = [model.encoder]
    if getattr(model, "doc_encoder", None) is not None:
        towers.append(model.doc_encoder)
    encoders = [t.encoder for t in towers]
    try:
        for enc in encoders:
            enc.no_remat_last = k
        yield
    finally:
        for enc in encoders:
            enc.no_remat_last = 0


def lane_group_pass(model, cfg: TrainStepConfig) -> bool:
    """The JAX package's routing: the lane step (rows in
    idro_lane_grad_dtype) when asked, and for every model its Gram path
    cannot take: two towers, chunk_len, the tanh pooler."""
    mcfg = model.cfg
    return (cfg.idro_lane_group_pass or mcfg.two_tower
            or bool(mcfg.chunk_len) or mcfg.pooling not in ("cls", "mean"))


def group_gram(model, losses, groups, cfg: TrainStepConfig):
    """The [G, G] float32 Gram matrix of the group rows: one product per
    group present against the last K layers' parameters, in float32."""
    params = last_k_layers(model, cfg.idro_last_k_layers)
    return gram(per_group_grads(losses, params, groups, cfg.dro.n_groups),
                split_columns(params))


def idro_group_pass(model, losses, groups, dstate, cfg: TrainStepConfig):
    """The iDRO weight update from the per-sample losses' graph ->
    (robust loss, new DroState, (group_losses, group_counts)):
    losses/dro.py::idro_loss on the float32 rows' Gram matrix, or on the
    rows themselves in idro_lane_grad_dtype for the lane config and the
    models the JAX package sends to its lane step (`lane_group_pass`)."""
    if lane_group_pass(model, cfg):
        params = last_k_layers(model, cfg.idro_last_k_layers)
        rows = per_group_grads(
            losses, params, groups, cfg.dro.n_groups,
            store_dtype=getattr(torch, cfg.idro_lane_grad_dtype))
        return idro_loss(losses.detach(), groups, dstate, cfg.dro,
                         group_grads=rows, split=split_columns(params))
    return idro_loss(losses.detach(), groups, dstate, cfg.dro,
                     group_gram=group_gram(model, losses, groups, cfg))


def idro_backward(losses, groups, h_pre, group_counts,
                  scale: float = 1.0) -> None:
    """The training gradient of the iDRO robust loss sum_g gl_g h_pre[g]:
    one backward of the per-sample losses with the cotangent
    h_pre[g_i] / count[g_i], the pre-update weights (times `scale`: a
    data-parallel step's W, which the mean over the ranks divides out)."""
    g = torch.as_tensor(groups, device=losses.device).long()
    ct = h_pre[g] / group_counts.clamp_min(1.0)[g]
    if scale != 1.0:
        ct = ct * scale
    losses.backward(ct.to(losses.dtype))


def idro_group_pass_dp(model, losses, groups, dstate, cfg: TrainStepConfig,
                       mesh):
    """The data-parallel iDRO weight update: the global counts, each
    rank's rows against them (per_group_grads(counts=)), and
    losses/dro.py::idro_loss over the data axis, which sums the rows (in
    float32), the counts and the weighted group losses -> (global robust
    loss, new DroState, (global group losses, global counts)). The lane
    models keep each rank's rows, and their sum, in idro_lane_grad_dtype;
    the others float32 rows (the Gram form takes no axis)."""
    G = cfg.dro.n_groups
    counts = _segment_sum(torch.ones_like(losses.detach()), groups, G)
    store = (getattr(torch, cfg.idro_lane_grad_dtype)
             if lane_group_pass(model, cfg) else None)
    params = last_k_layers(model, cfg.idro_last_k_layers)
    rows = per_group_grads(losses, params, groups, G, store_dtype=store,
                           counts=psum(counts, mesh))
    _, new_state, (gl_agg, gc) = idro_loss(losses.detach(), groups, dstate,
                                           cfg.dro, group_grads=rows,
                                           axis_name=mesh,
                                           split=split_columns(params))
    return (gl_agg * dstate.h_fun).sum(), new_state, (gl_agg, gc)


def build_train_step(cfg: TrainStepConfig = TrainStepConfig()) -> Callable:
    """-> train_step(state, batch, generators=None); the state is updated in
    place. 'nll' returns (loss, acc), 0-dim tensors on the model's device;
    the DRO kinds return the JAX step's metrics dict: loss, acc,
    group_losses [G] and group_counts [G].

    batch: q_ids/q_mask/pos_ids/pos_mask/neg_ids/neg_mask [B, S] tensors on
    the model's device (queries and documents may differ in S; multi-chunk
    documents are [B, C * chunk_len]), optional weights [B], and for the
    DRO kinds groups [B] (ints < n_groups)."""
    if cfg.loss_kind in ("nll", "nll_multichunk"):
        multichunk = cfg.loss_kind == "nll_multichunk"

        def train_step(state: TrainState, batch, generators=None):
            _require_chunks(cfg.loss_kind, state.model, batch, multichunk)
            state.optimizer.zero_grad(set_to_none=True)
            loss, acc = nll_loss(state.model, batch, generators)
            loss.backward()
            apply_gradients(state, cfg.max_grad_norm)
            if state.mesh is not None:
                return mean_over_ranks(state.mesh, loss.detach(), acc)
            return loss.detach(), acc

        return train_step
    if cfg.loss_kind not in DRO_KINDS:
        raise ValueError(cfg.loss_kind)
    if cfg.dro is None:
        raise ValueError(f"loss_kind {cfg.loss_kind!r} needs "
                         "TrainStepConfig.dro (a losses.dro.DroConfig)")

    def metrics(loss, acc, gl, gc):
        return {"loss": loss.detach(), "acc": acc, "group_losses": gl,
                "group_counts": gc}

    def global_metrics(mesh, loss, acc, gl, gc):
        """The global batch's metrics from the ranks': mean loss and
        accuracy, summed counts, count-weighted group means."""
        loss, acc = mean_over_ranks(mesh, loss.detach(), acc)
        agg = psum(torch.stack([gc, gl * gc]), mesh)
        return metrics(loss, acc, agg[1] / agg[0].clamp_min(1.0), agg[0])

    if cfg.loss_kind == "dro-greedy":
        def train_step(state: TrainState, batch, generators=None):
            _require_chunks(cfg.loss_kind, state.model, batch, False)
            state.optimizer.zero_grad(set_to_none=True)
            losses, acc = triplet_losses(state.model, batch, generators)
            robust, dstate, (gl, gc) = dro_greedy_loss(
                losses, batch["groups"], state.extra, cfg.dro,
                weights=batch.get("weights"), axis_name=state.mesh)
            robust.backward()
            apply_gradients(state, cfg.max_grad_norm)
            state.extra = dstate
            if state.mesh is not None:
                return global_metrics(state.mesh, robust, acc, gl, gc)
            return metrics(robust, acc, gl, gc)

        return train_step

    def train_step(state: TrainState, batch, generators=None):
        state.optimizer.zero_grad(set_to_none=True)
        with no_remat_last(state.model, cfg.idro_last_k_layers):
            losses, acc = triplet_losses(state.model, batch, generators)
        if state.mesh is None:
            robust, dstate, (gl, gc) = idro_group_pass(
                state.model, losses, batch["groups"], state.extra, cfg)
        else:
            robust, dstate, (gl, gc) = idro_group_pass_dp(
                state.model, losses, batch["groups"], state.extra, cfg,
                state.mesh)
            (acc,) = mean_over_ranks(state.mesh, acc)
        idro_backward(losses, batch["groups"], state.extra.h_fun, gc,
                      scale=float(data_size(state.mesh)))
        apply_gradients(state, cfg.max_grad_norm)
        state.extra = dstate
        return metrics(robust, acc, gl, gc)

    return train_step
