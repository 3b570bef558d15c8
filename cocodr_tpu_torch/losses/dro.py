"""Distributionally robust group reweighting, DRO-greedy and iDRO: the
counterpart of cocodr_tpu/losses/dro.py (reference
ANCE/model/dro_loss.py:11-254).

The reference's module buffers (h_fun, sum_losses, count_cat) are an
explicit `DroState` of three float32 [G] tensors, as in the JAX package,
and every function returns a new state instead of updating one in place.
Segment sums are products with a one-hot [B, G] matrix.

The per-group gradients are the reference's route
(ANCE/model/dro_loss.py:174-204): one `torch.autograd.grad` of the
per-sample losses per group, each with that group's mean as cotangent, on
the step's own graph. The JAX package batches those G pullbacks with
`vmap`; the port's kernels (K1, K5, K8) are launched inside
`torch.autograd.Function`s that `torch.func.vmap` cannot batch through.

`axis_name` (the JAX package's all-gather / psum over a mesh axis) has no
single-device meaning: passing one raises, naming ROADMAP.md Queue 1
item 11.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from cocodr_tpu_torch.ops._device import resolve_device

# columns of the [G, P] rows a Gram or norm pass turns to float32 at a time
_GRAM_COLUMNS = 1 << 20


@dataclasses.dataclass(frozen=True)
class DroConfig:
    n_groups: int = 50
    alpha: float = 0.25
    eps: float = 0.01
    ema: float = 0.1
    rho: float = 0.05  # iDRO exponentiated-update step
    weight_ema: bool = False  # greedy: EMA-blend the new h_fun
    weight_cutoff: bool = True  # greedy weight_ema: clamp at eps


@dataclasses.dataclass
class DroState:
    h_fun: torch.Tensor  # [G] group weights
    sum_losses: torch.Tensor  # [G] EMA of group mean losses
    count_cat: torch.Tensor  # [G] EMA of group batch counts

    def replace(self, **changes) -> "DroState":
        return dataclasses.replace(self, **changes)


def dro_greedy_init(cfg: DroConfig, device="cuda") -> DroState:
    dev = resolve_device(device)
    g = cfg.n_groups
    return DroState(
        h_fun=torch.ones(g, dtype=torch.float32, device=dev),
        sum_losses=torch.zeros(g, dtype=torch.float32, device=dev),
        count_cat=torch.ones(g, dtype=torch.float32, device=dev),
    )


idro_init = dro_greedy_init


def _no_axis(axis_name):
    if axis_name is not None:
        raise NotImplementedError(
            "axis_name (a reduction over a mesh axis) is not ported yet: "
            "ROADMAP.md Queue 1 item 11 (parallel/*)"
        )


def _onehot(groups, n: int):
    return F.one_hot(torch.as_tensor(groups).long(), n).to(torch.float32)


def _segment_sum(x, groups, n: int):
    """sum of x [B] by group -> [G] (jax.ops.segment_sum)."""
    return x @ _onehot(groups, n).to(x.device, x.dtype)


def _greedy_h_fun(cfg: DroConfig, state: DroState) -> torch.Tensor:
    """alpha-cutoff weight update (`update_mw`, reference
    dro_loss.py:90-120): groups sorted by running loss, descending; weight
    1/alpha for the groups whose cumulative population fraction stays
    under alpha, a fractional weight for the group at the cutoff, eps
    elsewhere. No host synchronisation."""
    G = cfg.n_groups
    past_frac = state.count_cat / state.count_cat.sum()
    sort_id = torch.argsort(-state.sum_losses, stable=True)
    sorted_frac = past_frac[sort_id]
    cum = torch.cumsum(sorted_frac, 0)
    cutoff = (cum < cfg.alpha).sum().clamp(max=G - 1)
    ranks = torch.arange(G, device=cum.device)
    head = ranks < cutoff
    h_sorted = torch.where(head, 1.0 / cfg.alpha, cfg.eps).to(torch.float32)
    head_mass = torch.where(head, sorted_frac, 0.0).sum()
    leftover = 1.0 - head_mass / cfg.alpha
    tiebreak = (leftover / sorted_frac[cutoff]).clamp_min(cfg.eps)
    h_sorted = torch.where(ranks == cutoff, tiebreak, h_sorted)
    h_new = torch.empty_like(h_sorted).scatter_(0, sort_id, h_sorted)
    if cfg.weight_ema:
        if cfg.weight_cutoff:
            h_new = h_new.clamp_min(cfg.eps)
        h_new = state.h_fun * (1 - cfg.ema) + h_new * cfg.ema
    return h_new


def dro_greedy_loss(losses, groups, state: DroState, cfg: DroConfig,
                    weights=None, axis_name: Optional[str] = None,
                    training: bool = True):
    """DRO-greedy robust loss (reference dro_loss.py:49-88).

    losses [B] per sample (gradients flow), groups [B] int, weights [B]
    optional. -> (robust_loss, new_state, (group_losses, group_counts)),
    the group statistics being this batch's means and counts, as the
    reference returns them."""
    _no_axis(axis_name)
    if weights is not None:
        losses = losses * weights
    B = losses.shape[0]
    G = cfg.n_groups
    robust = (_segment_sum(losses, groups, G) * state.h_fun).sum() / B

    l_det = losses.detach()
    counts = _segment_sum(torch.ones_like(l_det), groups, G)
    means = _segment_sum(l_det, groups, G) / counts.clamp_min(1.0)
    new_state = state
    if training:
        sum_losses = torch.where(
            counts > 0, state.sum_losses * (1 - cfg.ema) + means * cfg.ema,
            state.sum_losses)
        count_cat = state.count_cat * (1 - cfg.ema) + counts * cfg.ema
        interim = DroState(state.h_fun, sum_losses, count_cat)
        new_state = interim.replace(h_fun=_greedy_h_fun(cfg, interim))
    return robust, new_state, (means, counts)


def per_group_grads(losses, params: Sequence[torch.Tensor], groups,
                    n_groups: int, store_dtype=None):
    """Gradients of each group's mean loss against `params`, flattened ->
    [G, P] (P the params' total size), in store_dtype (default float32).

    losses [B] are per-sample losses whose graph reaches `params`. Group
    g's row is the vector-Jacobian product of `losses` with the cotangent
    1[groups == g] / count_g (the JAX package's cotangents): one
    `torch.autograd.grad` each, on the retained graph, which runs only the
    part of the graph between `losses` and `params`. Each product is
    written into its row as soon as it returns, cast as the JAX rows are
    (round to nearest even), so one product's float32 gradients are held
    at a time beside the [G, P] rows; the JAX lane pass's chunks
    (`lane_chunk`) bound the products its vmap holds at once and have no
    counterpart here. A group with no sample in the batch keeps a zero row
    without a product (its JAX row is exactly zero)."""
    params = list(params)
    onehot = _onehot(groups, n_groups).to(losses.device)  # [B, G]
    counts = onehot.sum(0)
    cotangents = (onehot / counts.clamp_min(1.0)).t().to(losses.dtype)
    sizes = [p.numel() for p in params]
    out = torch.zeros((n_groups, sum(sizes)),
                      dtype=store_dtype or torch.float32,
                      device=losses.device)
    for g in torch.nonzero(counts > 0).flatten().tolist():
        row = torch.autograd.grad(losses, params, grad_outputs=cotangents[g],
                                  retain_graph=True, allow_unused=True)
        off = 0
        for grad, n in zip(row, sizes):
            if grad is not None:
                out[g, off:off + n].copy_(grad.reshape(-1))
            off += n
        del row  # freed before the next product is allocated
    return out


def _row_norms(rows) -> torch.Tensor:
    """|row| of [G, P] rows in float32 sums, a block of columns at a time
    (no float32 copy of bf16 rows) -> [G, 1]."""
    acc = torch.zeros((rows.shape[0], 1), dtype=torch.float32,
                      device=rows.device)
    for c in range(0, rows.shape[1], _GRAM_COLUMNS):
        acc += rows[:, c:c + _GRAM_COLUMNS].float().square().sum(
            -1, keepdim=True)
    return acc.sqrt()


def gram(rows) -> torch.Tensor:
    """rows @ rows.T in float32 sums of the rows' products, a block of
    columns at a time -> [G, G] float32 (bf16 rows: the products of bf16
    values are exact in float32, the sums float32, as the JAX package's
    matmul with preferred_element_type=float32)."""
    acc = torch.zeros((rows.shape[0], rows.shape[0]), dtype=torch.float32,
                      device=rows.device)
    for c in range(0, rows.shape[1], _GRAM_COLUMNS):
        blk = rows[:, c:c + _GRAM_COLUMNS].float()
        acc += blk @ blk.t()
    return acc


def idro_loss(losses, groups, state: DroState, cfg: DroConfig,
              group_grads=None, axis_name: Optional[str] = None,
              group_gram=None):
    """iDRO robust loss and its multiplicative exponentiated weight update
    (reference dro_loss.py:216-254) -> (robust_loss, new_state,
    (group_losses, group_counts)).

    losses [B] (gradients flow); pass exactly one of group_grads [G, P]
    (per_group_grads; rows in float32 or bf16) and group_gram [G, G] (its
    Gram matrix): the update reads the gradients only through their norms
    and normalised inner products. The robust loss uses the PRE-update
    h_fun; the new weights apply from the next step (the torch module's
    buffer semantics)."""
    _no_axis(axis_name)
    if (group_grads is None) == (group_gram is None):
        raise ValueError("pass exactly one of group_grads / group_gram")
    G = cfg.n_groups
    counts = _segment_sum(torch.ones_like(losses.detach()), groups, G)
    gl = _segment_sum(losses, groups, G) / counts.clamp_min(1.0)
    robust = (gl * state.h_fun.detach()).sum()
    gl_det = gl.detach()

    if group_gram is not None:
        m = group_gram.detach().float()
        gnorm = m.diagonal().clamp_min(0.0).sqrt()
        rtg = m / ((1e-12 + gnorm)[:, None] * (1e-12 + gnorm)[None, :])
    else:
        # rows may be bf16: normalised rows stay in their dtype, as in the
        # JAX package, norms and the Gram sum in float32
        grads = group_grads.detach()
        grads = grads / (1e-12 + _row_norms(grads)).to(grads.dtype)
        rtg = gram(grads)
    glp = gl_det.pow(cfg.alpha)[:, None]
    rtg = (glp @ glp.t()) * rtg
    mask = (counts > 0).to(torch.float32)
    e = cfg.rho * rtg.mean(0) * mask
    e = e - e.max()
    h = state.h_fun.pow(cfg.ema) * torch.exp(e) * mask
    h = (h / h.sum()).clamp_min(cfg.eps)
    return robust, state.replace(h_fun=h), (gl_det, counts)



def dro_state_summary(state: DroState) -> dict:
    """Scalars of the DRO state for logging (the reference's
    `output_state()` JSON of per-group h_fun and running losses,
    ANCE/model/models.py:275-280), plus the full vectors as lists."""
    h = state.h_fun.detach().cpu().numpy()
    sl = state.sum_losses.detach().cpu().numpy()
    p = h / max(h.sum(), 1e-30)
    ent = float(-(p * np.log(np.maximum(p, 1e-30))).sum())
    return {
        "dro_h_min": float(h.min()),
        "dro_h_max": float(h.max()),
        "dro_h_entropy": ent,
        "dro_loss_ema_mean": float(sl.mean()),
        "dro_h_fun": h.tolist(),
        "dro_sum_losses": sl.tolist(),
    }
