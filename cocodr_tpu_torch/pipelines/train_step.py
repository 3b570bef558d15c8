"""The training step of the dual-encoder stages: the counterpart of
cocodr_tpu/pipelines/train_step.py for loss_kind="nll" (the BM25 warmup):
three tower forwards (query, positive, negative), the triplet 2-way NLL
with optional per-sample weights, the backward, clipping by global norm
with optax's rule, and one optimizer update.

Dropout: a step takes three torch.Generators, one per tower, as the JAX
step folds the tower index 0/1/2 into its key, so the positive and
negative towers draw independent masks; `dropout_generators` seeds them
from (seed, step, tower). Without generators the model runs in eval mode
(the JAX step's deterministic=True) and draws nothing.

The other loss kinds raise NotImplementedError: DRO-greedy and iDRO come
with ROADMAP.md Queue 1 item 9, multi-chunk documents with item 3.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from cocodr_tpu_torch.losses.nll import triplet_nll
from cocodr_tpu_torch.utils.train_state import TrainState

_LATER = {
    "dro-greedy": "ROADMAP.md Queue 1 item 9 (ANCE + iDRO)",
    "idro": "ROADMAP.md Queue 1 item 9 (ANCE + iDRO)",
    "nll_multichunk": "ROADMAP.md Queue 1 item 3 (multi-chunk models)",
}


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    loss_kind: str = "nll"
    max_grad_norm: float = 1.0  # 0 disables clipping


def dropout_generators(seed: int, step: int, device) -> tuple:
    """Three torch.Generators on `device`, one per tower, seeded from
    (seed, step, tower): a resumed run draws the same masks at the same
    step."""
    gens = []
    for tower in range(3):
        ss = np.random.SeedSequence([seed, step, tower])
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


def nll_loss(model, batch, generators=None):
    """-> (mean loss, mean accuracy), the loss weighted per sample by
    batch["weights"] when the batch has them."""
    q, a, b = embed_triplet(model, batch, generators)
    losses, acc, _ = triplet_nll(q, a, b)
    w = batch.get("weights")
    if w is not None:
        losses = losses * w
    return losses.mean(), acc.mean()


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the .grad of params, in place: the
    gradients stay as they are when their global norm is below max_norm,
    else each becomes g / norm * max_norm (torch's clip_grad_norm_
    multiplies by max_norm / (norm + 1e-6) instead). -> the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    one = torch.ones_like(norm)
    div = torch.where(keep, one, norm)
    mul = torch.where(keep, one, torch.full_like(norm, max_norm))
    for g in grads:  # g / 1 * 1 leaves g bit-equal
        g.div_(div).mul_(mul)
    return norm


def apply_gradients(state: TrainState, max_grad_norm: float) -> None:
    """Clip the model's gradients, take one optimizer update, count it."""
    if max_grad_norm > 0:
        clip_by_global_norm_(state.model.parameters(), max_grad_norm)
    state.optimizer.step()
    state.step += 1


def build_train_step(cfg: TrainStepConfig = TrainStepConfig()) -> Callable:
    """-> train_step(state, batch, generators=None) -> (loss, acc), 0-dim
    tensors on the model's device; the state is updated in place.

    batch: q_ids/q_mask/pos_ids/pos_mask/neg_ids/neg_mask [B, S] tensors on
    the model's device, optional weights [B]."""
    if cfg.loss_kind in _LATER:
        raise NotImplementedError(
            f"loss_kind {cfg.loss_kind!r} is not ported yet: "
            f"{_LATER[cfg.loss_kind]}"
        )
    if cfg.loss_kind != "nll":
        raise ValueError(cfg.loss_kind)

    def train_step(state: TrainState, batch, generators=None):
        state.optimizer.zero_grad(set_to_none=True)
        loss, acc = nll_loss(state.model, batch, generators)
        loss.backward()
        apply_gradients(state, cfg.max_grad_norm)
        return loss.detach(), acc

    return train_step
