"""COCO continuous contrastive pretraining: the counterpart of
cocodr_tpu/pipelines/coco.py (reference COCO/run_coco_pre_training.py and
COCO/trainer.py).

The coCondenser loss (Condenser MLM plus the span contrastive loss,
models/condenser.py) over batches of two spans a document, with an
optional gradient cache for contrastive batches larger than memory
(reference COCO/trainer.py:142-192 and the GradCache package):
  1. pass 1 encodes each chunk's backbone CLS without gradients;
  2. the float32 contrastive loss and its cotangents d(co_loss)/d(cls) are
     taken on the [B, H] embeddings;
  3. pass 2 runs each chunk forward again and back through the surrogate
         mlm_chunk * (masked_chunk / masked_total) + <cotangent_chunk, cls>
     and the gradients add up in the parameters' .grad across chunks, so
     that activations live for one chunk at a time (the reference's
     `torch.dot(cached_grads, cls)`, COCO/modeling.py:231-235).
The sum is the full batch's gradient: the MLM term is token-weighted, so
chunks with unequal masked counts add up to the batch's token mean.

Dropout: the direct step draws from one generator seeded from (seed,
step), the cache step's chunks from generators seeded from (seed, step,
chunk) (`coco_generator`), so that a resumed run draws the masks of an
uninterrupted one. Pass 2 makes each chunk's generator anew from the same
seed, so it starts from the state pass 1 started from; the backbone draws
first in both passes (models/condenser.py), so pass 2's CLS is pass 1's.

Data parallelism (a state of parallel/sharded_train.py, `device_put` its
put_batch): each rank holds its rows of the global batch and the step is
the global batch's. The contrastive candidates are every rank's spans
(the direct step: losses/contrastive.py's gathered form; the cache step:
the CLS rows all-gathered after pass 1, the float32 loss and cotangents
taken on all of them, each rank keeping its slice); the MLM term is the
global token mean (each rank's mean weighted by its share of the masked
tokens); the gradients are averaged over the ranks before the clip, so
each rank's terms are scaled by W. Rank r > 0 draws dropout from a child
seed sequence (`coco_generator(rank=)`), rank 0 the single-device masks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from cocodr_tpu_torch.core.mesh import data_rank, data_size, gather_rows, psum
from cocodr_tpu_torch.data.prefetch import prefetch
from cocodr_tpu_torch.losses.contrastive import co_contrastive_loss
from cocodr_tpu_torch.models.condenser import IGNORE_INDEX
from cocodr_tpu_torch.pipelines.train_step import apply_gradients
from cocodr_tpu_torch.utils.logging import span
from cocodr_tpu_torch.utils.train_state import TrainState, save_checkpoint


@dataclasses.dataclass(frozen=True)
class CocoConfig:
    """The step's own options. The span length and the masking rate are the
    collator's, and whether late MLM runs is the model's (`late_mlm`)."""
    cache_chunk_size: int = 0  # 0: no grad cache; else divides each batch
    max_grad_norm: float = 1.0  # 0 disables clipping


def coco_generator(seed: int, step: int, device,
                   chunk: Optional[int] = None,
                   rank: int = 0) -> torch.Generator:
    """A dropout generator on `device` seeded from (seed, step): the direct
    step's; with `chunk`, from (seed, step, chunk): a cache chunk's. A
    data-parallel rank > 0 seeds from the child sequence `rank`."""
    key = [seed, step] + ([] if chunk is None else [chunk])
    ss = np.random.SeedSequence(key, spawn_key=(rank,) if rank else ())
    g = torch.Generator(device=device)
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0] >> 1))
    return g


def contrastive_cotangents(cls):
    """The grad cache's middle: the float32 contrastive loss of the [B, H]
    CLS embeddings and its cotangents d(co_loss)/d(cls) -> (co_loss,
    cotangents), both detached."""
    cls32 = cls.float().requires_grad_()
    co_loss = co_contrastive_loss(cls32)
    (grads,) = torch.autograd.grad(co_loss, cls32)
    return co_loss.detach(), grads


def _masked_share(labels, mesh):
    """This rank's share of the global batch's masked tokens, a 0-dim
    float32 tensor (1.0 exactly without a mesh or in a world of one)."""
    own = (labels != IGNORE_INDEX).sum().float()
    return own / psum(own, mesh).clamp_min(1)


def build_coco_train_step(cfg: CocoConfig) -> Callable:
    """-> step(state, batch, dropout_seed=None) -> metrics {loss, mlm_loss,
    co_loss} (0-dim tensors on the model's device). state: a TrainState
    whose model is a models.condenser.CoCondenserForPretraining, updated in
    place. batch: input_ids, attention_mask, labels [B, S] tensors on the
    model's device. dropout_seed: train with dropout, the generators from
    (dropout_seed, state.step[, chunk]); None runs the model in eval mode
    (no dropout). Either form runs in the span `cocodr.coco.step` (unit:
    state.step before the step)."""
    if cfg.cache_chunk_size <= 0:
        def step(state: TrainState, batch, dropout_seed=None):
            model = state.model
            model.train(dropout_seed is not None)
            mesh = state.mesh
            gen = (None if dropout_seed is None else coco_generator(
                dropout_seed, state.step, batch["input_ids"].device,
                rank=data_rank(mesh)))
            state.optimizer.zero_grad(set_to_none=True)
            mlm, aux = model(batch["input_ids"], batch["attention_mask"],
                             batch["labels"], generator=gen)
            co = co_contrastive_loss(aux["cls"], axis_name=mesh)
            share = _masked_share(batch["labels"], mesh)
            (mlm * (share * data_size(mesh)) + co).backward()
            apply_gradients(state, cfg.max_grad_norm)
            parts = psum(torch.stack([mlm.detach() * share,
                                      aux["head_mlm_loss"].detach() * share]),
                         mesh)
            return {"loss": parts[0] + co.detach(), "mlm_loss": parts[1],
                    "co_loss": co.detach()}

        return _spanned(step)

    C = cfg.cache_chunk_size

    def step(state: TrainState, batch, dropout_seed=None):
        model = state.model
        model.train(dropout_seed is not None)
        mesh = state.mesh
        W, rank = data_size(mesh), data_rank(mesh)
        ids, mask, labels = (batch["input_ids"], batch["attention_mask"],
                             batch["labels"])
        B = ids.shape[0]
        if B % C:
            raise ValueError(f"batch of {B} spans is not a multiple of the "
                             f"cache chunk {C}")
        n_chunks = B // C
        chunks = [slice(c * C, (c + 1) * C) for c in range(n_chunks)]

        def generators():
            if dropout_seed is None:
                return [None] * n_chunks
            return [coco_generator(dropout_seed, state.step, ids.device, c,
                                   rank) for c in range(n_chunks)]

        # pass 1: the chunks' CLS without gradients
        with torch.no_grad():
            cls = torch.cat([model.cls_emb(ids[sl], mask[sl], generator=g)
                             for sl, g in zip(chunks, generators())])
        # every rank's spans; this rank's cotangents
        co_loss, cls_grads = contrastive_cotangents(gather_rows(cls, mesh))
        cls_grads = cls_grads[rank * B:(rank + 1) * B] * W
        # pass 2: each chunk forward and back through the surrogate
        total_masked = psum((labels != IGNORE_INDEX).sum().float(),
                            mesh).clamp_min(1)
        state.optimizer.zero_grad(set_to_none=True)
        mlm_loss = torch.zeros((), device=ids.device)
        for sl, g in zip(chunks, generators()):
            w = (labels[sl] != IGNORE_INDEX).sum().float() / total_masked
            mlm, aux = model(ids[sl], mask[sl], labels[sl], generator=g)
            surrogate = (cls_grads[sl] * aux["cls"].float()).sum()
            (mlm * (w * W) + surrogate).backward()
            mlm_loss = mlm_loss + (mlm * w).detach()
        apply_gradients(state, cfg.max_grad_norm)
        mlm_loss = psum(mlm_loss, mesh)
        return {"loss": mlm_loss + co_loss, "mlm_loss": mlm_loss,
                "co_loss": co_loss}

    return _spanned(step)


def _spanned(step: Callable) -> Callable:
    def spanned(state: TrainState, batch, dropout_seed=None):
        with span("cocodr.coco.step", state.step):
            return step(state, batch, dropout_seed)

    return spanned


def run_coco_pretrain(state: TrainState, train_step: Callable,
                      span_batches: Iterator[Dict[str, np.ndarray]],
                      dropout_seed: Optional[int], max_steps: int,
                      log_fn: Optional[Callable] = None, log_every: int = 50,
                      ckpt_dir: Optional[str] = None, save_steps: int = 0,
                      device_put: Optional[Callable] = None, saver=None,
                      keep_checkpoints: int = 3) -> TrainState:
    """Train `state` (updated in place) on span_batches (numpy batches of
    data/coco_spans.py::span_batches, sent to the model's device by a
    prefetch thread) until state.step reaches max_steps -> state.

    Resume: the caller loads the newest DONE checkpoint into `state` and
    fast-forwards the stream (span_batches(start_batch=state.step)); the
    dropout generators come from (dropout_seed, step), so a resumed run
    draws the masks of an uninterrupted one. log_fn(step, {loss,
    mlm_loss, co_loss} as floats) every log_every steps; a checkpoint every
    save_steps steps and at the end, keeping keep_checkpoints. saver: a
    utils.train_state.AsyncSaver for checkpoints written in the background
    (None: written synchronously); the run waits for the last one.
    device_put: the put_batch of parallel/sharded_train.py (a data-parallel
    state), which gives this rank its rows of each host batch."""
    save = saver.save if saver is not None else save_checkpoint
    dev = next(state.model.parameters()).device
    saved_step = None
    for batch in prefetch(span_batches, depth=2,
                          device_put=device_put is None
                          and dev.type == "cuda"):
        if device_put is not None:
            batch = device_put(batch)
        else:
            batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        metrics = train_step(state, batch, dropout_seed)
        step = state.step
        if log_fn and step % log_every == 0:
            log_fn(step, {k: float(v) for k, v in metrics.items()})
        if ckpt_dir and save_steps and step % save_steps == 0:
            save(ckpt_dir, state, keep=keep_checkpoints)
            saved_step = step
        if step >= max_steps:
            break
    if ckpt_dir and saved_step != state.step:  # the JAX loop saves here again
        save(ckpt_dir, state, keep=keep_checkpoints)
    if saver is not None:
        saver.wait()
    return state
