"""BM25-warmup finetuning: the counterpart of cocodr_tpu/pipelines/warmup.py.

Streams (query \\t positive \\t negative) text triples, tokenizes them on a
prefetch thread, trains the dual encoder on the 2-way NLL with LAMB and a
linear warmup, and checkpoints every save_steps (reference
warmup/drivers/run_bm25_warmup.py). Epochs re-read the file; rank sharding
is by line index.

The tokenizer is any callable with the HuggingFace call signature
(texts, padding=, truncation=, max_length=, return_tensors="np"); the port
does not import `transformers`. Not carried over yet (ROADMAP.md Queue 1
item 13): the JAX `saver` (an AsyncSaver; checkpoints are written
synchronously) and sharded placement (`device_put`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from cocodr_tpu_torch.data.prefetch import prefetch
from cocodr_tpu_torch.data.streams import parse_triples_tsv_line
from cocodr_tpu_torch.pipelines.train_step import dropout_generators
from cocodr_tpu_torch.utils.train_state import (
    TrainState,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)


@dataclasses.dataclass
class WarmupConfig:
    max_seq_len: int = 128  # triples tokenized at one length
    batch_size: int = 32
    num_epochs: int = 3
    save_steps: int = 10000
    eval_every_steps: int = 0  # 0 disables
    max_steps: int = 0  # 0 = until the epochs are exhausted
    log_every: int = 100
    keep_checkpoints: int = 3


class TripleTextBatcher:
    """Tokenize raw triples into int32 numpy arrays."""

    def __init__(self, tokenizer, max_len: int):
        self.tok = tokenizer
        self.max_len = max_len

    def encode_batch(self, texts):
        out = self.tok(texts, padding="max_length", truncation=True,
                       max_length=self.max_len, return_tensors="np")
        return (np.asarray(out["input_ids"]).astype(np.int32),
                np.asarray(out["attention_mask"]).astype(np.int32))

    def collate(self, triples):
        qs, ps, ns = zip(*triples)
        q_ids, q_mask = self.encode_batch(list(qs))
        p_ids, p_mask = self.encode_batch(list(ps))
        n_ids, n_mask = self.encode_batch(list(ns))
        return {"q_ids": q_ids, "q_mask": q_mask, "pos_ids": p_ids,
                "pos_mask": p_mask, "neg_ids": n_ids, "neg_mask": n_mask}


def stream_triples(path: str, rank: int = 0, world_size: int = 1
                   ) -> Iterator[tuple]:
    """The triples of lines i with i % world_size == rank; lines that do
    not parse are skipped."""
    with open(path, encoding="utf8") as f:
        for i, line in enumerate(f):
            if i % world_size != rank:
                continue
            try:
                yield parse_triples_tsv_line(line)
            except ValueError:
                continue


def run_warmup(state: TrainState, train_step: Callable, triples_path: str,
               tokenizer, cfg: WarmupConfig, ckpt_dir: str,
               eval_fn: Optional[Callable] = None,
               log_fn: Optional[Callable] = None, resume: bool = True,
               dropout_seed: Optional[int] = 0, saver=None) -> TrainState:
    """Train `state` (model and optimizer, updated in place) with
    train_step (pipelines/train_step.py::build_train_step) -> state.

    eval_fn(state) runs every cfg.eval_every_steps; log_fn(step,
    {"loss", "acc"}) every cfg.log_every. resume loads the newest valid
    checkpoint of ckpt_dir and skips the batches its step consumed, before
    tokenizing them. dropout_seed: trains with dropout, the step's three
    generators seeded from (dropout_seed, step, tower), so a resumed run
    draws the same masks; None trains in eval mode, without dropout."""
    if saver is not None:
        raise NotImplementedError(
            "asynchronous checkpoints (AsyncSaver) are not ported yet: "
            "ROADMAP.md Queue 1 item 13"
        )
    os.makedirs(ckpt_dir, exist_ok=True)
    if resume:
        ck = latest_checkpoint(ckpt_dir)
        if ck:
            load_checkpoint(ck, state)
    dev = next(state.model.parameters()).device
    batcher = TripleTextBatcher(tokenizer, cfg.max_seq_len)
    skip = state.step

    def collate_stream():
        nonlocal skip
        buf = []
        for epoch in range(cfg.num_epochs):
            for triple in stream_triples(triples_path):
                buf.append(triple)
                if len(buf) < cfg.batch_size:
                    continue
                triples, buf = buf, []
                if skip > 0:
                    skip -= 1
                    continue
                yield epoch, batcher.collate(triples)

    saved_step = None
    for _epoch, arrays in prefetch(collate_stream(), depth=2,
                                   device_put=dev.type == "cuda"):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in arrays.items()}
        gens = (None if dropout_seed is None
                else dropout_generators(dropout_seed, state.step, dev))
        loss, acc = train_step(state, batch, gens)
        step = state.step
        if log_fn and step % cfg.log_every == 0:
            log_fn(step, {"loss": float(loss), "acc": float(acc)})
        if cfg.save_steps and step % cfg.save_steps == 0:
            save_checkpoint(ckpt_dir, state, keep=cfg.keep_checkpoints)
            saved_step = step
        if eval_fn and cfg.eval_every_steps and step % cfg.eval_every_steps == 0:
            eval_fn(state)
        if cfg.max_steps and step >= cfg.max_steps:
            break
    if saved_step != state.step:  # the JAX loop saves here again
        save_checkpoint(ckpt_dir, state, keep=cfg.keep_checkpoints)
    return state
