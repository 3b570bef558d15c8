"""ANCE training on mined triplets: the counterpart of the trainer half of
cocodr_tpu/pipelines/ance.py (reference ANCE/drivers/run_ann.py).

The miner writes `ann_training_data_{n}` (one line per query: qid, the
positive, the negatives, and with clustering a weight and a group) and
`ann_ndcg_{n}` (JSON of its dev metrics); the trainer finds the newest
pair (`get_latest_ann_data`) and trains on it (`train_on_ann_file`) with
any step of pipelines/train_step.py, the DRO kinds reading each
triplet's group. The mining half (`generate_negatives`, `write_ann_data`,
`mine`, `ance_round`, `checkpoint_params_loader`, `train_loop`,
`mine_loop`, with ops/kmeans.py) raises NotImplementedError: ROADMAP.md
Queue 1 item 9b.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Callable, Optional

import torch

from cocodr_tpu_torch.data.prefetch import prefetch
from cocodr_tpu_torch.data.streams import (
    shuffled_ann_lines,
    triplets_from_ann_lines,
)
from cocodr_tpu_torch.pipelines.train_step import dropout_generators

_MINING = "ROADMAP.md Queue 1 item 9b (ANCE mining)"


def ann_data_path(out_dir: str, n: int) -> str:
    return os.path.join(out_dir, f"ann_training_data_{n}")


def ann_ndcg_path(out_dir: str, n: int) -> str:
    return os.path.join(out_dir, f"ann_ndcg_{n}")


def get_latest_ann_data(out_dir: str):
    """(n, data_path, ndcg_json or None); n = -1 when absent (reference
    ANCE/drivers/run_ann.py:263-287)."""
    best = -1
    for p in glob.glob(os.path.join(out_dir, "ann_ndcg_*")):
        try:
            n = int(p.rsplit("_", 1)[1])
        except ValueError:
            continue
        if n > best and os.path.exists(ann_data_path(out_dir, n)):
            best = n
    if best < 0:
        return -1, None, None
    with open(ann_ndcg_path(out_dir, best)) as f:
        meta = json.load(f)
    return best, ann_data_path(out_dir, best), meta


def batch_arrays(tb) -> dict:
    """A data.streams.TripletBatch -> the step's batch of numpy arrays."""
    return {"q_ids": tb.query_ids, "q_mask": tb.query_mask,
            "pos_ids": tb.pos_ids, "pos_mask": tb.pos_mask,
            "neg_ids": tb.neg_ids, "neg_mask": tb.neg_mask,
            "groups": tb.groups, "weights": tb.weights}


def train_on_ann_file(state, train_step: Callable, batcher, ann_file: str,
                      batch_size: int, max_steps: Optional[int] = None,
                      seed: int = 0, device_put=None,
                      metrics_cb: Optional[Callable] = None,
                      dropout_seed: Optional[int] = 0):
    """Consume one ann file (reference run_ann.py:240-356) -> (state,
    steps taken); `state` (utils.train_state.TrainState) is updated in
    place.

    The file's lines are shuffled by `seed`, expanded into triplets and
    batched by `batcher` (data.streams.TripletBatcher over the query and
    passage token caches); the trailing partial batch is dropped. Batches
    are gathered two ahead on a prefetch thread, and sent to the card
    there when the model lies on it. dropout_seed: trains with dropout,
    the step's three generators seeded from (dropout_seed, state.step,
    tower), so a resumed run draws the same masks
    (train_step.dropout_generators; the JAX package folds the step into
    one key); None trains in eval mode, without dropout. metrics_cb(step,
    metrics) after every step, metrics being the DRO kinds' dict or
    {"loss", "acc"} for 'nll'. device_put (the JAX package's placement
    over a mesh) raises: ROADMAP.md Queue 1 item 11."""
    if device_put is not None:
        raise NotImplementedError(
            "device_put (sharded placement) is not ported yet: ROADMAP.md "
            "Queue 1 item 11 (parallel/*)"
        )
    dev = next(state.model.parameters()).device
    with open(ann_file) as f:
        lines = shuffled_ann_lines(f.readlines(), seed)

    def collate_stream():
        for tb in batcher.batches(triplets_from_ann_lines(lines),
                                  batch_size):
            yield batch_arrays(tb)

    steps = 0
    for arrays in prefetch(collate_stream(), depth=2,
                           device_put=dev.type == "cuda"):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in arrays.items()}
        gens = (None if dropout_seed is None
                else dropout_generators(dropout_seed, state.step, dev))
        out = train_step(state, batch, gens)
        steps += 1
        if metrics_cb:
            metrics = (out if isinstance(out, dict)
                       else {"loss": out[0], "acc": out[1]})
            metrics_cb(state.step, metrics)
        if max_steps and steps >= max_steps:
            break
    return state, steps


def _mining(name: str) -> Callable:
    def not_ported(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet: {_MINING}")

    not_ported.__name__ = name
    not_ported.__doc__ = (f"The JAX package's `{name}`; raises until "
                          f"{_MINING}.")
    return not_ported


generate_negatives = _mining("generate_negatives")
write_ann_data = _mining("write_ann_data")
mine = _mining("mine")
ance_round = _mining("ance_round")
checkpoint_params_loader = _mining("checkpoint_params_loader")
train_loop = _mining("train_loop")
mine_loop = _mining("mine_loop")
