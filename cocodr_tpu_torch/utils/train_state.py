"""Train state and checkpoints: the counterpart of
cocodr_tpu/utils/train_state.py.

The directory protocol is the JAX package's (itself the reference's
checkpoint-{step} protocol, ANCE/drivers/run_ann.py): one
`checkpoint-{step}/` directory per save, its payload written first and a
`DONE` marker last, so that a save cut short leaves a directory that
discovery skips. The payload is the port's own: `state.pt`, a `torch.save`
of the step, the model's state dict, the optimizer's state dict and the
DRO state's tensors when the state carries one (not an orbax tree). `models/convert.py::load_jax_train_state` takes a JAX
TrainState into a port state instead.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Optional

import torch
from torch import nn

from cocodr_tpu_torch.losses.dro import DroState

CKPT_PREFIX = "checkpoint-"
DONE_MARKER = "DONE"  # written last
PAYLOAD = "state.pt"


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step. The model and the
    optimizer are updated in place; `step` counts the updates taken;
    `extra` is the DRO kinds' losses.dro.DroState (None for 'nll'), which
    each of their steps replaces."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    extra: Optional[DroState] = None


def _ckpt_dir(root: str, step: int) -> str:
    return os.path.join(root, f"{CKPT_PREFIX}{step}")


def save_checkpoint(root: str, state: TrainState, keep: int = 0) -> str:
    """Payload first, DONE marker last; then keep only the newest `keep`
    checkpoints (0 keeps all)."""
    path = _ckpt_dir(root, state.step)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    extra = (None if state.extra is None
             else {f.name: getattr(state.extra, f.name)
                   for f in dataclasses.fields(state.extra)})
    torch.save({"step": state.step,
                "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "extra": extra},
               os.path.join(path, PAYLOAD))
    with open(os.path.join(path, DONE_MARKER), "w") as f:
        json.dump({"step": state.step}, f)
    if keep > 0:
        prune_checkpoints(root, keep)
    return path


def list_checkpoints(root: str):
    """Valid (DONE-marked) checkpoints, ascending by step."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = re.fullmatch(rf"{CKPT_PREFIX}(\d+)", name)
        if m and os.path.exists(os.path.join(root, name, DONE_MARKER)):
            out.append((int(m.group(1)), os.path.join(root, name)))
    return [p for _, p in sorted(out)]


def latest_checkpoint(root: str) -> Optional[str]:
    cks = list_checkpoints(root)
    return cks[-1] if cks else None


def prune_checkpoints(root: str, keep: int):
    for path in list_checkpoints(root)[:-keep]:
        shutil.rmtree(path, ignore_errors=True)


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint into `state`'s model and optimizer (in place, on
    the devices they are on) and set its step and DRO state; -> state."""
    dev = next(state.model.parameters()).device
    payload = torch.load(os.path.join(path, PAYLOAD), map_location=dev,
                         weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    extra = payload.get("extra")
    state.extra = None if extra is None else DroState(**extra)
    return state
