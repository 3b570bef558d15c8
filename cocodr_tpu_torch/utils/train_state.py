"""Train state and checkpoints: the counterpart of
cocodr_tpu/utils/train_state.py.

The directory protocol is the JAX package's (itself the reference's
checkpoint-{step} protocol, ANCE/drivers/run_ann.py): one
`checkpoint-{step}/` directory per save, its payload written first and a
`DONE` marker last, so that a save cut short leaves a directory that
discovery skips. The payload is the port's own: `state.pt`, a `torch.save`
of the step, the model's state dict, the optimizer's state dict and the
DRO state's tensors when the state carries one (not an orbax tree).
`models/convert.py::load_jax_train_state` takes a JAX TrainState into a
port state instead. A tensor-parallel state (parallel/tp.py) saves the
whole tensors, gathered over the model axis, as the JAX package's
jax.device_get(state) does: a checkpoint is the same file whatever the
mesh, and a load cuts each split parameter's slices from it. `AsyncSaver` writes the same checkpoints on a
background thread. `export_hf_bert` writes a model as a HuggingFace
checkpoint directory, the files the JAX package's export writes.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Callable, Optional

import torch
from torch import nn

from cocodr_tpu_torch.core.mesh import barrier, is_writer
from cocodr_tpu_torch.losses.dro import DroState
from cocodr_tpu_torch.parallel.tp import (
    gather_optimizer_state,
    gather_params_tp,
    is_split,
    split_optimizer_state,
    split_state_dict,
)

CKPT_PREFIX = "checkpoint-"
DONE_MARKER = "DONE"  # written last
PAYLOAD = "state.pt"


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step. The model and the
    optimizer are updated in place; `step` counts the train steps taken,
    one a micro-batch (the JAX state's step + 1 on every call): with
    gradient accumulation (optim.MultiSteps) the parameters move on every
    k-th of them, and the optimizer's schedule count once a k; `extra` is
    the DRO kinds' losses.dro.DroState (None for 'nll'), which each of
    their steps replaces, on every micro-batch; `mesh` is the DeviceMesh
    of a data-parallel run (parallel/sharded_train.py::shard_train_init),
    None on one device: its steps all-reduce the gradients, and only rank
    0 writes its checkpoints."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    extra: Optional[DroState] = None
    mesh: Optional[object] = None


def _ckpt_dir(root: str, step: int) -> str:
    return os.path.join(root, f"{CKPT_PREFIX}{step}")


def _payload(state: TrainState) -> dict:
    """What a checkpoint holds; a split model's tensors gathered whole (a
    collective over the model axis: every rank builds the payload)."""
    extra = (None if state.extra is None
             else {f.name: getattr(state.extra, f.name)
                   for f in dataclasses.fields(state.extra)})
    model, opt = state.model.state_dict(), state.optimizer.state_dict()
    if is_split(state.model):
        model = gather_params_tp(state.model)
        opt = gather_optimizer_state(state.optimizer, opt)
    return {"step": state.step, "model": model, "optimizer": opt,
            "extra": extra}


def _fresh_dir(root: str, step: int) -> str:
    path = _ckpt_dir(root, step)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    return path


def _commit(root: str, path: str, payload: dict, keep: int) -> None:
    """Payload first, DONE marker last; then keep only the newest `keep`
    checkpoints (0 keeps all)."""
    torch.save(payload, os.path.join(path, PAYLOAD))
    with open(os.path.join(path, DONE_MARKER), "w") as f:
        json.dump({"step": payload["step"]}, f)
    if keep > 0:
        prune_checkpoints(root, keep)


def save_checkpoint(root: str, state: TrainState, keep: int = 0) -> str:
    """Payload first, DONE marker last; then keep only the newest `keep`
    checkpoints (0 keeps all). In a data-parallel run rank 0 writes and
    every rank waits for it at a barrier (a tensor-parallel one first
    gathers the payload on every rank)."""
    writer = is_writer(state.mesh)
    if writer or is_split(state.model):
        payload = _payload(state)
    if writer:
        _commit(root, _fresh_dir(root, state.step), payload, keep)
    barrier(state.mesh)
    return _ckpt_dir(root, state.step)


def _host_copy(obj):
    """A copy of a (nested) payload whose tensors are new host tensors."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


class AsyncSaver:
    """Checkpoints written on a background thread, with the DONE-marker
    protocol: the counterpart of the JAX package's AsyncSaver.

    `save()` copies the model's and the optimizer's state to host memory
    (training may then go on and change them) and returns while a thread
    writes the payload; the DONE marker follows the payload, so that a
    save cut short leaves a directory that discovery skips, not a corrupt
    checkpoint. At most one save is in flight: a save first waits for the
    previous one. `wait()` joins it and raises again what it raised;
    call it, or `close()`, before the process ends."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, root: str, state: TrainState, keep: int = 0,
             on_complete: Optional[Callable[[], None]] = None) -> str:
        """on_complete() runs after the DONE marker is written: bookkeeping
        that must never run ahead of a valid checkpoint (the ANCE loop's
        ann-progress record) goes there. In a data-parallel run only rank
        0 writes (and runs on_complete)."""
        self.wait()
        writer = is_writer(state.mesh)
        if writer or is_split(state.model):
            payload = _host_copy(_payload(state))
        if not writer:
            return _ckpt_dir(root, state.step)
        path = _fresh_dir(root, state.step)

        def commit():
            try:
                _commit(root, path, payload, keep)
                if on_complete is not None:
                    on_complete()
            except Exception as e:  # raised again by the next wait()
                self._error = e

        self._thread = threading.Thread(target=commit, daemon=True)
        self._thread.start()
        return path

    def wait(self) -> None:
        """Join the save in flight; raise again what it raised, so that a
        checkpoint that failed to commit is not found only at a later
        resume."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                "asynchronous checkpoint commit failed") from err

    def close(self) -> None:
        self.wait()


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
    the devices they are on) and set its step and DRO state; -> state. A
    split model takes its slices of the checkpoint's whole tensors."""
    dev = next(state.model.parameters()).device
    payload = torch.load(os.path.join(path, PAYLOAD), map_location=dev,
                         weights_only=True)
    model_sd, opt_sd = payload["model"], payload["optimizer"]
    if is_split(state.model):
        model_sd = split_state_dict(state.model, model_sd)
        opt_sd = split_optimizer_state(state.optimizer, opt_sd)
    state.model.load_state_dict(model_sd)
    state.optimizer.load_state_dict(opt_sd)
    state.step = int(payload["step"])
    extra = payload.get("extra")
    state.extra = None if extra is None else DroState(**extra)
    return state


def export_hf_bert(state_dict, cfg, out_dir: str, head_params=None,
                   extra_state=None) -> None:
    """Write a models.dual_encoder.DualEncoder's state dict as a
    HuggingFace checkpoint directory: the counterpart of the JAX package's
    export_hf_bert and of save_pretrained (cfg: its DualEncoderConfig).

    pytorch_model.bin holds the tensors of models/hf.py::state_dict_to_hf:
    a single tower under BertModel's names without the `bert.` /
    `roberta.` prefix (as the JAX export writes them) and the rdot_nll
    head as `embeddingHead.*` / `norm.*` (reference ANCE/model/models.py:
    109-110), or a two-tower model's towers under `question_model.` /
    `ctx_model.`; extra_state's tensors join them (a Condenser's MLM head).
    head_params (a Condenser's `c_head.*`) go to model.pt (reference
    COCO/modeling.py:123-131). config.json records the backbone and its
    flavour (bert or roberta positions), so that a reload rebuilds it.
    state_dict may be the model itself: a split one's tensors are gathered
    whole (a collective: every model rank calls it)."""
    from cocodr_tpu_torch.models.hf import state_dict_to_hf

    if isinstance(state_dict, nn.Module):
        state_dict = gather_params_tp(state_dict)
    bert = cfg.bert
    roberta = bert.position_style == "roberta"
    os.makedirs(out_dir, exist_ok=True)
    sd = state_dict_to_hf(state_dict, cfg)
    if not cfg.two_tower:
        prefix = "roberta." if roberta else "bert."
        sd = {k[len(prefix):] if k.startswith(prefix) else k: v
              for k, v in sd.items()}
    sd.update(extra_state or {})
    torch.save({k: v.detach().cpu().contiguous() for k, v in sd.items()},
               os.path.join(out_dir, "pytorch_model.bin"))
    config = {
        "architectures": ["RobertaModel" if roberta else "BertModel"],
        "model_type": "roberta" if roberta else "bert",
        "vocab_size": bert.vocab_size,
        "hidden_size": bert.hidden_size,
        "num_hidden_layers": bert.num_hidden_layers,
        "num_attention_heads": bert.num_attention_heads,
        "intermediate_size": bert.intermediate_size,
        "hidden_act": bert.hidden_act,
        "max_position_embeddings": bert.max_position_embeddings,
        "type_vocab_size": bert.type_vocab_size,
        "layer_norm_eps": bert.layer_norm_eps,
        "pad_token_id": bert.pad_token_id,
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    if head_params is not None:
        torch.save({k: v.detach().cpu().contiguous()
                    for k, v in head_params.items()},
                   os.path.join(out_dir, "model.pt"))
