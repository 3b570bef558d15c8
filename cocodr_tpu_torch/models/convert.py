"""flax parameters of the JAX package -> state dicts of the port's modules.

The tests run both packages on the same weights: they take the flax tree as
numpy (`jax.device_get(params)`) and load the result of these functions
into the port's modules. `load_jax_train_state` carries a whole JAX
TrainState (params, LAMB moments, step, schedule count) into the port, so
that a run started in the JAX package continues in the port. The name mapping is the HuggingFace one of
cocodr_tpu/models/hf.py (`bert_params_to_torch`), kept here as a copy so
that the port imports nothing of the JAX package.

flax layout: Dense kernels are [in, out] (nn.Linear keeps [out, in]); the
encoder's layers are stacked on a leading `layer` axis (nn.scan); the
attention projections are DenseGeneral with kernels [H, N, D] and an
output kernel [N, D, H].
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from cocodr_tpu_torch.losses.dro import DroState
from cocodr_tpu_torch.models.bert import BertConfig
from cocodr_tpu_torch.models.dual_encoder import DualEncoderConfig


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def bert_state_dict_from_jax(params: Mapping, cfg: BertConfig
                             ) -> Dict[str, torch.Tensor]:
    """flax models.bert.BertModel params -> state dict of models.bert.BertModel."""
    L, H = cfg.num_hidden_layers, cfg.hidden_size
    emb = params["embeddings"]
    enc = params["encoder"]["layers"]["layer"]
    attn = enc["attention"]
    out = {
        "embeddings.word_embeddings.weight":
            _t(emb["word_embeddings"]["embedding"]),
        "embeddings.position_embeddings.weight":
            _t(emb["position_embeddings"]["embedding"]),
        "embeddings.token_type_embeddings.weight":
            _t(emb["token_type_embeddings"]["embedding"]),
        "embeddings.LayerNorm.weight": _t(emb["layer_norm"]["scale"]),
        "embeddings.LayerNorm.bias": _t(emb["layer_norm"]["bias"]),
    }
    for i in range(L):
        pre = f"encoder.layer.{i}"
        for name in ("query", "key", "value"):
            out[f"{pre}.attention.self.{name}.weight"] = _t(
                np.asarray(attn[name]["kernel"][i]).reshape(H, H).T
            )
            out[f"{pre}.attention.self.{name}.bias"] = _t(
                np.asarray(attn[name]["bias"][i]).reshape(H)
            )
        out[f"{pre}.attention.output.dense.weight"] = _t(
            np.asarray(attn["output"]["kernel"][i]).reshape(H, H).T
        )
        out[f"{pre}.attention.output.dense.bias"] = _t(attn["output"]["bias"][i])
        out[f"{pre}.attention.output.LayerNorm.weight"] = _t(
            enc["attention_layer_norm"]["scale"][i]
        )
        out[f"{pre}.attention.output.LayerNorm.bias"] = _t(
            enc["attention_layer_norm"]["bias"][i]
        )
        out[f"{pre}.intermediate.dense.weight"] = _t(
            np.asarray(enc["intermediate"]["kernel"][i]).T
        )
        out[f"{pre}.intermediate.dense.bias"] = _t(enc["intermediate"]["bias"][i])
        out[f"{pre}.output.dense.weight"] = _t(
            np.asarray(enc["ffn_output"]["kernel"][i]).T
        )
        out[f"{pre}.output.dense.bias"] = _t(enc["ffn_output"]["bias"][i])
        out[f"{pre}.output.LayerNorm.weight"] = _t(
            enc["output_layer_norm"]["scale"][i]
        )
        out[f"{pre}.output.LayerNorm.bias"] = _t(
            enc["output_layer_norm"]["bias"][i]
        )
    return out


def params_from_jax(params: Mapping, cfg: DualEncoderConfig
                    ) -> Dict[str, torch.Tensor]:
    """flax models.dual_encoder.DualEncoder params (shared tower) -> state
    dict of models.dual_encoder.DualEncoder."""
    out = {
        "encoder." + k: v
        for k, v in bert_state_dict_from_jax(params["encoder"], cfg.bert).items()
    }
    if cfg.use_head:
        head = params["head"]
        out["head.dense.weight"] = _t(np.asarray(head["dense"]["kernel"]).T)
        out["head.dense.bias"] = _t(head["dense"]["bias"])
        out["head.layer_norm.weight"] = _t(head["layer_norm"]["scale"])
        out["head.layer_norm.bias"] = _t(head["layer_norm"]["bias"])
    return out


def load_jax_train_state(state, jax_state, cfg: DualEncoderConfig):
    """A JAX DualEncoder TrainState trained with cocodr_tpu.optim.lamb
    (fetched to the host, jax.device_get) -> the port's
    utils.train_state.TrainState `state`, in place; -> state.

    Reads jax_state.step, .params and .opt_state, optax's chain state
    (ScaleByLambState(mu, nu), ScaleByScheduleState(count)). mu and nu have
    the params' tree, so the params' mapping splits their [L, ...] leaves
    per layer too; they become the Lamb optimizer's exp_avg and exp_avg_sq,
    and count its schedule count. jax_state.extra, a DroState of the DRO
    kinds, becomes the port's losses.dro.DroState (None stays None)."""
    model, opt = state.model, state.optimizer
    dev = next(model.parameters()).device
    model.load_state_dict(params_from_jax(jax_state.params, cfg))
    lamb_state, sched_state = jax_state.opt_state
    mu = params_from_jax(lamb_state.mu, cfg)
    nu = params_from_jax(lamb_state.nu, cfg)
    for name, p in model.named_parameters():
        opt.state[p] = {"exp_avg": mu[name].to(dev),
                        "exp_avg_sq": nu[name].to(dev)}
    for group in opt.param_groups:
        group["count"] = int(np.asarray(sched_state.count))
    state.step = int(np.asarray(jax_state.step))
    extra = getattr(jax_state, "extra", None)
    state.extra = None if extra is None else DroState(**{
        name: torch.from_numpy(np.array(getattr(extra, name),
                                        dtype=np.float32)).to(dev)
        for name in ("h_fun", "sum_losses", "count_cat")})
    return state
