"""flax parameters of the JAX package -> state dicts of the port's modules.

The tests run both packages on the same weights: they take the flax tree as
numpy (`jax.device_get(params)`) and load the result of these functions
into the port's modules. `load_jax_train_state` carries a whole JAX
TrainState (params, LAMB moments, step, schedule count) into the port, so
that a run started in the JAX package continues in the port;
`condenser_state_dict_from_jax` takes the COCO stage's Condenser. Every
model type maps: the pooler, the DPR `doc_encoder` and a two-tower
`doc_head` included. The
name mapping is the HuggingFace one of cocodr_tpu/models/hf.py
(`bert_params_to_torch`), kept here as a copy so that the port imports
nothing of the JAX package.

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
from cocodr_tpu_torch.optim import MultiSteps
from cocodr_tpu_torch.parallel.tp import local_slice, split_state_dict


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _index(tree, i):
    """Slice i of every leaf of a (nested) dict of stacked arrays."""
    if isinstance(tree, Mapping):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _layer_state_dict(layer: Mapping, pre: str, H: int
                      ) -> Dict[str, torch.Tensor]:
    """One flax BertLayer's params (un-stacked) -> the port's BertLayer
    names under `pre`."""
    attn = layer["attention"]
    out = {}
    for name in ("query", "key", "value"):
        out[f"{pre}.attention.self.{name}.weight"] = _t(
            np.asarray(attn[name]["kernel"]).reshape(H, H).T)
        out[f"{pre}.attention.self.{name}.bias"] = _t(
            np.asarray(attn[name]["bias"]).reshape(H))
    out[f"{pre}.attention.output.dense.weight"] = _t(
        np.asarray(attn["output"]["kernel"]).reshape(H, H).T)
    out[f"{pre}.attention.output.dense.bias"] = _t(attn["output"]["bias"])
    out[f"{pre}.attention.output.LayerNorm.weight"] = _t(
        layer["attention_layer_norm"]["scale"])
    out[f"{pre}.attention.output.LayerNorm.bias"] = _t(
        layer["attention_layer_norm"]["bias"])
    out[f"{pre}.intermediate.dense.weight"] = _t(
        np.asarray(layer["intermediate"]["kernel"]).T)
    out[f"{pre}.intermediate.dense.bias"] = _t(layer["intermediate"]["bias"])
    out[f"{pre}.output.dense.weight"] = _t(
        np.asarray(layer["ffn_output"]["kernel"]).T)
    out[f"{pre}.output.dense.bias"] = _t(layer["ffn_output"]["bias"])
    out[f"{pre}.output.LayerNorm.weight"] = _t(
        layer["output_layer_norm"]["scale"])
    out[f"{pre}.output.LayerNorm.bias"] = _t(
        layer["output_layer_norm"]["bias"])
    return out


def bert_state_dict_from_jax(params: Mapping, cfg: BertConfig
                             ) -> Dict[str, torch.Tensor]:
    """flax models.bert.BertModel params -> state dict of models.bert.BertModel."""
    L, H = cfg.num_hidden_layers, cfg.hidden_size
    emb = params["embeddings"]
    enc = params["encoder"]["layers"]["layer"]
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
        out.update(_layer_state_dict(_index(enc, i), f"encoder.layer.{i}", H))
    if "pooler" in params:
        dense = params["pooler"]["dense"]
        out["pooler.dense.weight"] = _t(np.asarray(dense["kernel"]).T)
        out["pooler.dense.bias"] = _t(dense["bias"])
    return out


def params_from_jax(params: Mapping, cfg: DualEncoderConfig
                    ) -> Dict[str, torch.Tensor]:
    """flax models.dual_encoder.DualEncoder params -> state dict of
    models.dual_encoder.DualEncoder (both towers of a two-tower model)."""
    towers = [("encoder", "head")]
    if cfg.two_tower:
        towers.append(("doc_encoder", "doc_head"))
    out = {}
    for enc, head in towers:
        out.update({f"{enc}.{k}": v for k, v in
                    bert_state_dict_from_jax(params[enc], cfg.bert).items()})
        if cfg.use_head:
            p = params[head]
            out[f"{head}.dense.weight"] = _t(np.asarray(p["dense"]["kernel"]).T)
            out[f"{head}.dense.bias"] = _t(p["dense"]["bias"])
            out[f"{head}.layer_norm.weight"] = _t(p["layer_norm"]["scale"])
            out[f"{head}.layer_norm.bias"] = _t(p["layer_norm"]["bias"])
    return out


def condenser_state_dict_from_jax(params: Mapping, cfg: BertConfig,
                                  n_head_layers: int
                                  ) -> Dict[str, torch.Tensor]:
    """flax models.condenser.CondenserForPretraining params (the scanned
    `bert`, `mlm_transform`, `decoder_bias` and the un-stacked
    `c_head_{i}`) -> state dict of models.condenser's module."""
    out = {"bert." + k: v
           for k, v in bert_state_dict_from_jax(params["bert"], cfg).items()}
    tr = params["mlm_transform"]
    pre = "cls.predictions"
    out[f"{pre}.transform.dense.weight"] = _t(
        np.asarray(tr["dense"]["kernel"]).T)
    out[f"{pre}.transform.dense.bias"] = _t(tr["dense"]["bias"])
    out[f"{pre}.transform.LayerNorm.weight"] = _t(tr["layer_norm"]["scale"])
    out[f"{pre}.transform.LayerNorm.bias"] = _t(tr["layer_norm"]["bias"])
    out[f"{pre}.bias"] = _t(params["decoder_bias"])
    for i in range(n_head_layers):
        out.update(_layer_state_dict(params[f"c_head_{i}"], f"c_head.{i}",
                                     cfg.hidden_size))
    return out


def load_jax_train_state(state, jax_state, cfg: DualEncoderConfig):
    """A JAX DualEncoder TrainState trained with cocodr_tpu.optim.lamb
    (fetched to the host, jax.device_get) -> the port's
    utils.train_state.TrainState `state`, in place; -> state.

    Reads jax_state.step, .params and .opt_state, optax's chain state
    (ScaleByLambState(mu, nu), ScaleByScheduleState(count)). mu and nu have
    the params' tree, so the params' mapping splits their [L, ...] leaves
    per layer too; they become the Lamb optimizer's exp_avg and exp_avg_sq,
    and count its schedule count. An optax.MultiStepsState (gradient
    accumulation) goes into the port's optim.MultiSteps: its
    inner_opt_state into the inner Lamb as above, acc_grads, mini_step and
    gradient_step into the wrapper. jax_state.extra, a DroState of the DRO
    kinds, becomes the port's losses.dro.DroState (None stays None). A
    model split over a model axis (parallel/tp.py) takes its slices of
    the parameters, and of the moments and accumulator with them."""
    model, opt = state.model, state.optimizer
    dev = next(model.parameters()).device
    model.load_state_dict(split_state_dict(
        model, params_from_jax(jax_state.params, cfg)))
    opt_state = jax_state.opt_state
    if hasattr(opt_state, "inner_opt_state"):  # optax.MultiStepsState
        if not isinstance(opt, MultiSteps):
            raise ValueError("a JAX state with gradient accumulation needs "
                             "an optimizer built with grad_accum_steps > 1")
        acc = params_from_jax(opt_state.acc_grads, cfg)
        opt.acc = {p: local_slice(p, acc[name]).to(dev)
                   for name, p in model.named_parameters()}
        opt.mini_step = int(np.asarray(opt_state.mini_step))
        opt.gradient_step = int(np.asarray(opt_state.gradient_step))
        opt_state = opt_state.inner_opt_state
    lamb_state, sched_state = opt_state
    mu = params_from_jax(lamb_state.mu, cfg)
    nu = params_from_jax(lamb_state.nu, cfg)
    for name, p in model.named_parameters():
        opt.state[p] = {"exp_avg": local_slice(p, mu[name]).to(dev),
                        "exp_avg_sq": local_slice(p, nu[name]).to(dev)}
    for group in opt.param_groups:
        group["count"] = int(np.asarray(sched_state.count))
    state.step = int(np.asarray(jax_state.step))
    extra = getattr(jax_state, "extra", None)
    state.extra = None if extra is None else DroState(**{
        name: torch.from_numpy(np.array(getattr(extra, name),
                                        dtype=np.float32)).to(dev)
        for name in ("h_fun", "sum_losses", "count_cat")})
    return state
