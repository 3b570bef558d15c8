"""HuggingFace checkpoints <-> the port's state dicts: the counterpart of
cocodr_tpu/models/hf.py, kept as the port's own copy.

The port's module names are HuggingFace's (models/bert.py), so a backbone
maps by its prefix alone: `bert.` or `roberta.` in a full checkpoint,
`encoder.` (and `doc_encoder.`) in the port. The reference's dual-encoder
checkpoints add the rdot_nll head as `embeddingHead.*` (Linear) and
`norm.*` (LayerNorm) at the top level (RobertaDot_NLL_LN / BertDot_NLL_LN,
reference ANCE/model/models.py:109-110), the port's `head.dense.*` and
`head.layer_norm.*`; the DPR BiEncoder keeps its towers under
`question_model.` and `ctx_model.` (reference warmup/model/models.py:
296-320), each with its `pooler.dense.*`. `config_from_hf` reads a
config.json dict (or any object with its attributes) without importing
transformers. A config whose model_type is 'deepseek_v2' gives a
DeepseekV2Config, and its checkpoint (`model.embed_tokens`,
`model.layers.N.{self_attn,mlp,input_layernorm,post_attention_layernorm}.*`,
`model.norm`; a DeepseekV2Model's keys without `model.`) maps by
models/deepseek_v2.py::state_dict_from_hf, its experts stacked.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from cocodr_tpu_torch.models import deepseek_v2
from cocodr_tpu_torch.models.bert import BertConfig
from cocodr_tpu_torch.models.dual_encoder import DualEncoderConfig, is_decoder

# HuggingFace buffers that are not parameters of the port's BertModel
_BUFFERS = ("embeddings.position_ids", "embeddings.token_type_ids")
# the port's head names -> the reference checkpoint's top-level names
_HEAD = {"dense.weight": "embeddingHead.weight",
         "dense.bias": "embeddingHead.bias",
         "layer_norm.weight": "norm.weight",
         "layer_norm.bias": "norm.bias"}
_DPR = {"encoder": "question_model.", "doc_encoder": "ctx_model."}


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(v, dtype=np.float32))


def config_from_hf(hf_config) -> BertConfig:
    """A HuggingFace BERT or RoBERTa config (a config.json dict, or an
    object with those attributes) -> BertConfig, or a DeepSeek-V2 one ->
    DeepseekV2Config (float32 compute; set dtype with
    dataclasses.replace)."""
    def g(k, d=None):
        if isinstance(hf_config, Mapping):
            return hf_config.get(k, d)
        return getattr(hf_config, k, d)

    if g("model_type") == deepseek_v2.MODEL_TYPE:
        return deepseek_v2.config_from_hf(g)
    roberta = g("model_type", "bert") == "roberta"
    return BertConfig(
        position_style="roberta" if roberta else "bert",
        vocab_size=g("vocab_size"),
        hidden_size=g("hidden_size"),
        num_hidden_layers=g("num_hidden_layers"),
        num_attention_heads=g("num_attention_heads"),
        intermediate_size=g("intermediate_size"),
        hidden_act=g("hidden_act", "gelu"),
        hidden_dropout_prob=g("hidden_dropout_prob", 0.1),
        attention_probs_dropout_prob=g("attention_probs_dropout_prob", 0.1),
        max_position_embeddings=g("max_position_embeddings", 512),
        type_vocab_size=g("type_vocab_size", 2),
        layer_norm_eps=g("layer_norm_eps", 1e-12),
        pad_token_id=g("pad_token_id", 0),
    )


def _backbone(sd: Mapping, prefix: str, pooler: bool) -> Dict:
    """The keys of sd under prefix, prefix dropped, without the HF
    buffers, and without the pooler unless the model has one."""
    out = {}
    for k, v in sd.items():
        if not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        if k in _BUFFERS or (k.startswith("pooler.") and not pooler):
            continue
        if k.startswith(("embeddings.", "encoder.", "pooler.")):
            out[k] = _tensor(v)
    return out


def _backbone_prefix(sd: Mapping) -> str:
    for prefix in ("bert.", "roberta."):
        if any(k.startswith(prefix + "embeddings.") for k in sd):
            return prefix
    return ""


def state_dict_from_hf(sd: Mapping, cfg: DualEncoderConfig
                       ) -> Dict[str, torch.Tensor]:
    """A HuggingFace or reference checkpoint's state dict (tensors or
    numpy arrays) -> state dict of a models.dual_encoder.DualEncoder of
    cfg: a BertModel / RobertaModel, a full `bert.` / `roberta.` model
    with the rdot_nll head, or a DPR BiEncoder; or a DeepSeek-V2 one
    (the tower's tensors as they are, in their own dtype)."""
    if is_decoder(cfg.bert):
        out = deepseek_v2.state_dict_from_hf(sd, cfg.bert)
        if cfg.use_head:
            out.update({"head." + ours: _tensor(sd[theirs])
                        for ours, theirs in _HEAD.items()})
        return out
    pooler = cfg.pooling == "pooler"
    if cfg.two_tower:
        return {f"{tower}.{k}": v for tower, prefix in _DPR.items()
                for k, v in _backbone(sd, prefix, pooler).items()}
    out = {"encoder." + k: v
           for k, v in _backbone(sd, _backbone_prefix(sd), pooler).items()}
    if cfg.use_head:
        out.update({"head." + ours: _tensor(sd[theirs])
                    for ours, theirs in _HEAD.items()})
    return out


def state_dict_to_hf(state_dict: Mapping, cfg: DualEncoderConfig
                     ) -> Dict[str, torch.Tensor]:
    """Inverse of state_dict_from_hf: a DualEncoder's state dict -> the
    reference's naming (`question_model.` / `ctx_model.` for two towers;
    else `roberta.` or `bert.` by the position style, and the head as
    `embeddingHead.*` / `norm.*`)."""
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    if cfg.two_tower:
        return {prefix + k[len(tower) + 1:]: v
                for tower, prefix in _DPR.items()
                for k, v in sd.items() if k.startswith(tower + ".")}
    backbone = ("roberta." if cfg.bert.position_style == "roberta"
                else "bert.")
    out = {backbone + k[len("encoder."):]: v for k, v in sd.items()
           if k.startswith("encoder.")}
    if cfg.use_head:
        out.update({theirs: sd["head." + ours]
                    for ours, theirs in _HEAD.items()})
    return out


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A pytorch_model.bin or model.safetensors -> float32 CPU tensors.
    The safetensors package is imported only for a .safetensors file; a
    machine without it raises ImportError there."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _tensor(v) for k, v in sd.items()}
