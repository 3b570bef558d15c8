"""What the benchmark builds of the program (cocodr_tpu_torch) from a
configuration file and the harness's weights; the drivers call it."""
from __future__ import annotations

from typing import Callable, Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def bert_config(cfg: dict, **kw):
    """The port's BertConfig from a configuration's HuggingFace keys."""
    from cocodr_tpu_torch.models.bert import BertConfig

    keys = ("vocab_size", "hidden_size", "num_hidden_layers",
            "num_attention_heads", "intermediate_size", "hidden_act",
            "hidden_dropout_prob", "attention_probs_dropout_prob",
            "max_position_embeddings", "type_vocab_size",
            "initializer_range", "layer_norm_eps", "pad_token_id")
    return BertConfig(**{k: cfg[k] for k in keys},
                      dtype=DTYPES[cfg["compute_dtype"]], **kw)


def with_weights(build: Callable[[], torch.nn.Module],
                 weights: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """build() on the meta device, then the harness's tensors put in as its
    parameters (every name matched): nothing is drawn or copied twice."""
    with torch.device("meta"):
        model = build()
    model.load_state_dict(weights, strict=True, assign=True)
    return model


def dual_encoder(cfg: dict, weights: Dict[str, torch.Tensor], **kw):
    """COCO-DR's rdot_nll_condenser dual encoder (one shared tower, the raw
    CLS vector) holding `weights` (names under `encoder.`), in eval mode."""
    from cocodr_tpu_torch.models.dual_encoder import (
        DualEncoder,
        DualEncoderConfig,
    )

    bert = bert_config(cfg, **kw)
    model = with_weights(
        lambda: DualEncoder(DualEncoderConfig.rdot_nll_condenser(bert)),
        weights)
    return model.eval()


def condenser(cfg: dict, weights: Dict[str, torch.Tensor], traffic: dict):
    """COCO's CoCondenserForPretraining holding `weights` (`bert.`, `cls.`,
    `c_head.` names), with the traffic's head settings."""
    from cocodr_tpu_torch.models.condenser import CoCondenserForPretraining

    bert = bert_config(cfg)
    return with_weights(lambda: CoCondenserForPretraining(
        bert, n_head_layers=traffic["n_head_layers"],
        skip_from=traffic["skip_from"], late_mlm=traffic["late_mlm"],
        mlm_budget_frac=traffic["mlm_budget_frac"]), weights)
