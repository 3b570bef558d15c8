"""Dual-encoder retrieval models: the counterpart of
cocodr_tpu/models/dual_encoder.py for the shared-tower model types
`rdot_nll` (CLS + linear/LayerNorm head) and `rdot_nll_condenser` (raw
CLS). Query and document towers share weights; multi-chunk documents, the
DPR two-tower model and the tanh pooler come with later slices. In training
each tower's forward takes its own dropout generator
(pipelines/train_step.py::embed_triplet).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from cocodr_tpu_torch.models.bert import (
    BertConfig,
    BertModel,
    LayerNorm,
    init_weights,
    linear,
)
from cocodr_tpu_torch.ops._device import resolve_device


def masked_mean(hidden, mask):
    """Mean over non-padding positions. hidden [B, S, H], mask [B, S]."""
    m = mask[..., None].float()
    return (hidden.float() * m).sum(1) / m.sum(1)


def pool(hidden, mask, method: str):
    if method == "cls":
        return hidden[:, 0]
    if method == "mean":
        return masked_mean(hidden, mask).to(hidden.dtype)
    raise ValueError(method)


class ProjectionHead(nn.Module):
    """linear(hidden -> out_dim) + LayerNorm (the rdot_nll head). The head
    LayerNorm's eps is torch's default 1e-5, not the encoder's, as in the
    reference checkpoints."""

    def __init__(self, cfg: BertConfig, out_dim: int = 768,
                 ln_eps: float = 1e-5):
        super().__init__()
        self.dtype = cfg.dtype
        self.dense = nn.Linear(cfg.hidden_size, out_dim)
        self.layer_norm = LayerNorm(out_dim, ln_eps, cfg.dtype)

    def forward(self, x):
        return self.layer_norm(linear(x, self.dense, self.dtype))


@dataclasses.dataclass(frozen=True)
class DualEncoderConfig:
    bert: BertConfig
    pooling: str = "cls"  # 'cls' | 'mean'
    use_head: bool = False  # linear + LayerNorm projection after pooling
    head_dim: int = 768

    @classmethod
    def rdot_nll(cls, bert: BertConfig, **kw) -> "DualEncoderConfig":
        return cls(bert=bert, pooling="cls", use_head=True, **kw)

    @classmethod
    def rdot_nll_condenser(cls, bert: BertConfig, **kw) -> "DualEncoderConfig":
        # BertDot_NLL_LN: raw CLS embedding, no projection head
        return cls(bert=bert, pooling="cls", use_head=False, **kw)


class DualEncoder(nn.Module):
    """Shared-tower dual encoder producing dense embeddings."""

    def __init__(self, cfg: DualEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = BertModel(cfg.bert)
        self.head = (ProjectionHead(cfg.bert, cfg.head_dim)
                     if cfg.use_head else None)

    def _emb(self, input_ids, attention_mask, token_type_ids=None,
             generator=None):
        last = self.encoder(input_ids, attention_mask, token_type_ids,
                            generator)
        e = pool(last, attention_mask, self.cfg.pooling)
        return self.head(e) if self.head is not None else e

    def query_emb(self, input_ids, attention_mask, token_type_ids=None,
                  generator=None):
        """generator: the dropout masks' torch.Generator in training mode
        (models.bert.BertModel.forward)."""
        return self._emb(input_ids, attention_mask, token_type_ids,
                         generator)

    def body_emb(self, input_ids, attention_mask, token_type_ids=None,
                 generator=None):
        return self._emb(input_ids, attention_mask, token_type_ids,
                         generator)

    def forward(self, input_ids, attention_mask):
        return self.query_emb(input_ids, attention_mask)


# Keys are the reference's --model_type values.
MODEL_REGISTRY = {
    "rdot_nll": DualEncoderConfig.rdot_nll,
    "rdot_nll_condenser": DualEncoderConfig.rdot_nll_condenser,
}


def build_dual_encoder(model_type: str, bert: BertConfig, device="cuda",
                       generator: torch.Generator | None = None,
                       **kw) -> DualEncoder:
    """A DualEncoder in eval mode on `device`, its weights drawn as BERT's
    initialisation (normal, std bert.initializer_range) from `generator`
    (a CPU torch.Generator; a fresh one seeded 0 when None)."""
    if model_type not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown model_type {model_type!r}; known: {sorted(MODEL_REGISTRY)}"
        )
    dev = resolve_device(device)
    model = DualEncoder(MODEL_REGISTRY[model_type](bert, **kw))
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, bert.initializer_range, generator)
    return model.to(dev).eval()
