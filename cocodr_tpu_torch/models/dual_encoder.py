"""Dual-encoder retrieval models: the counterpart of
cocodr_tpu/models/dual_encoder.py, with the reference's model types
`rdot_nll` (CLS + linear/LayerNorm head), `rdot_nll_condenser` (raw CLS),
`rdot_nll_multi_chunk` (rdot_nll over documents of several chunks of
`chunk_len` tokens, one vector a chunk) and `dpr` (two towers, each
embedding by its tanh pooler). The tower is a BERT-family encoder, or a
DeepSeek-V2 decoder (models/deepseek_v2.py) where the config's model_type
is 'deepseek_v2': that tower pools by its last real token ('last').
Query and document towers share weights
unless `two_tower`, which adds `doc_encoder` (and `doc_head` with a head).
A document input wider than `chunk_len` folds its chunks into the batch
and gives [B, C, D]; `chunk_max_score` scores such a document by its best
chunk. In training each tower's forward takes its own dropout generator
(pipelines/train_step.py::embed_triplet).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from cocodr_tpu_torch.models import deepseek_v2
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
    if method == "last":
        return deepseek_v2.last_token(hidden, mask)
    raise ValueError(method)  # 'pooler' is DualEncoder._emb's


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


def is_decoder(tower_cfg) -> bool:
    """Whether a tower config is a decoder's (DeepSeek-V2), by its
    model_type: such a tower pools by its last real token."""
    return getattr(tower_cfg, "model_type", "bert") == deepseek_v2.MODEL_TYPE


def first_or_last(tower_cfg) -> str:
    """'cls' for a BERT-family tower, 'last' for a decoder's."""
    return "last" if is_decoder(tower_cfg) else "cls"


def make_tower(tower_cfg, with_pooler: bool = False) -> nn.Module:
    if is_decoder(tower_cfg):
        if with_pooler:
            raise ValueError("a deepseek_v2 tower has no pooler")
        return deepseek_v2.DeepseekV2Model(tower_cfg)
    return BertModel(tower_cfg, with_pooler=with_pooler)


@dataclasses.dataclass(frozen=True)
class DualEncoderConfig:
    # the tower's config: a BertConfig, or a DeepseekV2Config
    bert: BertConfig
    # 'cls' | 'mean' | 'pooler' (the tanh pooler) | 'last' (the last real
    # token, padding on the right)
    pooling: str = "cls"
    use_head: bool = False  # linear + LayerNorm projection after pooling
    head_dim: int = 768
    two_tower: bool = False  # separate query and document towers (DPR)
    chunk_len: int = 0  # > 0: documents of several chunks of this length

    @classmethod
    def rdot_nll(cls, bert: BertConfig, **kw) -> "DualEncoderConfig":
        return cls(bert=bert, pooling=first_or_last(bert), use_head=True,
                   **kw)

    @classmethod
    def rdot_nll_multi_chunk(cls, bert: BertConfig, base_len: int = 512,
                             **kw) -> "DualEncoderConfig":
        return cls(bert=bert, pooling=first_or_last(bert), use_head=True,
                   chunk_len=base_len, **kw)

    @classmethod
    def dpr(cls, bert: BertConfig, **kw) -> "DualEncoderConfig":
        # the BiEncoder embeds by each tower's tanh pooler output
        return cls(bert=bert, pooling="pooler", use_head=False,
                   two_tower=True, **kw)

    @classmethod
    def rdot_nll_condenser(cls, bert: BertConfig, **kw) -> "DualEncoderConfig":
        # BertDot_NLL_LN: raw CLS embedding, no projection head (a
        # decoder tower's: its last real token)
        return cls(bert=bert, pooling=first_or_last(bert), use_head=False,
                   **kw)


class DualEncoder(nn.Module):
    """Shared- or two-tower dual encoder producing dense embeddings."""

    def __init__(self, cfg: DualEncoderConfig):
        super().__init__()
        self.cfg = cfg
        pooler = cfg.pooling == "pooler"
        self.encoder = make_tower(cfg.bert, pooler)
        self.doc_encoder = (make_tower(cfg.bert, pooler)
                            if cfg.two_tower else None)
        self.head = (ProjectionHead(cfg.bert, cfg.head_dim)
                     if cfg.use_head else None)
        self.doc_head = (ProjectionHead(cfg.bert, cfg.head_dim)
                         if cfg.use_head and cfg.two_tower else None)

    def _emb(self, encoder, head, input_ids, attention_mask,
             token_type_ids=None, generator=None):
        out = encoder(input_ids, attention_mask, token_type_ids, generator)
        if self.cfg.pooling == "pooler":
            e = out[1]
        else:
            e = pool(out, attention_mask, self.cfg.pooling)
        return head(e) if head is not None else e

    def query_emb(self, input_ids, attention_mask, token_type_ids=None,
                  generator=None):
        """generator: the dropout masks' torch.Generator in training mode
        (models.bert.BertModel.forward)."""
        return self._emb(self.encoder, self.head, input_ids, attention_mask,
                         token_type_ids, generator)

    def body_emb(self, input_ids, attention_mask, token_type_ids=None,
                 generator=None):
        """[B, S] -> [B, D]; with chunk_len and S > chunk_len, documents of
        S // chunk_len chunks -> [B, C, D] (`_multi_chunk_emb`)."""
        if self.cfg.two_tower:
            encoder, head = self.doc_encoder, self.doc_head
        else:
            encoder, head = self.encoder, self.head
        if self.cfg.chunk_len and input_ids.shape[1] > self.cfg.chunk_len:
            return self._multi_chunk_emb(encoder, head, input_ids,
                                         attention_mask, generator)
        return self._emb(encoder, head, input_ids, attention_mask,
                         token_type_ids, generator)

    def _multi_chunk_emb(self, encoder, head, input_ids, attention_mask,
                         generator=None):
        """[B, C * L] -> per-chunk embeddings [B, C, D]: the chunks fold
        into the batch as [B * C, L] rows (token types all 0), the layout
        of the reference (ANCE/model/models.py:369-386)."""
        B, full = input_ids.shape
        L = self.cfg.chunk_len
        C = full // L
        e = self._emb(encoder, head, input_ids.reshape(B * C, L),
                      attention_mask.reshape(B * C, L), None, generator)
        return e.reshape(B, C, -1)

    def forward(self, input_ids, attention_mask):
        return self.query_emb(input_ids, attention_mask)


def chunk_max_score(q_emb, doc_chunk_emb, chunk_mask):
    """A multi-chunk document's score: the max over its chunks' scores,
    float32 sums of the products, with a -9999 bias on padded chunks
    (reference ANCE/model/models.py:326-357). q_emb [B, D], doc_chunk_emb
    [B, C, D], chunk_mask [B, C] (1 = a real chunk) -> [B] float32."""
    scores = torch.einsum("bd,bcd->bc", q_emb.float(), doc_chunk_emb.float())
    bias = (1.0 - chunk_mask.float()) * -9999.0
    return (scores + bias).amax(-1)


# Keys are the reference's --model_type values.
MODEL_REGISTRY = {
    "rdot_nll": DualEncoderConfig.rdot_nll,
    "rdot_nll_multi_chunk": DualEncoderConfig.rdot_nll_multi_chunk,
    "rdot_nll_condenser": DualEncoderConfig.rdot_nll_condenser,
    "dpr": DualEncoderConfig.dpr,
}


def build_dual_encoder(model_type: str, bert: BertConfig, device="cuda",
                       generator: torch.Generator | None = None,
                       **kw) -> DualEncoder:
    """A DualEncoder in eval mode on `device`, its weights drawn as BERT's
    initialisation (normal, std bert.initializer_range; a deepseek_v2
    tower's by deepseek_v2.init_weights) from `generator`
    (a CPU torch.Generator; a fresh one seeded 0 when None)."""
    if model_type not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown model_type {model_type!r}; known: {sorted(MODEL_REGISTRY)}"
        )
    dev = resolve_device(device)
    model = DualEncoder(MODEL_REGISTRY[model_type](bert, **kw))
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    std = bert.initializer_range
    if is_decoder(bert):
        for tower in (model.encoder, model.doc_encoder):
            if tower is not None:
                deepseek_v2.init_weights(tower, std, generator)
        for head in (model.head, model.doc_head):
            if head is not None:
                init_weights(head, std, generator)
    else:
        init_weights(model, std, generator)
    return model.to(dev).eval()
