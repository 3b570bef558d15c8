"""Condenser and coCondenser pretraining heads (the COCO stage): the
counterpart of cocodr_tpu/models/condenser.py (reference
COCO/modeling.py:34-248).

- The backbone (`bert`, models.bert.BertModel) runs with its hidden states
  collected.
- A `c_head` of fresh BertLayers runs over [CLS of the last layer,
  hidden_states[skip_from][:, 1:]] (modeling.py:70-79).
- The head's MLM loss goes through the MLM transform and the tied decoder;
  `late_mlm` adds the backbone's own MLM loss (modeling.py:82-83).
- coCondenser adds the span contrastive loss over the backbone's CLS
  embeddings (losses/contrastive.py).

The MLM decoder runs on a budget of rows: the masked positions gathered
first (a stable argsort), padded to ceil(int(T * mlm_budget_frac) / 128) *
128 rows of T = B * S, so the [rows, vocab] logits stay a fraction of the
dense [T, vocab] ones; the loss is the dense path's while the budget holds
every masked position, and the dense path runs when the budget is not
smaller than T. With late_mlm the head's and the backbone's rows go through
one decoder product over [2 * budget, vocab].

State dict names are HuggingFace's: `bert.embeddings.*`, `bert.encoder.*`,
`cls.predictions.transform.*`, `cls.predictions.bias` and `c_head.{i}.*`.
`split_state_dict` gives the reference's checkpoint split, the backbone
with its MLM head and the c_head apart (the `model.pt` of
COCO/modeling.py:123-131), and `join_state_dict` is its inverse.

Dropout draws from the one generator the caller hands down: the
backbone's layers first, then the c_head's. A backbone-only forward
(`cls_emb`) started from the same generator state therefore draws the
masks the backbone draws in a full forward; the grad cache of
pipelines/coco.py relies on it.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cocodr_tpu_torch.losses.contrastive import co_contrastive_loss
from cocodr_tpu_torch.models.bert import (
    BertConfig,
    BertLayer,
    BertMLMTransform,
    BertModel,
    init_weights,
    make_attention_bias,
)
from cocodr_tpu_torch.ops._device import resolve_device

IGNORE_INDEX = -100


def mlm_cross_entropy(logits, labels):
    """Mean cross-entropy over the positions whose label is not -100, in
    float32 (HuggingFace's CrossEntropyLoss); 0 when there is none."""
    vocab = logits.shape[-1]
    labels = labels.reshape(-1).long()
    nll = F.cross_entropy(logits.reshape(-1, vocab).float(), labels,
                          ignore_index=IGNORE_INDEX, reduction="sum")
    return nll / (labels != IGNORE_INDEX).sum().clamp_min(1)


class BertLMPredictionHead(nn.Module):
    """`cls.predictions`: the transform and the decoder's float32 bias; the
    decoder's weight is the word embeddings (tied)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.transform = BertMLMTransform(cfg)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))


class CondenserForPretraining(nn.Module):
    def __init__(self, cfg: BertConfig, n_head_layers: int = 2,
                 skip_from: int = 6, late_mlm: bool = False,
                 mlm_budget_frac: float = 0.25):
        super().__init__()
        self.cfg = cfg
        self.skip_from = skip_from
        self.late_mlm = late_mlm
        self.mlm_budget_frac = mlm_budget_frac
        self.bert = BertModel(cfg)
        self.cls = nn.ModuleDict({"predictions": BertLMPredictionHead(cfg)})
        self.c_head = nn.ModuleList(BertLayer(cfg)
                                    for _ in range(n_head_layers))

    def mlm_logits(self, hiddens):
        """[..., H] -> float32 [..., vocab]: the tied decoder's product in
        the compute dtype, then the float32 bias."""
        pred = self.cls["predictions"]
        logits = self.bert.mlm_logits_from_embed(pred.transform(hiddens))
        return logits + pred.bias

    def _mlm_budget(self, labels):
        """(order, l_sel) gathering the masked positions into the padded
        budget, or None when the budget does not beat the dense path."""
        T = labels.numel()
        budget = math.ceil(int(T * self.mlm_budget_frac) / 128) * 128
        if budget >= T:
            return None
        flat = labels.reshape(T)
        # masked positions first, in their order; the budget's other rows
        # keep IGNORE_INDEX labels
        order = torch.argsort((flat == IGNORE_INDEX).to(torch.uint8),
                              stable=True)[:budget]
        return order, flat[order]

    def mlm_loss(self, hiddens, labels):
        """mlm_cross_entropy(mlm_logits(hiddens), labels) over the budget's
        rows."""
        sel = self._mlm_budget(labels)
        if sel is None:
            return mlm_cross_entropy(self.mlm_logits(hiddens), labels)
        order, l_sel = sel
        h_sel = hiddens.reshape(-1, hiddens.shape[-1])[order]
        return mlm_cross_entropy(self.mlm_logits(h_sel), l_sel)

    def mlm_loss_pair(self, h_head, h_late, labels):
        """(head loss, late loss) from one budget gather and one decoder
        product over the [2 * budget, H] rows of both."""
        sel = self._mlm_budget(labels)
        if sel is None:
            return self.mlm_loss(h_head, labels), self.mlm_loss(h_late,
                                                                labels)
        order, l_sel = sel
        H = h_head.shape[-1]
        both = torch.cat([h_head.reshape(-1, H)[order],
                          h_late.reshape(-1, H)[order]])
        logits = self.mlm_logits(both)
        budget = order.shape[0]
        return (mlm_cross_entropy(logits[:budget], l_sel),
                mlm_cross_entropy(logits[budget:], l_sel))

    def encode(self, input_ids, attention_mask, generator=None):
        """-> (last [B, S, H], hidden_states)."""
        return self.bert(input_ids, attention_mask, generator=generator,
                         output_hidden_states=True)

    def head_hiddens(self, last, hidden_states, attention_mask,
                     generator=None):
        """[CLS of the last layer, hidden_states[skip_from][:, 1:]] through
        the c_head. A skip_from past the depth takes the last layer, as the
        JAX package's clamped index into its [L + 1, ...] stack does (a
        preset's skip_from 6 on a shallower backbone)."""
        skip = hidden_states[min(self.skip_from, len(hidden_states) - 1)]
        h = torch.cat([last[:, :1], skip[:, 1:]], dim=1)
        bias = make_attention_bias(attention_mask)
        for layer in self.c_head:
            h = layer(h, bias, generator)
        return h

    def cls_emb(self, input_ids, attention_mask, generator=None):
        """The backbone's CLS only: the grad cache's first pass."""
        return self.bert(input_ids, attention_mask, generator=generator)[:, 0]

    def forward(self, input_ids, attention_mask, labels, generator=None):
        """-> (MLM loss, aux: cls [B, H], head_mlm_loss,
        backbone_mlm_loss). generator: dropout's torch.Generator in
        training mode."""
        last, hidden_states = self.encode(input_ids, attention_mask,
                                          generator)
        h = self.head_hiddens(last, hidden_states, attention_mask, generator)
        if self.late_mlm:
            head_loss, late_loss = self.mlm_loss_pair(h, last, labels)
            loss = head_loss + late_loss
        else:
            head_loss = self.mlm_loss(h, labels)
            loss = head_loss
            late_loss = torch.zeros((), device=last.device)
        return loss, {"cls": last[:, 0], "head_mlm_loss": head_loss,
                      "backbone_mlm_loss": late_loss}


class CoCondenserForPretraining(CondenserForPretraining):
    """Condenser plus the span contrastive loss (reference
    COCO/modeling.py:163-248). A batch holds two consecutive spans a
    document."""

    def loss_with_contrastive(self, input_ids, attention_mask, labels,
                              axis_name: Optional[str] = None,
                              generator=None):
        mlm_total, aux = self(input_ids, attention_mask, labels, generator)
        aux["co_loss"] = co_contrastive_loss(aux["cls"], axis_name=axis_name)
        return mlm_total + aux["co_loss"], aux


def build_condenser(cfg: BertConfig, device="cuda",
                    generator: Optional[torch.Generator] = None,
                    **kw) -> CoCondenserForPretraining:
    """A CoCondenserForPretraining in eval mode on `device`, its weights
    drawn as BERT's initialisation (normal, std cfg.initializer_range;
    biases and the decoder bias zero) from `generator` (a CPU
    torch.Generator; a fresh one seeded 0 when None). kw: n_head_layers,
    skip_from, late_mlm, mlm_budget_frac."""
    dev = resolve_device(device)
    model = CoCondenserForPretraining(cfg, **kw)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, cfg.initializer_range, generator)
    return model.to(dev).eval()


BACKBONE, MLM_HEAD, C_HEAD = "bert.", "cls.", "c_head."


def split_state_dict(sd: Mapping[str, torch.Tensor]
                     ) -> Tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """A Condenser's state dict -> (backbone_sd, c_head_sd): backbone_sd the
    HuggingFace BertModel names with the MLM head's (`embeddings.*`,
    `encoder.*`, `cls.predictions.*`), c_head_sd the `c_head.{i}.*` names
    of the reference's model.pt."""
    backbone, head = {}, {}
    for k, v in sd.items():
        if k.startswith(BACKBONE):
            backbone[k[len(BACKBONE):]] = v
        elif k.startswith(MLM_HEAD):
            backbone[k] = v
        elif k.startswith(C_HEAD):
            head[k] = v
        else:
            raise KeyError(f"not a Condenser parameter: {k}")
    return backbone, head


def join_state_dict(backbone_sd: Mapping[str, torch.Tensor],
                    c_head_sd: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """The inverse of split_state_dict."""
    out = {(k if k.startswith(MLM_HEAD) else BACKBONE + k): v
           for k, v in backbone_sd.items()}
    out.update(c_head_sd)
    return out
