"""Triplet 2-way softmax NLL, the warmup training loss: the counterpart of
cocodr_tpu/losses/nll.py (logits = [q·d+, q·d-], loss = -log_softmax[0]),
and its multi-chunk form, where a document scores by its best chunk."""
from __future__ import annotations

import torch

from cocodr_tpu_torch.models.dual_encoder import chunk_max_score


def triplet_nll(q_emb, pos_emb, neg_emb):
    """Per-sample 2-way NLL. q_emb, pos_emb, neg_emb [B, D] in any float
    dtype; the dot products are float32. -> (loss [B], acc [B],
    logits [B, 2]); acc is 1 where the positive outranks the negative."""
    q = q_emb.float()
    pos = (q * pos_emb.float()).sum(-1)
    neg = (q * neg_emb.float()).sum(-1)
    return _two_way(pos, neg)


def triplet_nll_multichunk(q_emb, pos_chunk_emb, pos_chunk_mask,
                           neg_chunk_emb, neg_chunk_mask):
    """Per-sample 2-way NLL over multi-chunk documents: each document's
    score is models.dual_encoder.chunk_max_score (reference
    ANCE/model/models.py:307-357). q_emb [B, D]; *_chunk_emb [B, C, D];
    *_chunk_mask [B, C] -> (loss [B], acc [B], logits [B, 2])."""
    pos = chunk_max_score(q_emb, pos_chunk_emb, pos_chunk_mask)
    neg = chunk_max_score(q_emb, neg_chunk_emb, neg_chunk_mask)
    return _two_way(pos, neg)


def _two_way(pos, neg):
    logits = torch.stack([pos, neg], dim=1)
    loss = -torch.log_softmax(logits, dim=1)[:, 0]
    acc = (logits.argmax(dim=1) == 0).float()
    return loss, acc, logits
