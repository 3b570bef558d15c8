"""Triplet 2-way softmax NLL, the warmup training loss: the counterpart of
cocodr_tpu/losses/nll.py::triplet_nll (logits = [q·d+, q·d-],
loss = -log_softmax[0])."""
from __future__ import annotations

import torch


def triplet_nll(q_emb, pos_emb, neg_emb):
    """Per-sample 2-way NLL. q_emb, pos_emb, neg_emb [B, D] in any float
    dtype; the dot products are float32. -> (loss [B], acc [B],
    logits [B, 2]); acc is 1 where the positive outranks the negative."""
    q = q_emb.float()
    pos = (q * pos_emb.float()).sum(-1)
    neg = (q * neg_emb.float()).sum(-1)
    logits = torch.stack([pos, neg], dim=1)
    loss = -torch.log_softmax(logits, dim=1)[:, 0]
    acc = (logits.argmax(dim=1) == 0).float()
    return loss, acc, logits
