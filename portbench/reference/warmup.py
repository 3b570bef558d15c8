"""A plain BM25-warmup step in float32: the rdot_nll_condenser dual encoder
(one shared BERT tower, the raw CLS vector) over a batch of (query,
positive, negative) triples, the 2-way NLL (logits [q.d+, q.d-], loss
-log_softmax[0], the batch's mean), the backward, clipping by global norm
(optax's clip_by_global_norm) and the reference's LAMB (ANCE/utils/lamb.py,
as COCO-DR's warmup runs it: no bias correction, the weight norm clamped
to [0, 10], weight decay added before the trust ratio, a trust ratio of 1
where either norm is 0), under the linear warmup-and-decay schedule read at
the update count before it increments.

Used by drivers/warmup_train.py, which is not yet a cell (its docstring
says why).

Dropout follows the program's stated protocol for its masks: a step's
three generators, one a tower (query, positive, negative), are seeded from
(dropout seed, step, tower) through numpy's SeedSequence, and each draws,
in order, the embeddings' mask [B, S, H], then for each layer the attention
probabilities' [B, N, S, S], the attention output's and the FFN output's
[B, S, H], each element kept where a uniform draw is below 1 - p.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.bert import embed, float32_products, layer
from portbench.reference.coco import lr_at

BETAS = (0.9, 0.999)
PREFIX = "encoder."
TOWERS = (("q_ids", "q_mask"), ("pos_ids", "pos_mask"),
          ("neg_ids", "neg_mask"))


def tower_keeps(seed: int, step: int, tower: int, device, B: int, S: int,
                cfg: dict):
    """One tower's dropout masks at a step -> (embeddings [B, S, H],
    [(attention [B, N, S, S], attention output, FFN output)] a layer)."""
    H, N = cfg["hidden_size"], cfg["num_attention_heads"]
    ph, pa = cfg["hidden_dropout_prob"], cfg["attention_probs_dropout_prob"]
    ss = np.random.SeedSequence([seed, step, tower])
    g = torch.Generator(device=device)
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0] >> 1))

    def keep(shape, p):
        return torch.rand(shape, generator=g, device=device) < 1 - p

    emb = keep((B, S, H), ph)
    return emb, [(keep((B, N, S, S), pa), keep((B, S, H), ph),
                  keep((B, S, H), ph))
                 for _ in range(cfg["num_hidden_layers"])]


def cls_rows(W, cfg, ids, mask, keeps, rnd=None):
    emb_keep, layer_keeps = keeps if keeps is not None else (None, None)
    h = embed(W, PREFIX, cfg, ids, emb_keep, rnd)
    for i in range(cfg["num_hidden_layers"]):
        h = layer(W, f"{PREFIX}encoder.layer.{i}.", cfg, h, mask.bool(),
                  layer_keeps[i] if layer_keeps is not None else None, rnd)
    return h[:, 0]


def nll_loss(W, cfg, batch, keeps, rnd=None):
    """The batch's mean 2-way NLL; batch: the six [B, S] tensors by the
    program's names; keeps: each tower's masks (None: no dropout)."""
    q, p, n = (cls_rows(W, cfg, batch[i], batch[m], k, rnd)
               for (i, m), k in zip(TOWERS, keeps))
    logits = torch.stack([(q * p).sum(-1), (q * n).sum(-1)], 1)
    return -F.log_softmax(logits, 1)[:, 0].mean()


@torch.no_grad()
def clip_and_lamb(params: Dict[str, torch.Tensor], state: dict, opt: dict,
                  count: int):
    """clip_by_global_norm, then the reference's LAMB update, in place."""
    grads = {n: p.grad for n, p in params.items()}
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    if opt["max_grad_norm"] > 0 and norm >= opt["max_grad_norm"]:
        for g in grads.values():
            g.mul_(opt["max_grad_norm"] / norm)
    b1, b2 = BETAS
    lr = lr_at(opt, count)
    for n, p in params.items():
        g = grads[n]
        m, v = state.setdefault(n, (torch.zeros_like(p), torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).add_(g * g, alpha=1 - b2)
        step = m / (torch.sqrt(v) + opt["eps"]) + opt["weight_decay"] * p
        w, a = p.norm().clamp(0.0, 10.0), step.norm()
        trust = 1.0 if w == 0 or a == 0 else w / a
        p.add_(step * trust, alpha=-lr)


def reference_steps(W0: Dict[str, torch.Tensor], cfg: dict, opt: dict,
                    batches: Sequence[dict], steps: Sequence[int],
                    dropout_seed: Optional[int], rnd=None,
                    moments: Optional[dict] = None, count0: int = 0):
    """Steps from the weights W0 (left as they are) -> (losses, {name: norm
    of the first step's clipped gradient}, {name: norm of the weights'
    change after the last step}). batches: dicts of device tensors;
    steps[i]: the step number the i-th step's masks are drawn for (None
    dropout_seed: no dropout). From the start of training by default; from
    a state part-way through given the LAMB moments ({name: (m, v)}, left
    as they are) and count0, the updates taken before the first of these
    steps."""
    params = {n: w.detach().clone().requires_grad_() for n, w in W0.items()}
    state: dict = {n: (m.clone(), v.clone())
                   for n, (m, v) in (moments or {}).items()}
    losses: List[float] = []
    grad1 = {}
    with float32_products():
        for i, (batch, step) in enumerate(zip(batches, steps)):
            keeps = [None] * 3
            if dropout_seed is not None:
                keeps = [tower_keeps(dropout_seed, step, t, batch[ids].device,
                                     *batch[ids].shape, cfg)
                         for t, (ids, _) in enumerate(TOWERS)]
            for p in params.values():
                p.grad = None
            loss = nll_loss(params, cfg, batch, keeps, rnd)
            loss.backward()
            losses.append(float(loss.detach()))
            del keeps
            clip_and_lamb(params, state, opt, count0 + i)
            if i == 0:
                grad1 = {n: float(p.grad.norm()) for n, p in params.items()}
    change = {n: float((p.detach() - W0[n]).norm())
              for n, p in params.items()}
    return losses, grad1, change
