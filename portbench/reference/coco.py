"""A plain coCondenser pretraining step in float32: the Condenser forward
(backbone, a c_head over [the last CLS, the skip layer's tokens]), the MLM
head's loss on the c_head's and the backbone's outputs, the span
contrastive loss, the backward, clipping by global norm and AdamW, as
COCO-DR's COCO stage defines them (reference COCO/modeling.py, optax's
adamw numerics).

Dropout follows the program's stated protocol for its masks: a step's
generator on the card is seeded from (dropout seed, step) through numpy's
SeedSequence, and draws, in order, the embeddings' mask [B, S, H], then
for each backbone layer and then each c_head layer the attention
probabilities' [B, N, S, S], the attention output's and the FFN output's
[B, S, H], each element kept where a uniform draw is below 1 - p. The
masks are drawn up front, so that layers recomputed in the backward
(torch.utils.checkpoint, which keeps only each layer's input) see the same
ones.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.bert import (
    embed,
    float32_products,
    layer,
    layer_norm,
    linear,
    rounded,
)

IGNORE = -100
BETAS = (0.9, 0.999)


def step_seed(seed: int, step: int) -> int:
    ss = np.random.SeedSequence([seed, step])
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


def draw_keeps(seed: int, step: int, device, B: int, S: int, cfg: dict,
               n_layers: int):
    """The step's dropout masks -> (embeddings [B, S, H], [(attention
    [B, N, S, S], attention output, FFN output)] a layer)."""
    H, N = cfg["hidden_size"], cfg["num_attention_heads"]
    ph, pa = cfg["hidden_dropout_prob"], cfg["attention_probs_dropout_prob"]
    g = torch.Generator(device=device)
    g.manual_seed(step_seed(seed, step))

    def keep(shape, p):
        return torch.rand(shape, generator=g, device=device) < 1 - p

    emb = keep((B, S, H), ph)
    layers = [(keep((B, N, S, S), pa), keep((B, S, H), ph),
               keep((B, S, H), ph)) for _ in range(n_layers)]
    return emb, layers


def coco_loss(W: Dict[str, torch.Tensor], cfg: dict, head: dict, batch,
              keeps, rnd: Optional[Callable] = None):
    """The step's loss: head MLM + late MLM (when head['late_mlm']) + the
    contrastive loss. batch: (input_ids, attention_mask, labels) [B, S]."""
    ids, attn, labels = batch
    key_mask = attn.bool()
    L, H = cfg["num_hidden_layers"], cfg["hidden_size"]
    emb_keep, layer_keeps = keeps
    h = embed(W, "bert.", cfg, ids, emb_keep, rnd)
    hiddens = [h]
    for i in range(L):
        h = checkpoint(layer, W, f"bert.encoder.layer.{i}.", cfg, h,
                       key_mask, layer_keeps[i], rnd, use_reentrant=False)
        hiddens.append(h)
    hh = torch.cat([h[:, :1], hiddens[min(head["skip_from"], L)][:, 1:]], 1)
    for j in range(head["n_head_layers"]):
        hh = checkpoint(layer, W, f"c_head.{j}.", cfg, hh, key_mask,
                        layer_keeps[L + j], rnd, use_reentrant=False)
    flat = labels.reshape(-1)
    sel = flat != IGNORE
    target = flat[sel].long()
    t = "cls.predictions.transform."

    def mlm(x):
        x = x.reshape(-1, H)[sel]
        u = rounded(F.gelu(linear(x, W[t + "dense.weight"],
                                  W[t + "dense.bias"], rnd)), rnd)
        u = rounded(layer_norm(u, W[t + "LayerNorm.weight"],
                               W[t + "LayerNorm.bias"],
                               cfg["layer_norm_eps"]), rnd)
        logits = linear(u, W["bert.embeddings.word_embeddings.weight"],
                        W["cls.predictions.bias"], rnd)
        if not len(target):
            return logits.sum() * 0.0
        return F.cross_entropy(logits, target)

    loss = mlm(hh) + (mlm(h) if head["late_mlm"] else 0.0)
    cls = h[:, 0]
    n = cls.shape[0]
    sim = (cls @ cls.T).masked_fill(
        torch.eye(n, dtype=torch.bool, device=cls.device), float("-inf"))
    pairs = torch.arange(n, device=cls.device).view(-1, 2).flip(1).reshape(-1)
    return loss + F.cross_entropy(sim, pairs)


def lr_at(opt: dict, count: int) -> float:
    """Linear warmup to opt['lr'] over warmup_steps, then linear decay to 0
    at total_steps, at the update count before it increments."""
    c, w, T = (np.float32(count), np.float32(max(1, opt["warmup_steps"])),
               np.float32(opt["total_steps"]))
    warm = c / w
    decay = (T - c) / np.float32(max(1, opt["total_steps"]
                                     - opt["warmup_steps"]))
    return float(np.float32(opt["lr"])
                 * np.float32(min(max(min(warm, decay), 0.0), 1.0)))


@torch.no_grad()
def clip_and_adamw(params: Dict[str, torch.Tensor], state: dict, opt: dict,
                   count: int):
    """optax.clip_by_global_norm, then optax.adamw's update, in place."""
    grads = {n: p.grad for n, p in params.items()}
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
    if opt["max_grad_norm"] > 0 and norm >= opt["max_grad_norm"]:
        for g in grads.values():
            g.mul_(opt["max_grad_norm"] / norm)
    b1, b2 = BETAS
    t = np.float32(count + 1)
    bc1 = float(np.float32(1) - np.float32(b1) ** t)
    bc2 = float(np.float32(1) - np.float32(b2) ** t)
    lr = lr_at(opt, count)
    for n, p in params.items():
        g = grads[n]
        m, v = state.setdefault(n, (torch.zeros_like(p), torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).add_(g * g, alpha=1 - b2)
        update = (m / bc1) / (torch.sqrt(v / bc2) + opt["eps"])
        update = update + opt["weight_decay"] * p
        p.add_(update, alpha=-lr)


def reference_steps(W0: Dict[str, torch.Tensor], cfg: dict, head: dict,
                    opt: dict, batches: Sequence, seeds: Sequence[int],
                    dropout_seed: Optional[int], rnd=None,
                    moments: Optional[dict] = None, count0: int = 0):
    """Steps from the weights W0 (left as they are) -> (losses, {name: norm
    of the first step's clipped gradient}, {name: norm of the weights'
    change after the last step}). batches: (ids, mask, labels) device
    tensors; seeds[i]: the step number the i-th step's dropout masks are
    drawn for (None dropout_seed: no dropout). From the start of training
    by default; from a state part-way through given the Adam moments
    ({name: (m, v)}, left as they are) and count0, the updates taken
    before the first of these steps."""
    params = {n: w.detach().clone().requires_grad_() for n, w in W0.items()}
    L = cfg["num_hidden_layers"] + head["n_head_layers"]
    state: dict = {n: (m.clone(), v.clone())
                   for n, (m, v) in (moments or {}).items()}
    losses: List[float] = []
    grad1 = {}
    with float32_products():
        for i, (batch, step) in enumerate(zip(batches, seeds)):
            B, S = batch[0].shape
            keeps = (draw_keeps(dropout_seed, step, batch[0].device, B, S,
                                cfg, L) if dropout_seed is not None
                     else (None, [None] * L))
            for p in params.values():
                p.grad = None
            loss = coco_loss(params, cfg, head, batch, keeps, rnd)
            loss.backward()
            losses.append(float(loss.detach()))
            del keeps
            clip_and_adamw(params, state, opt, count0 + i)
            if i == 0:
                grad1 = {n: float(p.grad.norm()) for n, p in params.items()}
    change = {n: float((p.detach() - W0[n]).norm())
              for n, p in params.items()}
    return losses, grad1, change
