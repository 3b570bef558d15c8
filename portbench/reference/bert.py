"""A plain BERT encoder in float32, from HuggingFace-named weights.

Post-LayerNorm layers with exact-erf GELU, as bert-base-uncased and
bert-large-uncased. Every float32 product runs with TF32 off on the card
(`float32_products`). `rnd`, for the control that computes the same in a
lower precision (`fp8_e4m3`), rounds every tensor the computation holds
between its steps: the operands of each product, each product's output,
the LayerNorm outputs, the attention probabilities and the residual
stream; statistics and sums stay float32.
Dropout, where a caller gives masks, multiplies by the kept elements'
mask over 1 - p, in the places HuggingFace's BERT puts it: the embeddings'
output, the attention probabilities, the attention output and the FFN
output.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Round = Optional[Callable[[torch.Tensor], torch.Tensor]]


@contextlib.contextmanager
def float32_products():
    """TF32 off for the float32 products on the card, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _to_fp8(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / largest
    return (x / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    """Forward: e4m3 with one scale a tensor; backward: the gradient in
    e5m2 with one scale a tensor, as float8 training keeps its gradients."""

    @staticmethod
    def forward(ctx, x):
        return _to_fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _to_fp8(g, torch.float8_e5m2, 57344.0)


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude at e4m3's largest, 448), back in float32; its gradient
    rounded to e5m2 likewise."""
    return _Fp8.apply(x)


def rounded(x, rnd: Round):
    return x if rnd is None else rnd(x)


def linear(x, w, b, rnd: Round = None):
    if rnd is not None:
        x, w = rnd(x), rnd(w)
    return rounded(F.linear(x, w, b), rnd)


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def dropped(x, keep, p):
    return x if keep is None else x * keep / (1.0 - p)


def embed(W: Dict[str, torch.Tensor], prefix: str, cfg: dict, ids,
          keep=None, rnd: Round = None):
    """Token ids [B, S] -> the embeddings' output [B, S, H] (positions
    0..S-1, token type 0)."""
    S = ids.shape[1]
    e = prefix + "embeddings."
    h = (W[e + "word_embeddings.weight"][ids.long()]
         + W[e + "position_embeddings.weight"][:S][None]
         + W[e + "token_type_embeddings.weight"][0])
    h = layer_norm(h, W[e + "LayerNorm.weight"], W[e + "LayerNorm.bias"],
                   cfg["layer_norm_eps"])
    return rounded(dropped(h, keep, cfg["hidden_dropout_prob"]), rnd)


def layer(W: Dict[str, torch.Tensor], prefix: str, cfg: dict, h, key_mask,
          keeps=None, rnd: Round = None):
    """One layer: h [B, S, H], key_mask [B, S] (True: a real token) ->
    [B, S, H]. keeps: (attention probabilities [B, N, S, S], attention
    output [B, S, H], FFN output [B, S, H]) masks, or None."""
    B, S, H = h.shape
    N = cfg["num_attention_heads"]
    D = H // N
    a = prefix + "attention."
    q, k, v = (linear(h, W[f"{a}self.{m}.weight"], W[f"{a}self.{m}.bias"],
                      rnd).view(B, S, N, D)
               for m in ("query", "key", "value"))
    scores = torch.einsum("bqnd,bknd->bnqk", q, k) / math.sqrt(D)
    scores = scores.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    k_attn, k_out, k_ffn = keeps if keeps is not None else (None,) * 3
    p_attn = cfg["attention_probs_dropout_prob"]
    p = cfg["hidden_dropout_prob"]
    probs = rounded(dropped(probs, k_attn, p_attn), rnd)
    ctx = rounded(torch.einsum("bnqk,bknd->bqnd", probs, v), rnd)
    out = linear(ctx.reshape(B, S, H), W[a + "output.dense.weight"],
                 W[a + "output.dense.bias"], rnd)
    x = rounded(layer_norm(h + dropped(out, k_out, p),
                           W[a + "output.LayerNorm.weight"],
                           W[a + "output.LayerNorm.bias"],
                           cfg["layer_norm_eps"]), rnd)
    u = rounded(F.gelu(linear(x, W[prefix + "intermediate.dense.weight"],
                              W[prefix + "intermediate.dense.bias"], rnd)),
                rnd)
    y = linear(u, W[prefix + "output.dense.weight"],
               W[prefix + "output.dense.bias"], rnd)
    return rounded(layer_norm(x + dropped(y, k_ffn, p),
                              W[prefix + "output.LayerNorm.weight"],
                              W[prefix + "output.LayerNorm.bias"],
                              cfg["layer_norm_eps"]), rnd)


@torch.no_grad()
def cls_embeddings(W: Dict[str, torch.Tensor], cfg: dict, ids, key_mask,
                   prefix: str = "", rnd: Round = None, block: int = 64):
    """The last layer's CLS vector of each record (COCO-DR's
    rdot_nll_condenser tower), float32, in blocks of `block` records ->
    [B, H]."""
    out = []
    with float32_products():
        for s in range(0, ids.shape[0], block):
            i, m = ids[s:s + block], key_mask[s:s + block]
            h = embed(W, prefix, cfg, i, rnd=rnd)
            for n in range(cfg["num_hidden_layers"]):
                h = layer(W, f"{prefix}encoder.layer.{n}.", cfg, h, m,
                          rnd=rnd)
            out.append(h[:, 0])
    return torch.cat(out)
