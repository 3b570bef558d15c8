"""A plain DeepSeek-V2 tower in float32, from HuggingFace-named weights,
pooled at the last real token: the reference of the
`deepseek-v2-lite.moe_encode` cell. Plain torch, no kernel of the port.

It follows the checkpoint's modeling_deepseek.py (DeepSeek-V2-Lite):
pre-norm layers with RMSNorm (float32 statistics); multi-head latent
attention in its prefill form (q = a W_q without q compression; c_kv and a
64-dim k_pe shared by the heads from a W_kv_a; k_nope and v from
RMSNorm(c_kv) W_kv_b; rotary on adjacent pairs (x_2i, x_2i+1) of q_pe and
k_pe with YaRN's frequencies; scale qk_head_dim^-1/2 times
yarn_mscale(factor, mscale_all_dim)^2; causal softmax); a dense SwiGLU in
the first first_k_dense_replace layers, after them the router's softmax
over the routed experts, the top k taken greedily with their
probabilities (not renormalised) times routed_scaling_factor, each
expert's SwiGLU, plus the shared experts' SwiGLU; the final RMSNorm.

Only real tokens are computed (padding is on the right, so a real token
never attends to a pad): a row's tokens are packed, attention runs row by
row, everything else token by token. Layer by layer, each layer's weights
are widened to float32 when it runs. Every float32 product runs with TF32
off (`float32_products`). `rnd`, for the control that computes the same in
a lower precision (reference/bert.py's `fp8_e4m3`), rounds the operands of
each product, each product's output, the RMSNorm outputs, the attention
probabilities and the residual stream; statistics and sums stay float32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference.bert import float32_products, rounded

Round = Optional[Callable[[torch.Tensor], torch.Tensor]]
PREFIX = "model."


def mscale(scale: float, m: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def inv_freq(cfg: dict) -> tuple:
    """(inverse frequencies [rope dim / 2] float32, cos/sin factor) as
    YaRN defines them (arXiv:2309.00071; the checkpoint's
    yarn_find_correction_range, truncated), or plain rotary."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    freq = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    rope = cfg.get("rope_scaling")
    if not rope:
        return freq, 1.0
    factor = rope["factor"]
    orig = rope["original_max_position_embeddings"]

    def dim_of(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(dim_of(rope.get("beta_fast", 32))), 0)
    high = min(math.ceil(dim_of(rope.get("beta_slow", 1))), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / max(high - low, 0.001)).clamp(0, 1)
    freq = (freq / factor) * ramp + freq * (1 - ramp)
    return freq, (mscale(factor, rope.get("mscale", 1.0))
                  / mscale(factor, rope.get("mscale_all_dim", 1.0)))


def softmax_scale(cfg: dict) -> float:
    s = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rope = cfg.get("rope_scaling")
    if rope and rope.get("mscale_all_dim"):
        s *= mscale(rope["factor"], rope["mscale_all_dim"]) ** 2
    return s


def rotate(x, cos, sin):
    """x [..., S, D] (or [S, n, D] with cos [S, 1, D / 2]) rotated on
    adjacent pairs."""
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                       -1).flatten(-2)


def rms_norm(x, w, eps, rnd: Round = None):
    return rounded(w * (x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                                        + eps)), rnd)


def mm(x, w, rnd: Round = None):
    """x W^T, W in nn.Linear's layout."""
    if rnd is not None:
        x, w = rnd(x), rnd(w)
    return rounded(x @ w.T, rnd)


def swiglu(x, W, p, rnd: Round = None):
    u = rounded(F.silu(mm(x, W[p + "gate_proj.weight"], rnd))
                * mm(x, W[p + "up_proj.weight"], rnd), rnd)
    return mm(u, W[p + "down_proj.weight"], rnd)


def layer_weights(weights: Dict[str, torch.Tensor], i: int):
    p = f"{PREFIX}layers.{i}."
    return {k[len(p):]: v.float() for k, v in weights.items()
            if k.startswith(p)}


def attention(W, cfg, a, lengths, cos, sin, rnd: Round = None):
    """a [N, H] (the packed real tokens of rows of `lengths`) -> [N, H]."""
    N_h = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    q = mm(a, W["self_attn.q_proj.weight"], rnd).view(-1, N_h, dn + dr)
    ckv = mm(a, W["self_attn.kv_a_proj_with_mqa.weight"], rnd)
    c, k_pe = ckv[:, :cfg["kv_lora_rank"]], ckv[:, cfg["kv_lora_rank"]:]
    c = rms_norm(c, W["self_attn.kv_a_layernorm.weight"], cfg["rms_norm_eps"],
                 rnd)
    kv = mm(c, W["self_attn.kv_b_proj.weight"], rnd).view(-1, N_h, dn + dv)
    scale = softmax_scale(cfg)
    out = []
    start = 0
    for L in lengths:
        sl = slice(start, start + L)
        start += L
        q_pe = rotate(q[sl, :, dn:], cos[:L, None], sin[:L, None])
        kp = rotate(k_pe[sl], cos[:L], sin[:L])
        qq = torch.cat([q[sl, :, :dn], q_pe], -1).transpose(0, 1)
        kk = torch.cat([kv[sl, :, :dn], kp[:, None].expand(L, N_h, dr)],
                       -1).transpose(0, 1)
        vv = kv[sl, :, dn:].transpose(0, 1)
        if rnd is not None:
            qq, kk = rnd(qq), rnd(kk)
        s = (qq @ kk.transpose(1, 2)) * scale
        causal = torch.ones(L, L, dtype=torch.bool, device=a.device).tril()
        probs = rounded(s.masked_fill(~causal, float("-inf")).softmax(-1),
                        rnd)
        if rnd is not None:
            vv = rnd(vv)
        out.append(rounded(probs @ vv, rnd).transpose(0, 1).reshape(L, -1))
    return mm(torch.cat(out), W["self_attn.o_proj.weight"], rnd)


def moe(W, cfg, b, rnd: Round = None, choose=None):
    """b [N, H] -> (y [N, H], top-k experts [N, k], router probabilities
    [N, E]). choose(topk, probs) -> topk, when given, picks the experts
    used in place of the reference's own top k (the check's replay)."""
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    probs = (b @ W["mlp.gate.weight"].T).softmax(-1)
    topk = probs.topk(k, dim=-1).indices
    own = topk
    if choose is not None:
        topk = choose(topk, probs)
    weight = probs.gather(1, topk) * cfg["routed_scaling_factor"]
    y = torch.zeros_like(b)
    for e in range(E):
        tok, slot = (topk == e).nonzero(as_tuple=True)
        if len(tok) == 0:
            continue
        out = swiglu(b[tok], W, f"mlp.experts.{e}.", rnd)
        y.index_add_(0, tok, weight[tok, slot, None] * out)
    y = rounded(y, rnd) + swiglu(b, W, "mlp.shared_experts.", rnd)
    return y, own, probs


@torch.no_grad()
def last_token_embeddings(weights: Dict[str, torch.Tensor], cfg: dict, ids,
                          lengths: List[int], rnd: Round = None,
                          choose=None, routes: Optional[list] = None):
    """Each row's final hidden state at its last real token, float32 ->
    [R, H]. ids [R, S] (token ids, real for the first lengths[r]);
    choose(layer, topk, probs) -> topk: moe's replay hook; routes: a list
    that gets, per MoE layer, (layer, own top k [N, k], probabilities
    [N, E]) of the packed tokens."""
    dev = ids.device
    lengths = [int(n) for n in lengths]
    tok = torch.cat([ids[r, :n] for r, n in enumerate(lengths)]).long()
    eps = cfg["rms_norm_eps"]
    freq, factor = inv_freq(cfg)
    ang = (torch.arange(max(lengths), dtype=torch.float32, device=dev)[:, None]
           * freq.to(dev)[None])
    cos, sin = ang.cos() * factor, ang.sin() * factor
    with float32_products():
        h = rounded(weights[PREFIX + "embed_tokens.weight"][tok].float(), rnd)
        for i in range(cfg["num_hidden_layers"]):
            W = layer_weights(weights, i)
            a = rms_norm(h, W["input_layernorm.weight"], eps, rnd)
            h = rounded(h + attention(W, cfg, a, lengths, cos, sin, rnd), rnd)
            b = rms_norm(h, W["post_attention_layernorm.weight"], eps, rnd)
            if i < cfg["first_k_dense_replace"]:
                y = swiglu(b, W, "mlp.", rnd)
            else:
                pick = (None if choose is None
                        else lambda t, p, i=i: choose(i, t, p))
                y, own, probs = moe(W, cfg, b, rnd, pick)
                if routes is not None:
                    routes.append((i, own, probs))
            h = rounded(h + y, rnd)
            del W
        h = rms_norm(h, weights[PREFIX + "norm.weight"].float(), eps, rnd)
    ends = torch.tensor(lengths, device=dev).cumsum(0) - 1
    return h[ends]
