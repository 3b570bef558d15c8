"""DeepSeek-V2 as a retrieval tower: a decoder LM's hidden states pooled at
the last real token (RepLLaMA, arXiv:2310.08319; E5-Mistral,
arXiv:2401.00368), with no LM head. It follows the checkpoint's own
modeling_deepseek.py (deepseek-ai/DeepSeek-V2-Lite) and keeps HuggingFace's
parameter names, except that a MoE layer holds its routed experts stacked,
`mlp.experts.{gate,up,down}_proj` [E, F, H] / [E, H, F], where the
checkpoint has `mlp.experts.E.{gate,up,down}_proj.weight`
(`state_dict_from_hf` stacks them).

Per layer, h the residual stream [B, S, H]:
  a = RMSNorm(h)                            (float32 statistics, eps 1e-6)
  q = a W_q -> 16 heads of q_nope (128) | q_pe (64)     (q_lora_rank null)
  [c_kv (512) | k_pe (64)] = a W_kv_a                   (k_pe: one vector
                                                         shared by the heads)
  [k_nope (128) | v (128)] a head = RMSNorm(c_kv) W_kv_b
  q_pe, k_pe rotated on adjacent pairs (x_2i, x_2i+1) at positions 0..S-1,
  with YaRN's frequencies (`rope_inv_freq`)
  scores = (q_nope . k_nope + q_pe . k_pe) s,  s = qk_head_dim^-1/2 m^2,
  m = 0.1 mscale_all_dim ln(factor) + 1 (1.26080 for V2-Lite: s = 0.114721),
  causal; softmax in float32; h += (P v) W_o
  b = RMSNorm(h)
  layer < first_k_dense_replace: h += W_down(silu(b W_gate) * b W_up)
  else: p = softmax(b W_router) over the routed experts in float32, the
  top k by p taken greedily, weighted by p itself (not renormalised,
  routed_scaling_factor 1): h += sum_k p_k Expert_k(b) + Shared(b), each
  expert a SwiGLU of moe_intermediate_size, Shared one SwiGLU of
  n_shared_experts x that (the checkpoint's layout).
The embedding is RMSNorm(h) of the last layer at the last real token.

The checkpoint's modeling_deepseek.py multiplies s by m^2 (its
`softmax_scale`), as transformers' DeepseekV3Attention does; transformers
4.57's DeepseekV2Attention leaves m^2 out. This tower follows the
checkpoint. The two agree where rope_scaling is None (m = 1).

Routing and the routed experts run in ops/moe.py (its kernel on the card,
a plain loop on the CPU); attention goes through
torch.nn.functional.scaled_dot_product_attention (causal, scale s), v at
its own head dim on every device (SDPA's choice on an H100 takes q/k 192
with v 128 as they are). Padding is on the right, so a real token never
attends to a pad;
padded tokens are routed to no expert (ops/moe.py). The tower is an
inference tower: its parameters are created in the compute dtype without
requires_grad (a float32 master of the 16B model would not fit on a card),
and no dropout is modelled.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from cocodr_tpu_torch.ops import moe
from cocodr_tpu_torch.utils.logging import span

MODEL_TYPE = "deepseek_v2"


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """The checkpoint's yarn_get_mscale."""
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # rope_scaling: None, or {"type": "yarn", "factor", "mscale",
    # "mscale_all_dim", "original_max_position_embeddings", "beta_fast",
    # "beta_slow"} as the checkpoint's config.json has it (a tuple of
    # items here, so that the config stays hashable)
    rope_scaling: Optional[tuple] = (
        ("beta_fast", 32), ("beta_slow", 1), ("factor", 40),
        ("mscale", 0.707), ("mscale_all_dim", 0.707),
        ("original_max_position_embeddings", 4096), ("type", "yarn"))
    max_position_embeddings: int = 163840
    routed_scaling_factor: float = 1.0
    initializer_range: float = 0.02
    pad_token_id: int = 0
    # the checkpoint's settings this tower computes; others raise
    q_lora_rank: Optional[int] = None
    topk_method: str = "greedy"
    scoring_func: str = "softmax"
    n_group: int = 1
    norm_topk_prob: bool = False
    moe_layer_freq: int = 1
    hidden_act: str = "silu"
    dtype: torch.dtype = torch.float32  # compute dtype
    model_type: str = MODEL_TYPE

    def __post_init__(self):
        bad = []
        if self.q_lora_rank is not None:
            bad.append(f"q_lora_rank={self.q_lora_rank!r} (only null)")
        if self.topk_method != "greedy":
            bad.append(f"topk_method={self.topk_method!r} (only 'greedy')")
        if self.scoring_func != "softmax":
            bad.append(f"scoring_func={self.scoring_func!r} "
                       "(only 'softmax')")
        if self.n_group != 1:
            bad.append(f"n_group={self.n_group!r} (only 1)")
        if self.first_k_dense_replace < 0:
            bad.append(f"first_k_dense_replace={self.first_k_dense_replace}")
        if self.norm_topk_prob:
            bad.append("norm_topk_prob=True (only False)")
        if self.moe_layer_freq != 1:
            bad.append(f"moe_layer_freq={self.moe_layer_freq} (only 1)")
        if self.hidden_act != "silu":
            bad.append(f"hidden_act={self.hidden_act!r} (only 'silu')")
        if bad:
            raise ValueError("DeepseekV2Config takes the checkpoint's "
                             "settings only: " + "; ".join(bad))

    @property
    def rope(self) -> Optional[dict]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        """s = qk_head_dim^-1/2, times m^2 under YaRN with mscale_all_dim
        (the checkpoint's softmax_scale)."""
        s = self.qk_head_dim ** -0.5
        rope = self.rope
        if rope is not None and rope.get("mscale_all_dim"):
            m = yarn_mscale(rope["factor"], rope["mscale_all_dim"])
            s = s * m * m
        return s

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace

    @classmethod
    def tiny(cls, **kw) -> "DeepseekV2Config":
        """For tests: hidden 64, 3 layers (1 dense + 2 MoE), 8 experts,
        top 2, 1 shared, kv rank 16, rope dim 8, YaRN on."""
        base = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
                    moe_intermediate_size=32, num_hidden_layers=3,
                    num_attention_heads=4, n_routed_experts=8,
                    n_shared_experts=1, num_experts_per_tok=2,
                    kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
                    v_head_dim=16, rope_scaling=(
                        ("beta_fast", 32), ("beta_slow", 1), ("factor", 40),
                        ("mscale", 0.707), ("mscale_all_dim", 0.707),
                        ("original_max_position_embeddings", 64),
                        ("type", "yarn")),
                    max_position_embeddings=2560)
        return cls(**{**base, **kw})


def config_from_hf(g) -> DeepseekV2Config:
    """A config.json's values (g(key, default)) -> DeepseekV2Config
    (float32 compute; set dtype with dataclasses.replace)."""
    rope = g("rope_scaling")
    fields = {f.name for f in dataclasses.fields(DeepseekV2Config)}
    kw = {}
    for name in fields - {"dtype", "model_type", "rope_scaling"}:
        v = g(name)
        if v is not None or name == "q_lora_rank":
            kw[name] = v
    return DeepseekV2Config(
        rope_scaling=tuple(sorted(rope.items())) if rope else None, **kw)


def rope_inv_freq(cfg: DeepseekV2Config) -> tuple:
    """-> (inverse frequencies [qk_rope_head_dim / 2] float32, the cos/sin
    factor), as transformers' _compute_yarn_parameters computes them for
    'yarn' (truncated correction range) and the default rotary otherwise."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    pos_freqs = base ** (torch.arange(0, dim, 2).to(dtype=torch.float) / dim)
    rope = cfg.rope
    if rope is None:
        return 1.0 / pos_freqs, 1.0
    kind = rope.get("rope_type", rope.get("type"))
    if kind != "yarn":
        raise ValueError(f"rope_scaling type {kind!r} (only 'yarn')")
    factor = rope["factor"]
    mscale, mscale_all = rope.get("mscale"), rope.get("mscale_all_dim")
    attention_factor = rope.get("attention_factor")
    if attention_factor is None:
        attention_factor = (yarn_mscale(factor, mscale)
                            / yarn_mscale(factor, mscale_all)
                            if mscale and mscale_all else yarn_mscale(factor))
    beta_fast = rope.get("beta_fast") or 32
    beta_slow = rope.get("beta_slow") or 1
    original = (rope.get("original_max_position_embeddings")
                or cfg.max_position_embeddings)

    def correction_dim(rotations):
        return (dim * math.log(original / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low, high = correction_dim(beta_fast), correction_dim(beta_slow)
    if rope.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    extrapolation = 1 - ramp
    inv_freq = ((1.0 / (factor * pos_freqs)) * (1 - extrapolation)
                + (1.0 / pos_freqs) * extrapolation)
    return inv_freq, float(attention_factor)


def rotate_pairs(x, cos, sin):
    """x [..., S, n, D] (or [..., S, D]) rotated on adjacent pairs
    (x_2i, x_2i+1) by cos, sin [S, D / 2], in float32, back in x's dtype."""
    xf = x.float().unflatten(-1, (-1, 2))
    x0, x1 = xf[..., 0], xf[..., 1]
    if x.dim() == 4:  # [B, S, n, D]: broadcast over the heads
        cos, sin = cos[:, None], sin[:, None]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], -1)
    return out.flatten(-2).to(x.dtype)


class RMSNorm(nn.Module):
    """weight * bf16(x * rsqrt(mean(x^2) + eps)), statistics in float32
    (the checkpoint's DeepseekV2RMSNorm)."""

    def __init__(self, dim: int, eps: float, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return self.weight * xf.to(x.dtype)


def _linear(n_in: int, n_out: int, dtype) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False, dtype=dtype)


class Attention(nn.Module):
    """Multi-head latent attention in its prefill form."""

    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        H, N, dt = cfg.hidden_size, cfg.num_attention_heads, cfg.dtype
        self.cfg = cfg
        self.q_proj = _linear(H, N * cfg.qk_head_dim, dt)
        self.kv_a_proj_with_mqa = _linear(
            H, cfg.kv_lora_rank + cfg.qk_rope_head_dim, dt)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps, dt)
        self.kv_b_proj = _linear(
            cfg.kv_lora_rank, N * (cfg.qk_nope_head_dim + cfg.v_head_dim), dt)
        self.o_proj = _linear(N * cfg.v_head_dim, H, dt)

    def forward(self, a, cos, sin):
        cfg = self.cfg
        B, S, _ = a.shape
        N, dn, dr = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim)
        q = self.q_proj(a).view(B, S, N, dn + dr)
        q_nope, q_pe = q.split([dn, dr], -1)
        c_kv, k_pe = self.kv_a_proj_with_mqa(a).split(
            [cfg.kv_lora_rank, dr], -1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c_kv)).view(
            B, S, N, dn + cfg.v_head_dim)
        k_nope, v = kv.split([dn, cfg.v_head_dim], -1)
        q_pe = rotate_pairs(q_pe, cos, sin)
        k_pe = rotate_pairs(k_pe, cos, sin)
        query = torch.cat([q_nope, q_pe], -1).transpose(1, 2)
        key = torch.cat([k_nope, k_pe[:, :, None].expand(B, S, N, dr)],
                        -1).transpose(1, 2)
        value = v.transpose(1, 2)
        o = F.scaled_dot_product_attention(query, key, value, is_causal=True,
                                           scale=cfg.softmax_scale)
        o = o.transpose(1, 2).reshape(B, S, -1)
        return self.o_proj(o)


class MLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, H: int, F_: int, dtype):
        super().__init__()
        self.gate_proj = _linear(H, F_, dtype)
        self.up_proj = _linear(H, F_, dtype)
        self.down_proj = _linear(F_, H, dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class MoEGate(nn.Module):
    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            cfg.n_routed_experts, cfg.hidden_size, dtype=cfg.dtype))


class Experts(nn.Module):
    """The routed experts of one layer, stacked: gate_proj and up_proj
    [E, F, H], down_proj [E, H, F] (nn.Linear's layout a slice)."""

    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        E, H, F_ = (cfg.n_routed_experts, cfg.hidden_size,
                    cfg.moe_intermediate_size)
        self.gate_proj = nn.Parameter(torch.empty(E, F_, H, dtype=cfg.dtype))
        self.up_proj = nn.Parameter(torch.empty(E, F_, H, dtype=cfg.dtype))
        self.down_proj = nn.Parameter(torch.empty(E, H, F_, dtype=cfg.dtype))


class MoE(nn.Module):
    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.cfg = cfg
        self.gate = MoEGate(cfg)
        self.experts = Experts(cfg)
        self.shared_experts = MLP(
            cfg.hidden_size, cfg.moe_intermediate_size * cfg.n_shared_experts,
            cfg.dtype)

    def forward(self, b, real, rows=None):
        """b [B, S, H] (the normalised stream), real [B, S] bool (False: a
        pad, routed to no expert) -> y [B, S, H]; rows: the [E] int64
        counter the routed rows of each expert are added to, on the card."""
        B, S, H = b.shape
        k = self.cfg.num_experts_per_tok
        x = b.reshape(B * S, H)
        r = moe.route(x, self.gate.weight, k, real.reshape(-1))
        if rows is not None:
            rows += r.offsets.diff()
        e = self.experts
        with span("cocodr.moe.experts"):
            routed = moe.expert_ffn(r.rows, e.gate_proj, e.up_proj,
                                    e.down_proj, r.offsets, r.weights,
                                    r.order)
            shared = self.shared_experts(x)
        y = moe.combine(routed, shared, real.reshape(-1), k)
        return y.view(B, S, H)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, index: int):
        super().__init__()
        self.index = index
        self.self_attn = Attention(cfg)
        self.mlp = (MoE(cfg) if cfg.is_moe(index) else
                    MLP(cfg.hidden_size, cfg.intermediate_size, cfg.dtype))
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       cfg.dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, cfg.dtype)

    def forward(self, h, real, cos, sin, rows=None):
        h = h + self.self_attn(self.input_layernorm(h), cos, sin)
        b = self.post_attention_layernorm(h)
        if isinstance(self.mlp, MoE):
            return h + self.mlp(b, real, rows)
        return h + self.mlp(b)


class DeepseekV2Model(nn.Module):
    """The tower: token ids [B, S] and the attention mask [B, S] (1: a real
    token, padding on the right) -> the final RMSNorm's output [B, S, H].

    `expert_rows`: an int64 [num_hidden_layers, n_routed_experts] counter on
    the card of the rows routed to each expert (real tokens only), made at
    the first forward and accumulated by every forward; read it once, at
    the end of a window (reading it waits for the card). It and the rotary
    tables are made outside inference mode, so that a forward under
    `torch.inference_mode` and a later one under `torch.no_grad` share
    them."""

    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         dtype=cfg.dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype)
        self.requires_grad_(False)
        self.expert_rows: Optional[torch.Tensor] = None
        self._rope: dict = {}

    def rotary(self, S: int, device):
        """cos, sin [S, qk_rope_head_dim / 2] float32 on `device`, made once
        a (device, S): a forward then copies nothing from the host."""
        key = (str(device), S)
        if key not in self._rope:
            inv_freq, factor = rope_inv_freq(self.cfg)
            with torch.inference_mode(False):
                pos = torch.arange(S, dtype=torch.float32, device=device)
                freqs = pos[:, None] * inv_freq.to(device)[None]
                self._rope[key] = (freqs.cos() * factor,
                                   freqs.sin() * factor)
        return self._rope[key]

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                generator=None):
        B, S = input_ids.shape
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones(B, S, dtype=torch.int32, device=dev)
        real = attention_mask.bool()
        if self.expert_rows is None or self.expert_rows.device != dev:
            with torch.inference_mode(False):
                self.expert_rows = torch.zeros(
                    self.cfg.num_hidden_layers, self.cfg.n_routed_experts,
                    dtype=torch.int64, device=dev)
        cos, sin = self.rotary(S, dev)
        h = self.embed_tokens(input_ids.long())
        for i, layer in enumerate(self.layers):
            h = layer(h, real, cos, sin, self.expert_rows[i])
        return self.norm(h)


def last_token(hidden, mask):
    """hidden [B, S, H] at each row's last real token (padding on the
    right) -> [B, H]; found on the card, with no host read."""
    last = mask.long().sum(1).sub(1).clamp_min(0)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), last]


def init_weights(module: nn.Module, std: float, generator: torch.Generator):
    """A fresh draw: every matrix (linears, embedding, router, experts)
    normal(0, std), RMSNorm scales one."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding, MoEGate)):
                m.weight.normal_(0.0, std, generator=generator)
            elif isinstance(m, Experts):
                for p in m.parameters():
                    p.normal_(0.0, std, generator=generator)
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)


def stack(tensors):
    """torch.stack, without a copy where the tensors already lie end to end
    in one storage, equally shaped and contiguous (the benchmark's weights
    are drawn so): then a view of them."""
    t0 = tensors[0]
    n = t0.numel()
    same = all(
        t.shape == t0.shape and t.dtype == t0.dtype and t.is_contiguous()
        and t.untyped_storage().data_ptr() == t0.untyped_storage().data_ptr()
        and t.storage_offset() == t0.storage_offset() + i * n
        for i, t in enumerate(tensors))
    if not same:
        return torch.stack(tensors)
    return t0.as_strided((len(tensors), *t0.shape),
                         (n, *t0.stride()), t0.storage_offset())


def state_dict_from_hf(sd: Mapping, cfg: DeepseekV2Config,
                       prefix: str = "encoder.") -> dict:
    """A HuggingFace DeepseekV2Model or ...ForCausalLM state dict -> the
    tower's names under `prefix`: `model.` dropped, the LM head left out,
    each MoE layer's experts stacked (`stack`)."""
    out, experts = {}, {}
    for k, v in sd.items():
        if k.startswith("model."):
            k = k[len("model."):]
        if k.startswith("lm_head."):
            continue
        parts = k.split(".")
        if len(parts) == 7 and parts[2:4] == ["mlp", "experts"]:
            layer, e, kind = int(parts[1]), int(parts[4]), parts[5]
            experts.setdefault((layer, kind), {})[e] = v
            continue
        out[prefix + k] = v
    for (layer, kind), by_e in experts.items():
        if sorted(by_e) != list(range(cfg.n_routed_experts)):
            raise ValueError(f"layer {layer} {kind}: experts "
                             f"{sorted(by_e)} of {cfg.n_routed_experts}")
        out[f"{prefix}layers.{layer}.mlp.experts.{kind}"] = stack(
            [by_e[e] for e in range(cfg.n_routed_experts)])
    return out
