"""Weights of a DeepSeek-V2 tower drawn on the device from a seed, by
HuggingFace's names (DeepseekV2ForCausalLM's, without the LM head), in
bf16.

The harness makes the weights once and hands the same tensors to the
program (models/hf.py::state_dict_from_hf, which takes each MoE layer's
experts as the stacked tensor they are views of) and to the reference,
which reads them by these names. Every matrix is normal(0, std) and every
RMSNorm scale 1 + normal(0, std), drawn in float32 a chunk at a time and
rounded to bf16 in place: a float32 draw of the 15.5B parameters at once
would not fit on the card. A MoE layer's experts are drawn as three
stacked tensors, gate and up [E, F, H] and down [E, H, F], and named a
slice at a time.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

PREFIX = "model."
CHUNK = 1 << 27  # float32 values drawn at a time (512 MB)

# name, shape, is an RMSNorm scale; an expert group's name holds "{e}"
Layout = List[Tuple[str, Tuple[int, ...], bool]]


def layout(cfg: dict) -> Layout:
    H, N = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r, E = cfg["kv_lora_rank"], cfg["n_routed_experts"]
    Fd, Fe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    Fs = Fe * cfg["n_shared_experts"]
    out: Layout = [(PREFIX + "embed_tokens.weight", (cfg["vocab_size"], H),
                    False)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"{PREFIX}layers.{i}."
        out += [(p + "input_layernorm.weight", (H,), True),
                (p + "self_attn.q_proj.weight", (N * (dn + dr), H), False),
                (p + "self_attn.kv_a_proj_with_mqa.weight", (r + dr, H),
                 False),
                (p + "self_attn.kv_a_layernorm.weight", (r,), True),
                (p + "self_attn.kv_b_proj.weight", (N * (dn + dv), r), False),
                (p + "self_attn.o_proj.weight", (H, N * dv), False),
                (p + "post_attention_layernorm.weight", (H,), True)]
        if i < cfg["first_k_dense_replace"]:
            out += [(p + "mlp.gate_proj.weight", (Fd, H), False),
                    (p + "mlp.up_proj.weight", (Fd, H), False),
                    (p + "mlp.down_proj.weight", (H, Fd), False)]
            continue
        out += [(p + "mlp.gate.weight", (E, H), False),
                (p + "mlp.experts.{e}.gate_proj.weight", (E, Fe, H), False),
                (p + "mlp.experts.{e}.up_proj.weight", (E, Fe, H), False),
                (p + "mlp.experts.{e}.down_proj.weight", (E, H, Fe), False),
                (p + "mlp.shared_experts.gate_proj.weight", (Fs, H), False),
                (p + "mlp.shared_experts.up_proj.weight", (Fs, H), False),
                (p + "mlp.shared_experts.down_proj.weight", (H, Fs), False)]
    out.append((PREFIX + "norm.weight", (H,), True))
    return out


def draw(cfg: dict, generator: torch.Generator, std: float, device,
         dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """-> {HuggingFace name: tensor on device in dtype}; an expert group
    gives one name per expert, views of its stacked tensor in expert
    order."""
    out: Dict[str, torch.Tensor] = {}
    for name, shape, scale in layout(cfg):
        t = torch.empty(shape, dtype=dtype, device=device)
        flat = t.view(-1)
        for s in range(0, flat.numel(), CHUNK):
            part = torch.randn(min(CHUNK, flat.numel() - s),
                               generator=generator, device=device)
            part.mul_(std)
            if scale:
                part.add_(1.0)
            flat[s:s + part.numel()].copy_(part)
            del part
        if "{e}" in name:
            for e in range(shape[0]):
                out[name.format(e=e)] = t[e]
        else:
            out[name] = t
    return out
