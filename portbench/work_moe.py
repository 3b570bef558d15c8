"""The work of a DeepSeek-V2 tower and of the port's expert kernel, counted
from the functions they compute and their shapes, never from one
implementation (as portbench/roofline.py counts the BERT kernels').

Operations are 2 a multiply-add. A record's useful work is its own real
tokens': padding and the tokens a batch repeats are not useful work.
"""
from __future__ import annotations

import numpy as np


def tower_forward_flops(cfg: dict, L) -> np.ndarray:
    """One record of L real tokens (an int or an array of them) through the
    tower, without an LM head: per token and layer the projections of
    latent attention (q, kv_a, kv_b, o), per layer the causal scores and
    PV products over the L (L + 1) / 2 query-key pairs, and per token the
    FFN: the dense SwiGLU in the first first_k_dense_replace layers, the
    router, k routed experts and the shared experts in the others."""
    L = np.asarray(L, np.int64)
    H, N = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r, E, k = (cfg["kv_lora_rank"], cfg["n_routed_experts"],
               cfg["num_experts_per_tok"])
    Fe = cfg["moe_intermediate_size"]
    proj = 2 * (H * N * (dn + dr) + H * (r + dr) + r * N * (dn + dv)
                + N * dv * H)
    pairs = L * (L + 1) // 2
    attn = 2 * N * (dn + dr + dv) * pairs
    dense = cfg["first_k_dense_replace"]
    moe_layers = cfg["num_hidden_layers"] - dense
    ffn_dense = 6 * H * cfg["intermediate_size"]
    ffn_moe = (2 * H * E + 6 * H * Fe * k
               + 6 * H * Fe * cfg["n_shared_experts"])
    per_token = (cfg["num_hidden_layers"] * proj + dense * ffn_dense
                 + moe_layers * ffn_moe)
    return L * per_token + cfg["num_hidden_layers"] * attn


def expert_work(rows: float, E: int, H: int, F: int):
    """The expert kernel (ops/moe.py::expert_ffn, both products) over `rows`
    routed rows -> (operations, bytes): 6 rows H F; the rows in and out
    (bf16) and each expert's three matrices read once (bf16)."""
    ops = 6.0 * rows * H * F
    nbytes = 2.0 * rows * H * 2 + 3.0 * E * F * H * 2
    return ops, nbytes
