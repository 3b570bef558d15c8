"""Routing and the routed experts of a DeepSeek-V2 MoE layer.

No TPU kernel is replaced: the JAX package has no MoE tower. This module
is the port's own, added with models/deepseek_v2.py.

`route`: the router's float32 logits, softmax, the greedy top k, and the
permutation of the (token, slot) rows into expert order with each expert's
first row, all as tensor operations on the input's device: no `.item()`,
`.tolist()`, `nonzero` or `bincount` (whose size needs a host read), so a
layer issues its work without waiting for the card. A padded token is
routed to the sentinel expert E, sorted after every real row and computed
by no expert.

`expert_ffn`: every routed row through its expert's SwiGLU, weighted by
its routing probability,
    h   = bf16(silu(x W_gate^T) * (x W_up^T))   (float32 sums and SiLU)
    out[dst] = p * (h W_down^T)                  (float32)
On the card it is two launches of csrc/moe_experts.cu (grouped products
on csrc/gemm_wgmma.cuh; `.launches` counts them), on the CPU the plain
loop `expert_ffn_reference`, which launches nothing. The two products of
a layer's experts are bound by the tensor cores: 6 R H F operations for
R routed rows against the rows in and out and 3 E F H weights read once
(R = 221,184 rows of H 2,048, F 1,408 at 128 records of 288 tokens: 3.8
TFLOP against 2.9 GB, ~1,300 operations a byte).

`combine`: the k float32 rows of each token summed in float32 with the
shared experts' output, rounded to the compute dtype once.

Spans (utils/logging.py): `cocodr.moe.route` (route), `cocodr.moe.combine`
(combine); the caller wraps the expert products in `cocodr.moe.experts`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from cocodr_tpu_torch.ops import _build
from cocodr_tpu_torch.utils.logging import span

COL_TILE = 128  # of F a gate-up block computes (gate and up: 256 columns)
OUT_TILE = 256  # of H a down block computes


class Routing(NamedTuple):
    """One layer's routing of T tokens to k of E experts, R = T k rows.
    rows [R, H]: the tokens' inputs in expert order; order [R] int64: the
    (token, slot) row t k + j of each; weights [R] float32: its routing
    probability; offsets [E + 1] int32: expert e's first row (offsets[E]:
    the rows of real tokens); topk [T, k] int64: each token's experts (E
    for a pad)."""
    rows: torch.Tensor
    order: torch.Tensor
    weights: torch.Tensor
    offsets: torch.Tensor
    topk: torch.Tensor


def route(x, gate_weight, k: int, real: Optional[torch.Tensor] = None
          ) -> Routing:
    """x [T, H], gate_weight [E, H], real [T] bool (None: every token) ->
    Routing: p = softmax(float32 x W^T), the k largest taken greedily with
    their probabilities (not renormalised). Span `cocodr.moe.route`."""
    with span("cocodr.moe.route"):
        E = gate_weight.shape[0]
        probs = F.linear(x.float(), gate_weight.float()).softmax(-1)
        weights, topk = probs.topk(k, dim=-1)
        if real is not None:
            topk = topk.masked_fill(~real[:, None], E)
        experts, order = topk.reshape(-1).sort(stable=True)
        offsets = torch.searchsorted(
            experts, torch.arange(E + 1, device=x.device)).to(torch.int32)
        return Routing(x[order // k], order, weights.reshape(-1)[order],
                       offsets, topk)


def expert_ffn_reference(rows, w_gate, w_up, w_down, offsets, weights, dst):
    """Plain version of the kernel: rows [R, H] in expert order, w_gate and
    w_up [E, F, H], w_down [E, H, F], offsets [E + 1], weights [R] float32,
    dst [R] -> out [R, H] float32, out[dst[r]] = weights[r] * expert(rows[r])
    for the rows of real experts (r < offsets[E]), other rows 0."""
    out = torch.zeros(rows.shape, dtype=torch.float32, device=rows.device)
    bounds = offsets.tolist()
    for e in range(w_gate.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi == lo:
            continue
        x = rows[lo:hi].float()
        h = (F.silu(x @ w_gate[e].float().T)
             * (x @ w_up[e].float().T)).to(rows.dtype)
        out[dst[lo:hi]] = weights[lo:hi, None] * (h.float()
                                                  @ w_down[e].float().T)
    return out


def expert_ffn(rows, w_gate, w_up, w_down, offsets, weights, dst):
    """The routed experts (see expert_ffn_reference) -> out [R, H] float32.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel's two products (bf16 operands, H % 256 == 0, F % 128 == 0) or
    raises. On the card the rows of pads (r >= offsets[E]) are not written:
    `combine` leaves them out."""
    if rows.device.type == "cpu":
        return expert_ffn_reference(rows, w_gate, w_up, w_down, offsets,
                                    weights, dst)
    for name, t, nd in (("rows", rows, 2), ("w_gate", w_gate, 3),
                        ("w_up", w_up, 3), ("w_down", w_down, 3)):
        _build.require_cuda_operand(name, t, (torch.bfloat16,), nd)
    _build.require_cuda_operand("offsets", offsets, (torch.int32,), 1)
    _build.require_cuda_operand("weights", weights, (torch.float32,), 1)
    _build.require_cuda_operand("dst", dst, (torch.int64,), 1)
    R, H = rows.shape
    E, F_, _ = w_gate.shape
    if (w_gate.shape != (E, F_, H) or w_up.shape != w_gate.shape
            or w_down.shape != (E, H, F_) or offsets.shape != (E + 1,)
            or weights.shape != (R,) or dst.shape != (R,)
            or H % OUT_TILE or F_ % COL_TILE):
        raise ValueError(
            f"expert_ffn: rows {tuple(rows.shape)}, w_gate "
            f"{tuple(w_gate.shape)}, w_up {tuple(w_up.shape)}, w_down "
            f"{tuple(w_down.shape)}, offsets {tuple(offsets.shape)}, weights "
            f"{tuple(weights.shape)}, dst {tuple(dst.shape)}; H % "
            f"{OUT_TILE} and F % {COL_TILE} must be 0")
    h = torch.empty(R, F_, dtype=rows.dtype, device=rows.device)
    out = torch.empty(R, H, dtype=torch.float32, device=rows.device)
    if R == 0:
        return out
    p, lib, s = _build.ptr, _build.library().lib, _build.stream_of(rows)
    _build.check(lib.cocodr_moe_gate_up_bf16(
        p(rows), p(w_gate), p(w_up), p(offsets), p(h), R, E, H, F_, s),
        "moe gate-up kernel")
    _build.check(lib.cocodr_moe_down_bf16(
        p(h), p(w_down), p(offsets), p(weights), p(dst), p(out), R, E, H, F_,
        s), "moe down kernel")
    expert_ffn.launches += 2
    return out


expert_ffn.launches = 0


def combine(routed, shared, real, k: int):
    """routed [T k, H] float32 (expert_ffn's rows, at t k + j), shared [T, H]
    in the compute dtype, real [T] bool -> y [T, H] = the k rows of each
    token summed in float32, plus shared, rounded once (a pad takes the
    shared experts alone). Span `cocodr.moe.combine`."""
    with span("cocodr.moe.combine"):
        T, H = shared.shape
        y = routed.view(T, k, H).sum(1)
        y = torch.where(real[:, None], y, 0.0)
        return (y + shared.float()).to(shared.dtype)
