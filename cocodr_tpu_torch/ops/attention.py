"""K8: fused attention on the sequence-major layout [B, S, N, D].

Counterpart of cocodr_tpu/ops/pallas_attention.py (`fused_attention_seq_major`
and its kernel `_attn_kernel`); the CUDA kernel is `csrc/attention.cu`,
`attention_reference` its plain PyTorch version. Both keep the TPU
kernel's rounding points, which differ from the einsum path of
models/bert.py: the softmax is normalised in float32 BEFORE the PV product
(probabilities rounded to the compute dtype), where the einsum path
multiplies the unnormalised exponentials by V and divides afterwards.

models/bert.py takes this path when `BertConfig.attention_impl == "fused"`
and S % 8 == 0, as the JAX package does. Inference only: the JAX
package's backward recomputes through XLA, and the port's comes with
training.
"""
from __future__ import annotations

import torch

from cocodr_tpu_torch.ops import _build

HEAD_DIM = 64  # bert-base and bert-large
MAX_SEQ = 512  # max_position_embeddings


def attention_reference(q, k, v, bias, scale: float):
    """Plain version of K8. q, k, v [B, S, N, D] in the compute dtype;
    bias [B, S] float32, added to every query row of batch element b.
    Scores are float32 sums of the compute-dtype products."""
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    s = scores * scale + bias.float()[:, None, None, :]
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    probs = (e / e.sum(-1, keepdim=True)).to(q.dtype)
    ctx = torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float())
    return ctx.to(q.dtype)


def fused_attention_seq_major(q, k, v, bias, scale: float):
    """K8 wrapper: q, k, v [B, S, N, D], bias [B, S] -> [B, S, N, D]. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (bf16
    q, k, v; float32 bias; D = 64, S % 8 == 0, S <= 512) or raises."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "fused_attention_seq_major has no backward kernel yet; call it "
            "under torch.no_grad() or torch.inference_mode()"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require_cuda_operand(name, t, (torch.bfloat16,), 4)
    _build.require_cuda_operand("bias", bias, (torch.float32,), 2)
    B, S, N, D = q.shape
    if k.shape != q.shape or v.shape != q.shape or bias.shape != (B, S):
        raise ValueError(
            f"q, k, v must share [B, S, N, D] and bias be [B, S]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
            f"{tuple(bias.shape)}"
        )
    if D != HEAD_DIM or S % 8 or S > MAX_SEQ or B > 65535:
        raise ValueError(
            f"the kernel takes D == {HEAD_DIM}, S % 8 == 0, S <= {MAX_SEQ} "
            f"and B <= 65535; got B={B}, S={S}, D={D}"
        )
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    p = _build.ptr
    err = _build.library().lib.cocodr_attention_bf16(
        p(q), p(k), p(v), p(bias), p(out), B, S, N, D, float(scale),
        _build.stream_of(q),
    )
    _build.check(err, "attention kernel")
    fused_attention_seq_major.launches += 1
    return out


fused_attention_seq_major.launches = 0
