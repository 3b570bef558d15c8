"""K8: fused attention on the sequence-major layout [B, S, N, D].

Counterpart of cocodr_tpu/ops/pallas_attention.py (`fused_attention_seq_major`
and its kernel `_attn_kernel`); the CUDA kernel is `csrc/attention.cu`,
`attention_reference` its plain PyTorch version. Both keep the TPU
kernel's rounding points, which differ from the einsum path of
models/bert.py: the softmax is normalised in float32 BEFORE the PV product
(probabilities rounded to the compute dtype), where the einsum path
multiplies the unnormalised exponentials by V and divides afterwards.

models/bert.py takes this path through `attention` when no attention
dropout runs (eval mode, or attention_probs_dropout_prob == 0) and either
`BertConfig.attention_impl` is "fused" and S % 8 == 0, as the JAX package
does, or it is "auto" (the default), the forward runs under
torch.inference_mode, q is on the card and `kernel_takes(q)`: the towers'
inference forwards on the card (a torch.no_grad forward, such as COCO's
grad-cache pass 1, keeps the einsum chain of its training pass). The
CPU keeps the einsum chain under "auto": K8 exists only on the card, and
`attention_reference` is a plain version with no speed to gain, so the CPU
tests hold the default path to the JAX package's default formulation.
`attention` is a torch.autograd.Function, as the JAX dispatcher is a
jax.custom_vjp: the forward runs K8, the backward recomputes the einsum
formulation `xla_attention_seq` and returns its gradients (no backward
kernel, as in the JAX package); the bias gets a zero gradient.
"""
from __future__ import annotations

import torch

from cocodr_tpu_torch.ops import _build
from cocodr_tpu_torch.ops._recompute import recompute_grads

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


def kernel_takes(q) -> bool:
    """Whether the kernel takes q [B, S, N, D]: bf16, D == 64, S % 8 == 0
    and S <= 512 (the shapes `fused_attention_seq_major` does not refuse)."""
    S, D = q.shape[1], q.shape[-1]
    return (q.dtype == torch.bfloat16 and D == HEAD_DIM and S % 8 == 0
            and S <= MAX_SEQ)


def fused_attention_seq_major(q, k, v, bias, scale: float):
    """K8 wrapper: q, k, v [B, S, N, D], bias [B, S] -> [B, S, N, D]. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (bf16
    q, k, v; float32 bias; D = 64, S % 8 == 0, S <= 512) or raises.
    Forward only: the gradient is `attention`'s."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias, scale)
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
    if not kernel_takes(q):
        raise ValueError(
            f"the kernel takes D == {HEAD_DIM}, S % 8 == 0 and S <= "
            f"{MAX_SEQ}; got S={S}, D={D}"
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


def xla_attention_seq(q, k, v, bias, scale: float):
    """The einsum formulation on [B, S, N, D] tensors (counterpart of
    pallas_attention.py::_xla_attention_seq): float32 scores and softmax,
    probabilities rounded to the compute dtype, a compute-dtype PV
    product."""
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    scores = scores * scale + bias.float()[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs, v)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return fused_attention_seq_major(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = recompute_grads(
            lambda q, k, v: xla_attention_seq(q, k, v, bias, ctx.scale),
            (q, k, v), ctx.needs_input_grad, grad_out)
        dbias = torch.zeros_like(bias) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, dbias, None


def attention(q, k, v, bias, scale: float):
    """The attention models/bert.py calls when it takes K8 (counterpart
    of pallas_attention.py::attention): K8 forward, the gradient of
    `xla_attention_seq`."""
    return _Attention.apply(q, k, v, bias, scale)
