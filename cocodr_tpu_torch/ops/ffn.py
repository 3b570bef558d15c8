"""K1: the fused FFN half-layer LN1 -> dense -> GELU -> dense -> +residual
-> LN2 of a post-LN BERT block.

Counterpart of cocodr_tpu/ops/pallas_ffn.py (`fused_ffn_block` with
f_chunks=1 and its dispatcher `ffn_block`). The CUDA kernel is
`csrc/ffn_block.cu`; `ffn_block_reference` is its plain PyTorch version.
Both reproduce the TPU kernel, not `_xla_ffn_block`: the residual into LN2
is LN1's float32 output u32, added in float32.

Weights are in nn.Linear layout: w1 [F, H], w2 [H, F] (the JAX package
passes the transposes, kernel [H, F] and [F, H]).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cocodr_tpu_torch.ops import _build

ACTIVATIONS = {"gelu": 0, "gelu_new": 1, "relu": 2}


def activation(name: str):
    """The activation of cocodr_tpu/models/bert.py::_act by name."""
    if name == "gelu":
        return F.gelu  # 0.5·x·(1 + erf(x/√2))
    if name == "gelu_new":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation {name}")


def layer_norm_f32(x32, scale, bias, eps):
    """float32 LayerNorm over the last dim with the statistics of
    models/bert.LayerNorm: mean, then mean of squared centred values."""
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def ffn_block_reference(r, ln1_scale, ln1_bias, w1, b1, w2, b2, ln2_scale,
                        ln2_bias, act: str = "gelu", eps: float = 1e-12):
    """Plain version of K1. r [T, H] in the compute dtype; products of
    compute-dtype operands are summed in float32, h is rounded to the
    compute dtype before the second product, as in the kernel."""
    u32 = layer_norm_f32(r.float(), ln1_scale, ln1_bias, eps)
    u = u32.to(r.dtype)
    h = activation(act)(u.float() @ w1.float().t() + b1.float())
    y = h.to(r.dtype).float() @ w2.float().t()
    z32 = u32 + y + b2.float()
    return layer_norm_f32(z32, ln2_scale, ln2_bias, eps).to(r.dtype)


def fused_ffn_block(r, ln1_scale, ln1_bias, w1, b1, w2, b2, ln2_scale,
                    ln2_bias, act: str = "gelu", eps: float = 1e-12):
    """K1 wrapper. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (bf16 r, w1, b1, w2, b2; float32 LayerNorm
    parameters; H and F multiples of 128) or raises. Inference only: the
    kernel has no backward yet."""
    if r.device.type == "cpu":
        return ffn_block_reference(r, ln1_scale, ln1_bias, w1, b1, w2, b2,
                                   ln2_scale, ln2_bias, act, eps)
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act}")
    params = (r, ln1_scale, ln1_bias, w1, b1, w2, b2, ln2_scale, ln2_bias)
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        raise NotImplementedError(
            "fused_ffn_block has no backward kernel yet; call it under "
            "torch.no_grad() or torch.inference_mode()"
        )
    T, H = r.shape
    Fdim = w1.shape[0]
    bf16, f32 = (torch.bfloat16,), (torch.float32,)
    _build.require_cuda_operand("r", r, bf16, 2)
    _build.require_cuda_operand("w1", w1, bf16, 2)
    _build.require_cuda_operand("w2", w2, bf16, 2)
    _build.require_cuda_operand("b1", b1, bf16, 1)
    _build.require_cuda_operand("b2", b2, bf16, 1)
    for name, p in (("ln1_scale", ln1_scale), ("ln1_bias", ln1_bias),
                    ("ln2_scale", ln2_scale), ("ln2_bias", ln2_bias)):
        _build.require_cuda_operand(name, p, f32, 1)
        if p.shape != (H,):
            raise ValueError(f"{name}: expected ({H},), got {tuple(p.shape)}")
    if (w1.shape != (Fdim, H) or w2.shape != (H, Fdim) or b1.shape != (Fdim,)
            or b2.shape != (H,)):
        raise ValueError(
            f"weights must be w1 [F, H], b1 [F], w2 [H, F], b2 [H] with "
            f"H={H}; got {tuple(w1.shape)}, {tuple(b1.shape)}, "
            f"{tuple(w2.shape)}, {tuple(b2.shape)}"
        )
    if H % 128 or Fdim % 128:
        raise ValueError(
            f"the kernel takes H % 128 == 0 and F % 128 == 0; got H={H}, "
            f"F={Fdim}"
        )
    if T > 65535 * 64:
        raise ValueError(f"T={T} exceeds the kernel's grid")
    out = torch.empty_like(r)
    if T == 0:
        return out
    # scratch between the kernel's launches: u = bf16(LN1(r)), LN1's
    # (mean, rstd) per row, h, and the float32 pre-LN2 sum z
    dev = r.device
    u = torch.empty_like(r)
    stats = torch.empty((T, 2), dtype=torch.float32, device=dev)
    h = torch.empty((T, Fdim), dtype=torch.bfloat16, device=dev)
    z = torch.empty((T, H), dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _build.library().lib.cocodr_ffn_block_bf16(
        p(r), p(ln1_scale), p(ln1_bias), p(w1), p(b1), p(w2), p(b2),
        p(ln2_scale), p(ln2_bias), p(u), p(stats), p(h), p(z), p(out),
        T, H, Fdim, ACTIVATIONS[act], eps, _build.stream_of(r),
    )
    _build.check(err, "ffn_block kernel")
    fused_ffn_block.launches += 1
    return out


fused_ffn_block.launches = 0

# The name models/bert.py calls, as in the JAX package. There the
# dispatcher picks between the Pallas kernel and XLA by backend and weight
# size; here the wrapper itself picks by the tensor's device, and one
# kernel covers both bert-base and bert-large widths.
ffn_block = fused_ffn_block
