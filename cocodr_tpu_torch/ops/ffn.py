"""K1, K5 and K7: the FFN of a post-LN BERT block. K1 is the fused
half-layer LN1 -> dense -> GELU -> dense -> +residual -> LN2 in bf16, K7 the
same in W8A8 int8, K5 the bare dense -> act -> dense that a training layer
runs when dropout sits between the FFN output and the residual add.

Counterpart of cocodr_tpu/ops/pallas_ffn.py: `fused_ffn_block` with
f_chunks=1 and its dispatcher `ffn_block` (K1, kernel `csrc/ffn_block.cu`),
`fused_ffn` and its dispatcher `ffn` (K5, in the same source), and
`fused_ffn_block_int8` with its dispatcher `ffn_block_int8` (K7, kernel
`csrc/ffn_block_int8.cu`). `ffn_block_reference`, `ffn_reference` and
`ffn_block_int8_reference` are the kernels' plain PyTorch versions. They
reproduce the TPU kernels, not the XLA fallbacks: K1's residual into LN2
is LN1's float32 output u32, added in float32 as (u32 + y) + b2; K5's
activation is float32 and h is rounded to the compute dtype once.

K1 also computes the F-chunked kernel of the JAX package
(`_ffn_block_chunked_kernel`, K4, which streams bert-large's weights
through VMEM): chunking was a VMEM work-around, and the port's kernel takes
any H and F that are multiples of 128. The chunked kernel sums
(u32 + b2) + sum of the chunks' y in float32, in another order.

`ffn_block` and `ffn` are torch.autograd.Functions, as the JAX dispatchers
are jax.custom_vjps: the forward runs the kernel, the backward recomputes
the XLA formulation (`xla_ffn_block`, `xla_ffn`: bf16 products, a bf16
residual) and returns its gradients. No backward kernel, as in the JAX
package. K7 is inference only (no int8 gradient), as there.

Weights are in nn.Linear layout: w1 [F, H], w2 [H, F] (the JAX package
passes the transposes, kernel [H, F] and [F, H]).

The split forms (tensor parallelism, parallel/tp.py): a model rank holds
F/M rows of w1 and b1 and F/M columns of w2. `ffn_block_tp` and `ffn_tp`
run the rank's part of K1 and K5 (`fused_ffn_block_partial`,
`fused_ffn_partial`: the same up GEMM, a down GEMM that writes a float32
partial [T, H] with no bias and no residual), all-reduce the partials over
the model axis, and finish after the sum (`fused_ffn_block_finish`:
(u32 + y) + b2 then LN2; `fused_ffn_finish`: y + b2, rounded once), so
that b2 and the residual enter once. Their plain versions are
`ffn_block_partial_reference` / `ffn_block_finish_reference` and
`ffn_partial_reference` / `ffn_finish_reference`; at M = 1 they compute
the unsplit plain versions' values. Their backward recomputes the XLA
formulation on the rank's slices (`xla_ffn_block_tp`), with Megatron's f
on the FFN's input: the gradient reaching LN1's output is the residual's,
counted once, plus the sum over the ranks of the FFN's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cocodr_tpu_torch.ops import _build
from cocodr_tpu_torch.ops._recompute import recompute_grads
from cocodr_tpu_torch.ops.int8_matmul import (
    int8_matmul,
    quantize_cols,
    quantize_rows,
)
from cocodr_tpu_torch.parallel.tp import copy_to_model, reduce_from_model

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


def _check_no_grad(name, *params):
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        raise NotImplementedError(
            f"{name} is inference only (no int8 gradient, as in the JAX "
            "package); call it under torch.no_grad() or "
            "torch.inference_mode()"
        )


def _require_layer_norms(H, *params):
    for name, p in zip(("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias"),
                       params):
        _build.require_cuda_operand(name, p, (torch.float32,), 1)
        if p.shape != (H,):
            raise ValueError(f"{name}: expected ({H},), got {tuple(p.shape)}")


def _require_widths(T, H, Fdim):
    if H % 128 or Fdim % 128:
        raise ValueError(
            f"the kernel takes H % 128 == 0 and F % 128 == 0; got H={H}, "
            f"F={Fdim}"
        )
    if T > 65535 * 64:
        raise ValueError(f"T={T} exceeds the kernel's grid")


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


def _require_bf16_weights(x, w1, b1, w2, b2):
    """The bf16 operands of K1 and K5 -> (T, H, F); raises ValueError."""
    T, H = x.shape
    Fdim = w1.shape[0]
    bf16 = (torch.bfloat16,)
    _build.require_cuda_operand("w1", w1, bf16, 2)
    _build.require_cuda_operand("w2", w2, bf16, 2)
    _build.require_cuda_operand("b1", b1, bf16, 1)
    _build.require_cuda_operand("b2", b2, bf16, 1)
    if (w1.shape != (Fdim, H) or w2.shape != (H, Fdim) or b1.shape != (Fdim,)
            or b2.shape != (H,)):
        raise ValueError(
            f"weights must be w1 [F, H], b1 [F], w2 [H, F], b2 [H] with "
            f"H={H}; got {tuple(w1.shape)}, {tuple(b1.shape)}, "
            f"{tuple(w2.shape)}, {tuple(b2.shape)}"
        )
    _require_widths(T, H, Fdim)
    return T, H, Fdim


def fused_ffn_block(r, ln1_scale, ln1_bias, w1, b1, w2, b2, ln2_scale,
                    ln2_bias, act: str = "gelu", eps: float = 1e-12):
    """K1 wrapper. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (bf16 r, w1, b1, w2, b2; float32 LayerNorm
    parameters; H and F multiples of 128) or raises. Forward only: the
    gradient is `ffn_block`'s."""
    if r.device.type == "cpu":
        return ffn_block_reference(r, ln1_scale, ln1_bias, w1, b1, w2, b2,
                                   ln2_scale, ln2_bias, act, eps)
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act}")
    _build.require_cuda_operand("r", r, (torch.bfloat16,), 2)
    T, H, Fdim = _require_bf16_weights(r, w1, b1, w2, b2)
    _require_layer_norms(H, ln1_scale, ln1_bias, ln2_scale, ln2_bias)
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


def xla_ffn(x, w1, b1, w2, b2, act: str = "gelu"):
    """The nn.Dense pair in the compute dtype: the counterpart of
    pallas_ffn.py::_xla_ffn, whose gradients `ffn` and `ffn_block`
    return. Not K5's plain version: its products and activation round to
    the compute dtype."""
    return F.linear(activation(act)(F.linear(x, w1, b1)), w2, b2)


def xla_ffn_block(r, ln1_scale, ln1_bias, w1, b1, w2, b2, ln2_scale,
                  ln2_bias, act: str = "gelu", eps: float = 1e-12):
    """models/bert.py's op sequence for the half-layer: the counterpart of
    pallas_ffn.py::_xla_ffn_block (LayerNorm outputs and the residual add
    in r.dtype, float32 LayerNorm statistics)."""
    u = layer_norm_f32(r.float(), ln1_scale, ln1_bias, eps).to(r.dtype)
    y = xla_ffn(u, w1, b1, w2, b2, act)
    return layer_norm_f32((u + y).float(), ln2_scale, ln2_bias,
                          eps).to(r.dtype)


class _FfnBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, s1, c1, w1, b1, w2, b2, s2, c2, act, eps):
        ctx.save_for_backward(r, s1, c1, w1, b1, w2, b2, s2, c2)
        ctx.act, ctx.eps = act, eps
        return fused_ffn_block(r, s1, c1, w1, b1, w2, b2, s2, c2, act, eps)

    @staticmethod
    def backward(ctx, grad_out):
        grads = recompute_grads(
            lambda *a: xla_ffn_block(*a, ctx.act, ctx.eps), ctx.saved_tensors,
            ctx.needs_input_grad, grad_out)
        return (*grads, None, None)


def ffn_block(r, ln1_scale, ln1_bias, w1, b1, w2, b2, ln2_scale, ln2_bias,
              act: str = "gelu", eps: float = 1e-12):
    """The half-layer models/bert.py calls, as in the JAX package: K1
    forward (`fused_ffn_block`), the gradient of `xla_ffn_block`. The JAX
    dispatcher picks between the Pallas kernel (weights resident or
    streamed in F chunks) and XLA by backend and weight size; here the
    wrapper picks by the tensor's device, and one kernel covers bert-base
    and bert-large widths."""
    return _FfnBlock.apply(r, ln1_scale, ln1_bias, w1, b1, w2, b2,
                           ln2_scale, ln2_bias, act, eps)


# --- K5: the FFN of the dropout path ---------------------------------------

def ffn_reference(x, w1, b1, w2, b2, act: str = "gelu"):
    """Plain version of K5. x [T, H] in the compute dtype; products of
    compute-dtype operands summed in float32, the activation in float32,
    h rounded to the compute dtype before the second product, b2 added in
    float32 and the result rounded once."""
    h = activation(act)(x.float() @ w1.float().t() + b1.float())
    y = h.to(x.dtype).float() @ w2.float().t() + b2.float()
    return y.to(x.dtype)


def fused_ffn(x, w1, b1, w2, b2, act: str = "gelu"):
    """K5 wrapper: x [T, H] -> [T, H]. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (bf16 x, w1 [F, H], b1 [F],
    w2 [H, F], b2 [H]; H and F multiples of 128) or raises. The JAX
    dispatcher sends weights over 12 MB to XLA because the TPU kernel holds
    them in VMEM; this kernel streams them through shared memory and takes
    bert-large's widths too. Forward only: the gradient is `ffn`'s."""
    if x.device.type == "cpu":
        return ffn_reference(x, w1, b1, w2, b2, act)
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act}")
    _build.require_cuda_operand("x", x, (torch.bfloat16,), 2)
    T, H, Fdim = _require_bf16_weights(x, w1, b1, w2, b2)
    out = torch.empty_like(x)
    if T == 0:
        return out
    h = torch.empty((T, Fdim), dtype=torch.bfloat16, device=x.device)
    p = _build.ptr
    err = _build.library().lib.cocodr_ffn_bf16(
        p(x), p(w1), p(b1), p(w2), p(b2), p(h), p(out), T, H, Fdim,
        ACTIVATIONS[act], _build.stream_of(x),
    )
    _build.check(err, "ffn kernel")
    fused_ffn.launches += 1
    return out


fused_ffn.launches = 0


class _Ffn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, act):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.act = act
        return fused_ffn(x, w1, b1, w2, b2, act)

    @staticmethod
    def backward(ctx, grad_out):
        grads = recompute_grads(lambda *a: xla_ffn(*a, ctx.act),
                                ctx.saved_tensors, ctx.needs_input_grad,
                                grad_out)
        return (*grads, None)


def ffn(x, w1, b1, w2, b2, act: str = "gelu"):
    """The FFN models/bert.py calls on its dropout path (counterpart of
    pallas_ffn.py::ffn): K5 forward (`fused_ffn`), the gradient of
    `xla_ffn`."""
    return _Ffn.apply(x, w1, b1, w2, b2, act)


# --- the split forms of K1 (K4) and K5: tensor parallelism ---------------

def ffn_block_partial_reference(r, ln1_scale, ln1_bias, w1, b1, w2,
                                act: str = "gelu", eps: float = 1e-12):
    """Plain version of the split K1's part before the all-reduce: LN1,
    the up GEMM on this rank's w1 [F/M, H], b1, and the down GEMM on its
    w2 [H, F/M] -> (y, stats): the float32 partial y [T, H] (no bias, no
    residual) and LN1's (mean, rstd) per row [T, 2], float32."""
    x = r.float()
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt((x - mean).square().mean(-1, keepdim=True) + eps)
    u32 = (x - mean) * rstd * ln1_scale.float() + ln1_bias.float()
    h = activation(act)(u32.to(r.dtype).float() @ w1.float().t()
                        + b1.float())
    y = h.to(r.dtype).float() @ w2.float().t()
    return y, torch.cat([mean, rstd], -1)


def ffn_block_finish_reference(r, stats, ln1_scale, ln1_bias, y, b2,
                               ln2_scale, ln2_bias, eps: float = 1e-12):
    """Plain version of the split K1's part after the all-reduce: u32
    recomputed from r and the statistics, z32 = (u32 + y) + b2, then LN2,
    rounded to r's dtype."""
    u32 = ((r.float() - stats[:, :1]) * stats[:, 1:] * ln1_scale.float()
           + ln1_bias.float())
    z32 = u32 + y + b2.float()
    return layer_norm_f32(z32, ln2_scale, ln2_bias, eps).to(r.dtype)


def _require_split(name, x, w1, b1, w2):
    """The bf16 operands of a split form's first part -> (T, H, F/M)."""
    bf16 = (torch.bfloat16,)
    _build.require_cuda_operand(name, x, bf16, 2)
    T, H = x.shape
    Fdim = w1.shape[0]
    _build.require_cuda_operand("w1", w1, bf16, 2)
    _build.require_cuda_operand("b1", b1, bf16, 1)
    _build.require_cuda_operand("w2", w2, bf16, 2)
    if w1.shape != (Fdim, H) or w2.shape != (H, Fdim) or b1.shape != (Fdim,):
        raise ValueError(
            f"weights must be w1 [F, H], b1 [F], w2 [H, F] with H={H}; got "
            f"{tuple(w1.shape)}, {tuple(b1.shape)}, {tuple(w2.shape)}")
    _require_widths(T, H, Fdim)
    return T, H, Fdim


def _require_sum(y, b2, T, H):
    _build.require_cuda_operand("y", y, (torch.float32,), 2)
    _build.require_cuda_operand("b2", b2, (torch.bfloat16,), 1)
    if y.shape != (T, H) or b2.shape != (H,):
        raise ValueError(f"y must be [{T}, {H}] and b2 [{H}]; got "
                         f"{tuple(y.shape)}, {tuple(b2.shape)}")
    _require_widths(T, H, 128)


def fused_ffn_block_partial(r, ln1_scale, ln1_bias, w1, b1, w2,
                            act: str = "gelu", eps: float = 1e-12):
    """The split K1's first part: a CPU tensor takes the plain version; a
    CUDA tensor launches LN1, the up GEMM and the partial down GEMM (bf16
    r, w1 [F/M, H], b1, w2 [H, F/M]; H and F/M multiples of 128) or
    raises. -> (y [T, H] float32, stats [T, 2] float32)."""
    if r.device.type == "cpu":
        return ffn_block_partial_reference(r, ln1_scale, ln1_bias, w1, b1,
                                           w2, act, eps)
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act}")
    T, H, Fdim = _require_split("r", r, w1, b1, w2)
    _require_layer_norms(H, ln1_scale, ln1_bias)
    dev = r.device
    y = torch.empty((T, H), dtype=torch.float32, device=dev)
    stats = torch.empty((T, 2), dtype=torch.float32, device=dev)
    if T == 0:
        return y, stats
    u = torch.empty_like(r)
    h = torch.empty((T, Fdim), dtype=torch.bfloat16, device=dev)
    p = _build.ptr
    err = _build.library().lib.cocodr_ffn_block_partial_bf16(
        p(r), p(ln1_scale), p(ln1_bias), p(w1), p(b1), p(w2), p(u), p(stats),
        p(h), p(y), T, H, Fdim, ACTIVATIONS[act], eps, _build.stream_of(r))
    _build.check(err, "ffn_block partial kernel")
    fused_ffn_block_partial.launches += 1
    return y, stats


fused_ffn_block_partial.launches = 0


def fused_ffn_block_finish(r, stats, ln1_scale, ln1_bias, y, b2, ln2_scale,
                           ln2_bias, eps: float = 1e-12):
    """The split K1's part after the all-reduce: a CPU tensor takes the
    plain version; a CUDA tensor launches the residual + LN2 row pass (y
    the float32 sum of the ranks' partials, b2 bf16) or raises -> out
    [T, H] in r's dtype."""
    if r.device.type == "cpu":
        return ffn_block_finish_reference(r, stats, ln1_scale, ln1_bias, y,
                                          b2, ln2_scale, ln2_bias, eps)
    _build.require_cuda_operand("r", r, (torch.bfloat16,), 2)
    T, H = r.shape
    _require_sum(y, b2, T, H)
    _build.require_cuda_operand("stats", stats, (torch.float32,), 2)
    _require_layer_norms(H, ln1_scale, ln1_bias, ln2_scale, ln2_bias)
    out = torch.empty_like(r)
    if T == 0:
        return out
    p = _build.ptr
    err = _build.library().lib.cocodr_ffn_block_finish_bf16(
        p(r), p(stats), p(ln1_scale), p(ln1_bias), p(y), p(b2), p(ln2_scale),
        p(ln2_bias), p(out), T, H, eps, _build.stream_of(r))
    _build.check(err, "ffn_block finish kernel")
    fused_ffn_block_finish.launches += 1
    return out


fused_ffn_block_finish.launches = 0


def _all_reduce(y, axis):
    if axis is not None:
        torch.distributed.all_reduce(y, group=axis.group)
    return y


def fused_ffn_block_tp(r, ln1_scale, ln1_bias, w1, b1, w2, b2, ln2_scale,
                       ln2_bias, act, eps, axis):
    """The split half-layer's forward: the rank's partial, the all-reduce
    of y over the model axis (a parallel/tp.py TpAxis; None: a world of
    one's sum), the finish."""
    y, stats = fused_ffn_block_partial(r, ln1_scale, ln1_bias, w1, b1, w2,
                                       act, eps)
    return fused_ffn_block_finish(r, stats, ln1_scale, ln1_bias,
                                  _all_reduce(y, axis), b2, ln2_scale,
                                  ln2_bias, eps)


def xla_ffn_block_tp(r, ln1_scale, ln1_bias, w1, b1, w2, b2, ln2_scale,
                     ln2_bias, act, eps, axis):
    """`xla_ffn_block` on a rank's slices: f on the FFN's input, the
    partial product (no bias) summed over the model axis by g in float32,
    b2 added once; the formulation whose gradients `ffn_block_tp`
    returns."""
    u = layer_norm_f32(r.float(), ln1_scale, ln1_bias, eps).to(r.dtype)
    h = activation(act)(F.linear(copy_to_model(u, axis), w1, b1))
    y = reduce_from_model(F.linear(h, w2).float(), axis) + b2.float()
    return layer_norm_f32((u + y.to(r.dtype)).float(), ln2_scale, ln2_bias,
                          eps).to(r.dtype)


class _FfnBlockTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, s1, c1, w1, b1, w2, b2, s2, c2, act, eps, axis):
        ctx.save_for_backward(r, s1, c1, w1, b1, w2, b2, s2, c2)
        ctx.act, ctx.eps, ctx.axis = act, eps, axis
        return fused_ffn_block_tp(r, s1, c1, w1, b1, w2, b2, s2, c2, act,
                                  eps, axis)

    @staticmethod
    def backward(ctx, grad_out):
        grads = recompute_grads(
            lambda *a: xla_ffn_block_tp(*a, ctx.act, ctx.eps, ctx.axis),
            ctx.saved_tensors, ctx.needs_input_grad, grad_out)
        return (*grads, None, None, None)


def ffn_block_tp(r, ln1_scale, ln1_bias, w1, b1, w2, b2, ln2_scale, ln2_bias,
                 act: str = "gelu", eps: float = 1e-12, axis=None):
    """The split half-layer models/bert.py calls under tensor parallelism:
    w1 [F/M, H], b1 [F/M], w2 [H, F/M] this rank's slices, the rest whole;
    the split K1 forward, the gradient of `xla_ffn_block_tp`."""
    return _FfnBlockTp.apply(r, ln1_scale, ln1_bias, w1, b1, w2, b2,
                             ln2_scale, ln2_bias, act, eps, axis)


def ffn_partial_reference(x, w1, b1, w2, act: str = "gelu"):
    """Plain version of the split K5's part before the all-reduce: this
    rank's up GEMM and partial down GEMM -> y [T, H] float32, no bias."""
    h = activation(act)(x.float() @ w1.float().t() + b1.float())
    return h.to(x.dtype).float() @ w2.float().t()


def ffn_finish_reference(y, b2):
    """Plain version of the split K5's part after the all-reduce: y + b2
    in float32, rounded once to b2's dtype."""
    return (y + b2.float()).to(b2.dtype)


def fused_ffn_partial(x, w1, b1, w2, act: str = "gelu"):
    """The split K5's first part: a CPU tensor takes the plain version; a
    CUDA tensor launches the up GEMM and the partial down GEMM or raises
    -> y [T, H] float32."""
    if x.device.type == "cpu":
        return ffn_partial_reference(x, w1, b1, w2, act)
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act}")
    T, H, Fdim = _require_split("x", x, w1, b1, w2)
    y = torch.empty((T, H), dtype=torch.float32, device=x.device)
    if T == 0:
        return y
    h = torch.empty((T, Fdim), dtype=torch.bfloat16, device=x.device)
    p = _build.ptr
    err = _build.library().lib.cocodr_ffn_partial_bf16(
        p(x), p(w1), p(b1), p(w2), p(h), p(y), T, H, Fdim, ACTIVATIONS[act],
        _build.stream_of(x))
    _build.check(err, "ffn partial kernel")
    fused_ffn_partial.launches += 1
    return y


fused_ffn_partial.launches = 0


def fused_ffn_finish(y, b2):
    """The split K5's part after the all-reduce: a CPU tensor takes the
    plain version; a CUDA tensor launches the bias-and-round pass or
    raises -> bf16(y + b2) [T, H]."""
    if y.device.type == "cpu":
        return ffn_finish_reference(y, b2)
    T, H = y.shape
    _require_sum(y, b2, T, H)
    out = torch.empty((T, H), dtype=torch.bfloat16, device=y.device)
    if T == 0:
        return out
    p = _build.ptr
    err = _build.library().lib.cocodr_ffn_finish_bf16(
        p(y), p(b2), p(out), T, H, _build.stream_of(y))
    _build.check(err, "ffn finish kernel")
    fused_ffn_finish.launches += 1
    return out


fused_ffn_finish.launches = 0


def fused_ffn_tp(x, w1, b1, w2, b2, act, axis):
    """The split FFN's forward: the rank's partial, the all-reduce over
    the model axis, y + b2."""
    return fused_ffn_finish(_all_reduce(fused_ffn_partial(x, w1, b1, w2,
                                                          act), axis), b2)


class _FfnTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, act, axis):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.act, ctx.axis = act, axis
        return fused_ffn_tp(x, w1, b1, w2, b2, act, axis)

    @staticmethod
    def backward(ctx, grad_out):
        # g's backward is the identity: the rank's own xla_ffn (its b2
        # gradient is the whole one) with f on x, which sums x's gradient
        grads = recompute_grads(
            lambda x, *w: xla_ffn(copy_to_model(x, ctx.axis), *w, ctx.act),
            ctx.saved_tensors, ctx.needs_input_grad, grad_out)
        return (*grads, None, None)


def ffn_tp(x, w1, b1, w2, b2, act: str = "gelu", axis=None):
    """The split FFN of the dropout path under tensor parallelism: the
    split K5 forward, the gradient of the rank's `xla_ffn` with f on x."""
    return _FfnTp.apply(x, w1, b1, w2, b2, act, axis)


# --- K7: the W8A8 half-layer ----------------------------------------------

def ffn_block_int8_reference(r, ln1_scale, ln1_bias, w1q, sw1, b1, w2q, sw2,
                             b2, ln2_scale, ln2_bias, act: str = "gelu",
                             eps: float = 1e-12):
    """Plain version of K7, the TPU kernel's arithmetic in its order.
    r [T, H]; w1q [F, H] and w2q [H, F] int8 with per-output-channel
    float32 scales sw1 [F], sw2 [H]; biases and LayerNorm parameters
    float32. Activations are quantized per token in float32, the int8
    products summed exactly; the result is cast to r.dtype."""
    u32 = layer_norm_f32(r.float(), ln1_scale, ln1_bias, eps)
    uq, su = quantize_rows(u32)
    h = int8_matmul(uq, w1q).float() * (su * sw1.float()[None, :])
    h = activation(act)(h + b1.float())
    hq, sh = quantize_rows(h)
    y = int8_matmul(hq, w2q).float() * (sh * sw2.float()[None, :])
    z32 = u32 + y + b2.float()
    return layer_norm_f32(z32, ln2_scale, ln2_bias, eps).to(r.dtype)


def fused_ffn_block_int8(r, ln1_scale, ln1_bias, w1q, sw1, b1, w2q, sw2, b2,
                         ln2_scale, ln2_bias, act: str = "gelu",
                         eps: float = 1e-12):
    """K7 wrapper. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (bf16 r; int8 w1q [F, H], w2q [H, F]; float32
    scales, biases and LayerNorm parameters; H and F multiples of 128) or
    raises. Inference only."""
    if r.device.type == "cpu":
        return ffn_block_int8_reference(r, ln1_scale, ln1_bias, w1q, sw1, b1,
                                        w2q, sw2, b2, ln2_scale, ln2_bias,
                                        act, eps)
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act}")
    _check_no_grad("fused_ffn_block_int8", r, ln1_scale, ln1_bias, sw1, b1,
                   sw2, b2, ln2_scale, ln2_bias)
    T, H = r.shape
    Fdim = w1q.shape[0]
    i8, f32 = (torch.int8,), (torch.float32,)
    _build.require_cuda_operand("r", r, (torch.bfloat16,), 2)
    _build.require_cuda_operand("w1q", w1q, i8, 2)
    _build.require_cuda_operand("w2q", w2q, i8, 2)
    for name, p in (("sw1", sw1), ("b1", b1), ("sw2", sw2), ("b2", b2)):
        _build.require_cuda_operand(name, p, f32, 1)
    _require_layer_norms(H, ln1_scale, ln1_bias, ln2_scale, ln2_bias)
    if (w1q.shape != (Fdim, H) or w2q.shape != (H, Fdim)
            or sw1.shape != (Fdim,) or b1.shape != (Fdim,)
            or sw2.shape != (H,) or b2.shape != (H,)):
        raise ValueError(
            f"weights must be w1q [F, H], sw1 [F], b1 [F], w2q [H, F], "
            f"sw2 [H], b2 [H] with H={H}; got {tuple(w1q.shape)}, "
            f"{tuple(sw1.shape)}, {tuple(b1.shape)}, {tuple(w2q.shape)}, "
            f"{tuple(sw2.shape)}, {tuple(b2.shape)}"
        )
    _require_widths(T, H, Fdim)
    out = torch.empty_like(r)
    if T == 0:
        return out
    # scratch between the kernel's launches: uq and its row scales, LN1's
    # (mean, rstd) per row, the running max |h| per row (float bits as
    # int32), h in float32, hq and its row scales, the pre-LN2 sum z
    dev = r.device

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    uq = empty((T, H), torch.int8)
    stats = empty((T, 2), torch.float32)
    su = empty((T,), torch.float32)
    hmax = empty((T,), torch.int32)
    h = empty((T, Fdim), torch.float32)
    hq = empty((T, Fdim), torch.int8)
    sh = empty((T,), torch.float32)
    z = empty((T, H), torch.float32)
    p = _build.ptr
    err = _build.library().lib.cocodr_ffn_block_int8(
        p(r), p(ln1_scale), p(ln1_bias), p(w1q), p(sw1), p(b1), p(w2q),
        p(sw2), p(b2), p(ln2_scale), p(ln2_bias), p(uq), p(stats), p(su),
        p(hmax), p(h), p(hq), p(sh), p(z), p(out),
        T, H, Fdim, ACTIVATIONS[act], eps, _build.stream_of(r),
    )
    _build.check(err, "ffn_block_int8 kernel")
    fused_ffn_block_int8.launches += 1
    return out


fused_ffn_block_int8.launches = 0


def ffn_block_int8(r, ln1_scale, ln1_bias, w1, b1, w2, b2, ln2_scale,
                   ln2_bias, act: str = "gelu", eps: float = 1e-12):
    """The W8A8 half-layer from float weights (nn.Linear layout): quantizes
    w1 [F, H] and w2 [H, F] per output channel, then calls K7's wrapper.
    The weights are quantized as float32, as the JAX package quantizes its
    float32 parameters: a caller that holds them in bf16 gets other int8
    values and scales (models/bert.py::cast_matmul_weights keeps them
    float32 for this path)."""
    w1q, sw1 = quantize_cols(w1)
    w2q, sw2 = quantize_cols(w2)
    return fused_ffn_block_int8(r, ln1_scale, ln1_bias, w1q, sw1[:, 0],
                                b1.float(), w2q, sw2[:, 0], b2.float(),
                                ln2_scale, ln2_bias, act, eps)
