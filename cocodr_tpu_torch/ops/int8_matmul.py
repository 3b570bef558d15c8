"""W8A8 dynamic quantization: the counterpart of cocodr_tpu/ops/int8_matmul.py.

These are K7's plain building blocks (`ops.ffn.ffn_block_int8_reference`)
and the weight quantizer of its dispatcher (`ops.ffn.ffn_block_int8`):
  - weights: per-output-channel symmetric int8, scale = max|w| / 127;
  - activations: per-token symmetric int8, scale = max|x| / 127;
  - int8 x int8 products summed exactly, dequantized as
    sum * (row scale * column scale) in float32, bias added in float32.

Layout: weights are in nn.Linear layout [F, H], so an output channel is a
ROW of the weight; the JAX package's kernels are [H, F], where it is a
column. `quantize_cols` keeps the JAX name (it quantizes per output
channel) and returns the transposes of the JAX results: int8 [F, H] and
scales [F, 1].

Rounding is half to even (torch.round, as jnp.round), the quantized value
is x / s (a division, not x * (1 / s)), and s = max(max|x|, 1e-30) / 127,
so all-zero rows quantize to 0. The integer sums are taken as float64
matrix products: every product is below 2^14 and a sum of up to 2^39 of
them is exact in float64, so they equal int32 sums for any width the
encoder has (PyTorch has no int32 matrix product on the CPU).
"""
from __future__ import annotations

import torch


def _quantize(xf, dim: int):
    s = torch.clamp_min(xf.abs().amax(dim, keepdim=True), 1e-30) / 127.0
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def quantize_rows(x):
    """[T, H] float -> (int8 [T, H], float32 scales [T, 1]): per row."""
    return _quantize(x.float(), -1)


def quantize_cols(w):
    """nn.Linear weight [F, H] float -> (int8 [F, H], float32 scales
    [F, 1]): per output channel, one scale per row."""
    return _quantize(w.float(), -1)


def int8_matmul(xq, wq):
    """int8 [T, H] x int8 [F, H] -> the exact sums [T, F] as float64."""
    return xq.double() @ wq.double().t()


def dense_w8a8(x, weight, bias=None, out_dtype=None):
    """y = x . weight^T (+ bias) with dynamic per-token activation
    quantization and per-output-channel weight quantization. x [..., H];
    weight [F, H] in any float dtype; bias [F] or None. -> [..., F] in
    out_dtype (default x.dtype)."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    xq, sx = quantize_rows(x.reshape(-1, x.shape[-1]))
    wq, sw = quantize_cols(weight)
    y = int8_matmul(xq, wq).float() * (sx * sw.t())
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*lead, weight.shape[0])
