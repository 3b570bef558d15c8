"""Peaks of one NVIDIA H100 SXM and the work of the port's kernels and steps.

The work of a kernel is counted from the function it computes and its input
shapes, never from what one implementation happens to do, so that a later
kernel of the same function is read against the same work. Each input byte
is counted read once and each output byte written once. A kernel's least
time is the larger of its operations over the op rate of its kind and its
bytes over the HBM rate; a roofline share is the summed least time of a
kernel's launches over their summed device time.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W power limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
FP32_OP_PER_S = 67e12  # outside the tensor cores: compares, selections


def least_seconds(ops: float, nbytes: float,
                  op_rate: float = BF16_FLOP_PER_S) -> float:
    return max(ops / op_rate, nbytes / HBM_BYTES_PER_S)


def ffn_block_work(T: int, H: int, F: int):
    """K1 (K4 at bert-large widths): LN1, the up product and GELU, the down
    product, the residual and LN2 over T tokens -> (operations, bytes): the
    two products; r in and out (bf16), both weights and biases (bf16), four
    LayerNorm vectors (float32)."""
    ops = 4 * T * H * F
    nbytes = 2 * T * H * 2 + 2 * H * F * 2 + (F + H) * 2 + 4 * H * 4
    return ops, nbytes


def ffn_work(T: int, H: int, F: int):
    """K5: the up product and GELU, the down product and its bias over T
    tokens -> (operations, bytes): x in and y out, both weights and biases
    (bf16)."""
    ops = 4 * T * H * F
    nbytes = 2 * T * H * 2 + 2 * H * F * 2 + (F + H) * 2
    return ops, nbytes


def sweep_work(Q: int, N: int, D: int):
    """K2: the bf16 score product of Q queries and N corpus rows of width D,
    reduced to the maxima of blocks of 8 and 64 rows -> (operations, bytes):
    corpus and queries in, the float32 block maxima out."""
    ops = 2 * Q * N * D
    nbytes = N * D * 2 + Q * D * 2 + Q * (N // 8 + N // 64) * 4
    return ops, nbytes


def topk_work(Q: int, W: int, k: int):
    """K3: the top k of each of Q rows of W float32 or int32 entries ->
    (compares, bytes): one compare an entry of the row padded to 128, at
    the float32 rate; the row read once, k values and ids written."""
    Wp = -(-W // 128) * 128
    return Q * Wp, Q * W * 4 + Q * k * 8


def encoder_forward_flops(L: int, H: int, F: int, layers: int) -> int:
    """One record of L real tokens through a BERT encoder: per token and
    layer the Q, K, V and output projections (8 H^2) and the FFN (4 H F),
    per layer the scores and the PV product (4 L^2 H)."""
    return layers * (L * (8 * H * H + 4 * H * F) + 4 * L * L * H)


def search_flops(Q: int, N: int, D: int) -> int:
    """The score product of an exact search: 2 Q N D."""
    return 2 * Q * N * D


def coco_step_flops(H: int, F: int, V: int, layers: int, n_head: int,
                    spans: int, seq: int, rows: int) -> int:
    """One direct COCO step: per token and layer (the backbone's and the
    c_head's) the forward's projections (8 H^2), scores and PV (4 S H) and
    FFN (4 H F), the backward twice the forward; the MLM transform (2 H^2)
    and the tied decoder (2 H V) over the `rows` that carry a label (the
    head's and the late loss's), forward and backward; the [B, B]
    contrastive product. The backward's recompute of the FFN and the
    decoder's padded budget rows are the program's choice and not counted."""
    fwd = 8 * H * H + 4 * seq * H + 4 * H * F
    tokens = spans * seq * (layers + n_head)
    head = 3 * (2 * H * H + 2 * H * V)
    return tokens * 3 * fwd + rows * head + 6 * spans * spans * H
