"""int8 search: K6 (int8 dual block-max sweep) and the block-argmax top-k
over an int8-quantized corpus.

Counterpart of cocodr_tpu/ops/pallas_mips.py: `_int8_sweep` /
`_sweep_kernel_i8` (-> `int8_sweep`, kernel `csrc/mips_int8.cu`),
`quantize_corpus_int8` and `mips_topk_int8`.

The corpus is quantized per dimension, once; at search time the
per-dimension scale folds into each query, which is then quantized per
query, so int32 scores rank like the 8-bit-rounded products. The packed
maxima (max << 3) | argmax are exact integers, so the selection is exact
given those scores; what the mode gives up against an exact float search
is the 8-bit rounding and the one-row-per-fine-block property of the fast
search. The int8 corpus takes half the device memory of the bf16 one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cocodr_tpu_torch.ops import _build
from cocodr_tpu_torch.ops.mips_hier import (
    REFERENCE_CHUNK,
    SWEEP_ROWS,
    _pad_replicate,
    _select_fine_blocks,
    block_argmax,
)

INT8_DEPTH = 64  # D must be a multiple (a k-stage of 128 reads zeros past D)
MAX_DEPTH = 16384  # D * 127^2 << 3 must stay inside int32


# --- K6: int8 dual block-max sweep ---------------------------------------

def int8_sweep_reference(q_i8, corpus_i8, fine: int = 8, coarse: int = 8):
    """Plain version of K6: int8 x int8 scores summed exactly, -> (packed
    fine maxima [Q, N/fine], packed coarse maxima [Q, N/(fine*coarse)])
    int32, fine = (max << 3) | first-occurrence argmax row, coarse = the
    max of its packed fine values. The products are summed in float64,
    exact for D <= 16,384 (|score| < 2^28)."""
    Q, D = q_i8.shape
    N = corpus_i8.shape[0]
    cb = fine * coarse
    if N % cb:
        raise ValueError(f"N={N} must be a multiple of {cb}")
    if fine > 8 or D > MAX_DEPTH:
        raise ValueError(f"the packing takes fine <= 8 and D <= {MAX_DEPTH}")
    q64 = q_i8.double()
    parts = []
    for s in range(0, N, REFERENCE_CHUNK):
        c64 = corpus_i8[s:s + REFERENCE_CHUNK].double()
        s3 = (q64 @ c64.t()).to(torch.int32).view(Q, -1, fine)
        best, arg = block_argmax(s3)
        parts.append((best * 8) | arg)  # best << 3 without a signed shift
    fine_max = torch.cat(parts, dim=1)
    return fine_max, fine_max.view(Q, -1, coarse).amax(-1)


def int8_sweep(q_i8, corpus_i8, fine: int = 8, coarse: int = 8):
    """K6 wrapper: q_i8 [Q, D], corpus_i8 [N, D] int8 -> (packed fine
    [Q, N/fine], packed coarse [Q, N/(fine*coarse)]) int32. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (fine = 8,
    coarse = 8, N % 256 == 0, D % 64 == 0, D <= 16384; an int8 wgmma GEMM
    whose epilogue packs the maxima in registers) or raises."""
    if corpus_i8.device.type == "cpu":
        return int8_sweep_reference(q_i8, corpus_i8, fine, coarse)
    _build.require_cuda_operand("q_i8", q_i8, (torch.int8,), 2)
    _build.require_cuda_operand("corpus_i8", corpus_i8, (torch.int8,), 2)
    Q, D = q_i8.shape
    N = corpus_i8.shape[0]
    if fine != 8 or coarse != 8:
        raise ValueError(f"the kernel takes fine=8, coarse=8; got {fine}, "
                         f"{coarse}")
    if (corpus_i8.shape[1] != D or N % SWEEP_ROWS or D % INT8_DEPTH
            or D > MAX_DEPTH):
        raise ValueError(
            f"the kernel takes N % {SWEEP_ROWS} == 0, D % {INT8_DEPTH} == 0 "
            f"and D <= {MAX_DEPTH}; got queries {tuple(q_i8.shape)}, corpus "
            f"{tuple(corpus_i8.shape)}"
        )
    fine_max = torch.empty((Q, N // 8), dtype=torch.int32,
                           device=corpus_i8.device)
    coarse_max = torch.empty((Q, N // 64), dtype=torch.int32,
                             device=corpus_i8.device)
    if Q == 0:
        return fine_max, coarse_max
    p = _build.ptr
    err = _build.library().lib.cocodr_int8_sweep(
        p(q_i8), p(corpus_i8), p(fine_max), p(coarse_max), Q, N, D,
        _build.stream_of(corpus_i8),
    )
    _build.check(err, "int8_sweep kernel")
    int8_sweep.launches += 1
    return fine_max, coarse_max


int8_sweep.launches = 0


# --- search -------------------------------------------------------------

def quantize_corpus_int8(corpus):
    """Symmetric per-dimension int8 quantization -> (corpus_i8 [N, D] int8,
    dim_scale [D] float32) with corpus ~ corpus_i8 * dim_scale. Rounds half
    to even, as jnp.round does."""
    c = torch.as_tensor(corpus).float()
    dim_scale = torch.clamp_min(c.abs().amax(0), 1e-30) / 127.0
    c_i8 = torch.clamp(torch.round(c / dim_scale), -127, 127).to(torch.int8)
    return c_i8, dim_scale


def quantize_queries(queries, dim_scale):
    """Fold the per-dimension corpus scale into the queries and quantize
    each query -> (q_i8 [Q, D] int8, q_scale [Q] float32)."""
    qf = queries.float() * dim_scale[None, :]
    q_scale = torch.clamp_min(qf.abs().amax(1), 1e-30) / 127.0
    q_i8 = torch.clamp(torch.round(qf / q_scale[:, None]), -127, 127)
    return q_i8.to(torch.int8), q_scale


def mips_topk_int8(queries, corpus_i8, dim_scale, k: int, tile: int = 2048,
                   fine: int = 8, coarse: int = 8, supers: int = 8,
                   n_real: int = 0):
    """Block-argmax top-k over an int8-quantized corpus -> (approximate
    float32 scores [Q, k], ids [Q, k] int64), ids from the packed argmax as
    in mips_topk_fast, scores (packed >> 3) * q_scale.

    n_real (not in the JAX function): a caller that pre-padded the corpus
    with replicate rows, as mips_topk_hierarchical's callers do, passes
    the real row count; all masking keys on it, and the results equal the
    call on the unpadded corpus."""
    Q, D = queries.shape
    N = corpus_i8.shape[0]
    if n_real:
        if n_real > N:
            raise ValueError(f"n_real={n_real} > corpus rows {N}")
        N = n_real
    k = min(k, N)
    cb = fine * coarse
    if fine > 8:
        raise ValueError("argmax packing uses 3 bits: fine <= 8")
    corpus_p = _pad_replicate(corpus_i8, max(tile, cb))
    n_coarse = corpus_p.shape[0] // cb
    n_fine_real = -(-N // fine)
    n_coarse_real = -(-N // cb)
    q_i8, q_scale = quantize_queries(queries, dim_scale)

    bm_fine, bm_coarse = int8_sweep(q_i8.contiguous(), corpus_p, fine, coarse)
    bm_coarse = bm_coarse.masked_fill(
        torch.arange(n_coarse, device=corpus_p.device) >= n_coarse_real,
        torch.iinfo(torch.int32).min,
    )
    vals, blocks = _select_fine_blocks(
        bm_fine, bm_coarse, k_sel=min(k, n_coarse), k_fine=k, coarse=coarse,
        supers=supers, n_fine_real=n_fine_real, k_super=k,
    )
    kk = vals.shape[1]
    ids = torch.clamp_max(blocks.long() * fine + (vals & 7), N - 1)
    scores = (vals >> 3).float() * q_scale[:, None]
    if kk < k:
        scores = F.pad(scores, (0, k - kk), value=float("-inf"))
        ids = F.pad(ids, (0, k - kk))
    return scores, ids
