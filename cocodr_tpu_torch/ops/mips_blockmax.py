"""Flat block-max search: K10 (block-32 max sweep) and
`mips_topk_blockmax_pallas`.

Counterpart of cocodr_tpu/ops/pallas_mips.py: `blockmax_sweep_pallas` and
`_blockmax_sweep_transposed` / `_sweep_kernel` (-> `block_sweep`, kernel
`csrc/mips_sweep.cu`, block = 32) and `mips_topk_blockmax_pallas`: one
sweep gives every 32-row block's max score for every query, one top-k over
those maxima picks k (+1) blocks, and their rows are rescored. Exact by the
block-max argument. The JAX package's hierarchical search replaced it on
every entry point; it stays public, as there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cocodr_tpu_torch.ops import _build
from cocodr_tpu_torch.ops.mips import rescore_topk
from cocodr_tpu_torch.ops.mips_hier import (
    REFERENCE_CHUNK,
    SWEEP_DEPTH,
    SWEEP_ROWS,
    scores,
)


# --- K10: block max sweep -----------------------------------------------

def block_sweep_reference(queries, corpus, block: int = 32):
    """Plain version of K10: scores from bf16 operands summed in float32,
    -> the max of every `block`-row block [Q, N/block]."""
    Q = queries.shape[0]
    N = corpus.shape[0]
    if N % block:
        raise ValueError(f"N={N} must be a multiple of {block}")
    step = REFERENCE_CHUNK // block * block
    return torch.cat([
        scores(queries, corpus[s:s + step]).view(Q, -1, block).amax(-1)
        for s in range(0, N, step)
    ], dim=1)


def block_sweep(queries, corpus, block: int = 32):
    """K10 wrapper: queries [Q, D], corpus [N, D] -> block maxima
    [Q, N/block] float32. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (bf16 operands, block = 32, N % 256 == 0,
    D % 32 == 0) or raises."""
    if corpus.device.type == "cpu":
        return block_sweep_reference(queries, corpus, block)
    bf16 = (torch.bfloat16,)
    _build.require_cuda_operand("queries", queries, bf16, 2)
    _build.require_cuda_operand("corpus", corpus, bf16, 2)
    Q, D = queries.shape
    N = corpus.shape[0]
    if block != 32:
        raise ValueError(f"the kernel takes block=32; got {block}")
    if corpus.shape[1] != D or N % SWEEP_ROWS or D % SWEEP_DEPTH:
        raise ValueError(
            f"the kernel takes N % {SWEEP_ROWS} == 0 and D % {SWEEP_DEPTH} "
            f"== 0; got queries {tuple(queries.shape)}, corpus "
            f"{tuple(corpus.shape)}"
        )
    out = torch.empty((Q, N // block), dtype=torch.float32,
                      device=corpus.device)
    if Q == 0:
        return out
    p = _build.ptr
    err = _build.library().lib.cocodr_block32_sweep_bf16(
        p(queries), p(corpus), p(out), Q, N, D, _build.stream_of(corpus))
    _build.check(err, "block_sweep kernel")
    block_sweep.launches += 1
    return out


block_sweep.launches = 0


# --- search -------------------------------------------------------------

def blockmax_sweep_pallas(queries, corpus, tile: int = 2048, block: int = 32):
    """[Q, D] x [N, D] -> per-block score maxima [Q, N//block] (K10). N
    must be a multiple of `tile`: pad with zero rows and mask downstream
    (zero rows score 0.0)."""
    N = corpus.shape[0]
    if N % tile:
        raise ValueError(f"N={N} must be a multiple of tile={tile}")
    qq = queries.to(torch.bfloat16).contiguous()
    return block_sweep(qq, corpus.to(torch.bfloat16).contiguous(), block)


def mips_topk_blockmax_pallas(queries, corpus, k: int, tile: int = 2048,
                              block: int = 32):
    """Exact top-k through the block-max sweep and a bf16 rescore ->
    (scores [Q, k] float32, ids [Q, k] int64). As in the JAX package the
    corpus is padded with zero rows (not replicate rows) to a tile
    multiple, and whole padded blocks are masked; the last real block may
    hold zero rows that raise its max, which one extra block slot
    absorbs."""
    N = corpus.shape[0]
    k = min(k, N)
    pad = (-N) % tile
    corpus_p = F.pad(corpus, (0, 0, 0, pad)) if pad else corpus
    bm = blockmax_sweep_pallas(queries, corpus_p, tile=tile, block=block)
    n_blocks_real = -(-N // block)
    bm = bm.masked_fill(
        torch.arange(bm.shape[1], device=bm.device) >= n_blocks_real,
        float("-inf"),
    )
    extra = 1 if N % block else 0
    kb = min(k + extra, n_blocks_real)
    block_ids = torch.topk(bm, kb, dim=1).indices
    cand = (block_ids[:, :, None] * block
            + torch.arange(block, device=bm.device)).reshape(bm.shape[0], -1)
    cand = cand.masked_fill(cand >= N, -1)
    # bf16 multiplies keep the rescore consistent with the sweep's scores
    return rescore_topk(queries, corpus, cand, k, dtype=torch.bfloat16)
