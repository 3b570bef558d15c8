"""Hierarchical top-k MIPS: K2 (dual block-max sweep, plain and packed)
and K3 (exact top-k), and the exact and fast searches built on them.

Counterpart of cocodr_tpu/ops/pallas_mips.py: `_dual_sweep_mixed` /
`_sweep_kernel2` / `_pack_argmax` (-> `dual_sweep`, kernel
`csrc/mips_sweep.cu`), `pallas_topk` / `_topk_kernel` (-> `topk`, kernel
`csrc/topk.cu`), `_pad_replicate`, `_select_fine_blocks`,
`mips_topk_hierarchical` and `mips_topk_fast`.

Search (`mips_topk_hierarchical`):
  1. one sweep gives the maxima of every fine (8-row) and coarse (64-row)
     corpus block for every query;
  2. top-k over super (512-row) maxima, then top-k over the surviving
     supers' fine maxima, picks k fine blocks;
  3. the k*8 candidate rows are rescored exactly and the best k kept.
Every level is lossless by the block-max argument: a block whose max is at
least the k-th best score holds a top-k row, and at most k blocks can.

Fast search (`mips_topk_fast`) runs the sweep with pack=True: each fine
maximum carries its in-block argmax row in its 3 low mantissa bits, so the
selected fine blocks give doc ids directly, with no rescore.

Layouts: the sweep returns both maxima query-major, fine [Q, N/8] and
coarse [Q, N/64]; the TPU kernel's 3D super-rows layout existed to avoid a
Mosaic relayout and has no use here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cocodr_tpu_torch.ops import _build
from cocodr_tpu_torch.utils.logging import span

SWEEP_ROWS = 256  # corpus rows per sweep block: N must be a multiple
SWEEP_DEPTH = 32  # D per sweep stage: D must be a multiple
REFERENCE_CHUNK = 131072  # corpus rows per matmul in the plain sweep


def _neg(dtype):
    """The value an extracted slot takes: finfo.min or iinfo.min."""
    if dtype.is_floating_point:
        return torch.finfo(dtype).min
    return torch.iinfo(dtype).min


def scores(queries, corpus, dtype=torch.bfloat16):
    """[Q, D] x [n, D] -> [Q, n] float32 scores of the operands rounded to
    `dtype`: exact products of bf16 operands, float32 sums (the sweeps'
    arithmetic)."""
    return queries.to(dtype).float() @ corpus.to(dtype).float().t()


def block_argmax(s3):
    """[..., B, f] -> (max, first-occurrence argmax int32) over the last
    axis, by the TPU kernels' strict '>' select chain."""
    best = s3[..., 0]
    arg = torch.zeros(best.shape, dtype=torch.int32, device=s3.device)
    for r in range(1, s3.shape[-1]):
        m = s3[..., r] > best
        best = torch.where(m, s3[..., r], best)
        arg = torch.where(m, r, arg)
    return best, arg


def pack_low_bits(x, arg, bits: int):
    """float32 x with its `bits` low bit-pattern bits replaced by arg,
    (bits(x) & ~mask) | arg, negative values too (_pack_argmax)."""
    mask = (1 << bits) - 1
    return ((x.view(torch.int32) & ~mask) | arg).view(torch.float32)


def clear_low_bits(x, bits: int):
    """float32 x with its `bits` low bit-pattern bits cleared."""
    return (x.view(torch.int32) & ~((1 << bits) - 1)).view(torch.float32)


# --- K2: dual block-max sweep -------------------------------------------

def dual_sweep_reference(queries, corpus, fine: int = 8, coarse: int = 8,
                         pack: bool = False):
    """Plain version of K2: scores from bf16 operands summed in float32,
    -> (fine maxima [Q, N/fine], coarse maxima [Q, N/(fine*coarse)]).
    With pack, each fine maximum carries its first-occurrence argmax row in
    its 3 low bits and the coarse maxima are maxima of the packed values
    (_pack_argmax)."""
    Q = queries.shape[0]
    N = corpus.shape[0]
    cb = fine * coarse
    if N % cb:
        raise ValueError(f"N={N} must be a multiple of {cb}")
    if pack and fine > 8:
        raise ValueError("argmax packing uses 3 mantissa bits: fine <= 8")
    parts = []
    for s in range(0, N, REFERENCE_CHUNK):
        s3 = scores(queries, corpus[s:s + REFERENCE_CHUNK]).view(
            Q, -1, fine)
        if pack:
            best, arg = block_argmax(s3)
            parts.append(pack_low_bits(best, arg, 3))
        else:
            parts.append(s3.amax(-1))
    fine_max = torch.cat(parts, dim=1)
    return fine_max, fine_max.view(Q, -1, coarse).amax(-1)


def dual_sweep(queries, corpus, fine: int = 8, coarse: int = 8,
               pack: bool = False):
    """K2 wrapper: queries [Q, D], corpus [N, D] -> (fine [Q, N/fine],
    coarse [Q, N/(fine*coarse)]) float32, packed as dual_sweep_reference
    with pack. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (bf16 operands, fine = 8, coarse = 8, N % 256 == 0,
    D % 32 == 0) or raises. Launches count in `dual_sweep.launches`
    (pack=False) and `dual_sweep.pack_launches` (pack=True)."""
    if corpus.device.type == "cpu":
        return dual_sweep_reference(queries, corpus, fine, coarse, pack)
    bf16 = (torch.bfloat16,)
    _build.require_cuda_operand("queries", queries, bf16, 2)
    _build.require_cuda_operand("corpus", corpus, bf16, 2)
    Q, D = queries.shape
    N = corpus.shape[0]
    if fine != 8 or coarse != 8:
        raise ValueError(f"the kernel takes fine=8, coarse=8; got {fine}, "
                         f"{coarse}")
    if corpus.shape[1] != D or N % SWEEP_ROWS or D % SWEEP_DEPTH:
        raise ValueError(
            f"the kernel takes N % {SWEEP_ROWS} == 0 and D % {SWEEP_DEPTH} "
            f"== 0; got queries {tuple(queries.shape)}, corpus "
            f"{tuple(corpus.shape)}"
        )
    fine_max = torch.empty((Q, N // 8), dtype=torch.float32,
                           device=corpus.device)
    coarse_max = torch.empty((Q, N // 64), dtype=torch.float32,
                             device=corpus.device)
    if Q == 0:
        return fine_max, coarse_max
    lib = _build.library().lib
    fn = lib.cocodr_dual_sweep_packed_bf16 if pack else lib.cocodr_dual_sweep_bf16
    p = _build.ptr
    err = fn(p(queries), p(corpus), p(fine_max), p(coarse_max), Q, N, D,
             _build.stream_of(corpus))
    _build.check(err, "dual_sweep kernel")
    if pack:
        dual_sweep.pack_launches += 1
    else:
        dual_sweep.launches += 1
    return fine_max, coarse_max


dual_sweep.launches = 0
dual_sweep.pack_launches = 0


# --- K3: exact top-k ----------------------------------------------------

def topk_reference(x, k: int):
    """Plain version of K3, the TPU kernel's semantics: the row padded to a
    multiple of 128 with finfo.min/iinfo.min, then k rounds of (max, lowest
    index holding it, set that slot to the minimum). -> (vals [Q, k] in
    x.dtype, ids [Q, k] int32)."""
    Q, W = x.shape
    if not 1 <= k <= W:
        raise ValueError(f"k={k} must be in [1, {W}]")
    neg = _neg(x.dtype)
    Wp = -(-W // 128) * 128
    xs = torch.full((Q, Wp), neg, dtype=x.dtype, device=x.device)
    xs[:, :W] = x
    iota = torch.arange(Wp, device=x.device)
    rows = torch.arange(Q, device=x.device)
    vals = torch.empty((Q, k), dtype=x.dtype, device=x.device)
    ids = torch.empty((Q, k), dtype=torch.int32, device=x.device)
    for i in range(k):
        m = xs.amax(1)
        a = torch.where(xs == m[:, None], iota, Wp).amin(1)
        xs[rows, a] = neg
        vals[:, i] = m
        ids[:, i] = a.to(torch.int32)
    return vals, ids


def topk(x, k: int):
    """K3 wrapper: exact top-k along the last axis of [Q, W] float32 or
    int32, lowest index first on ties, the plain version's output bit for
    bit (csrc/topk.cu selects by radix, not by k rounds). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if x.device.type == "cpu":
        return topk_reference(x, k)
    _build.require_cuda_operand("x", x, (torch.float32, torch.int32), 2)
    Q, W = x.shape
    if not 1 <= k <= W:
        raise ValueError(f"k={k} must be in [1, {W}]")
    vals = torch.empty((Q, k), dtype=x.dtype, device=x.device)
    ids = torch.empty((Q, k), dtype=torch.int32, device=x.device)
    if Q == 0:
        return vals, ids
    lib = _build.library().lib
    fn = lib.cocodr_topk_f32 if x.dtype == torch.float32 else lib.cocodr_topk_i32
    p = _build.ptr
    err = fn(p(x), p(vals), p(ids), Q, W, k, _build.stream_of(x))
    _build.check(err, "topk kernel")
    topk.launches += 1
    return vals, ids


topk.launches = 0


# --- search ---------------------------------------------------------------

def _pad_replicate(corpus, multiple: int):
    """Pad the row count to a multiple by repeating the last row: a pad row
    can never beat its block's max (it copies row N-1, a real row of the
    same final block)."""
    pad = (-corpus.shape[0]) % multiple
    if not pad:
        return corpus
    return torch.cat([corpus, corpus[-1:].expand(pad, corpus.shape[1])])


def _select_fine_blocks(bm_fine, bm_coarse, k_sel: int, k_fine: int,
                        coarse: int, supers: int, n_fine_real: int,
                        k_super: int):
    """Fine-block selection -> (vals, fine-block ids) of the k_fine best
    fine maxima. bm_fine [Q, n_fine], bm_coarse [Q, n_coarse], float32
    (-inf on padded blocks) or packed int32 (iinfo.min on padded blocks).

    Large corpora: K3 top-k over super maxima (max of `supers` coarse
    maxima), then K3 top-k over the surviving supers' fine maxima. Small
    corpora (no super level): torch.topk over coarse, then over the chosen
    blocks' fine maxima, where the JAX package calls lax.top_k; the two
    may order exact ties differently."""
    Q, n_coarse = bm_coarse.shape
    dev = bm_coarse.device
    neg = (float("-inf") if bm_coarse.dtype.is_floating_point
           else torch.iinfo(bm_coarse.dtype).min)
    kf = min(k_fine, n_fine_real)
    if supers <= 1 or n_coarse <= supers * k_sel:
        kc = min(k_sel, n_coarse)
        coarse_ids = torch.topk(bm_coarse, kc, dim=1).indices
        fine_max = bm_fine.view(Q, n_coarse, coarse).gather(
            1, coarse_ids[:, :, None].expand(Q, kc, coarse)
        ).reshape(Q, kc * coarse)
        fine_cand = (coarse_ids[:, :, None] * coarse
                     + torch.arange(coarse, device=dev)).reshape(Q, kc * coarse)
        fine_max = fine_max.masked_fill(fine_cand >= n_fine_real, neg)
        vals, pos = torch.topk(fine_max, kf, dim=1)
        return vals, fine_cand.gather(1, pos)

    n_super = -(-n_coarse // supers)
    pad_c = n_super * supers - n_coarse
    sup = F.pad(bm_coarse, (0, pad_c), value=neg).view(Q, n_super, supers)
    sup = sup.amax(2)
    fps = supers * coarse  # fine blocks per super block
    # Bounded by the count of supers that hold a real row, as the JAX
    # package's _exact2_core bounds it. Its _select_fine_blocks bounds by
    # n_super only: where padding adds whole supers and fewer than k_super
    # are real, K3 (which fills rows past their real entries with an
    # extracted slot) picks a super twice and the search returns duplicate
    # ids (ROADMAP.md Queue 3).
    ks = min(k_super, -(-n_fine_real // fps))
    _, sup_ids = topk(sup.contiguous(), ks)
    sup_ids = sup_ids.long()
    bm_f = F.pad(bm_fine, (0, n_super * fps - bm_fine.shape[1]), value=neg)
    fine_max = bm_f.view(Q, n_super, fps).gather(
        1, sup_ids[:, :, None].expand(Q, ks, fps)
    ).reshape(Q, ks * fps)
    fine_cand = (sup_ids[:, :, None] * fps
                 + torch.arange(fps, device=dev)).reshape(Q, ks * fps)
    fine_max = fine_max.masked_fill(fine_cand >= n_fine_real, neg)
    vals, pos = topk(fine_max, kf)
    return vals, fine_cand.gather(1, pos.long())


def mips_topk_hierarchical(queries, corpus, k: int, tile: int = 2048,
                           fine: int = 8, coarse: int = 8, supers: int = 8,
                           n_real: int = 0):
    """Exact top-k of queries [Q, D] against corpus [N, D] by inner product
    of bf16 operands with float32 sums -> (scores [Q, k] float32, ids
    [Q, k] int64). The corpus is replicate-padded to a multiple of
    max(tile, fine*coarse); a caller that pre-padded it that way passes the
    real row count as n_real, and all masking keys on that count. Spans:
    `cocodr.search.sweep` (K2), `.select` (the block selection) and
    `.rescore` (the candidates' gather, product and top-k)."""
    Q, D = queries.shape
    N = corpus.shape[0]
    if n_real:
        if n_real > N:
            raise ValueError(f"n_real={n_real} > corpus rows {N}")
        N = n_real
    k = min(k, N)
    cb = fine * coarse
    corpus_p = _pad_replicate(corpus, max(tile, cb)).to(torch.bfloat16)
    Np = corpus_p.shape[0]
    n_coarse = Np // cb
    extra = 1 if N % cb else 0
    k_sel = min(k + extra, n_coarse)
    qq = queries.to(torch.bfloat16).contiguous()

    with span("cocodr.search.sweep"):
        bm_fine, bm_coarse = dual_sweep(qq, corpus_p, fine, coarse)
    n_fine_real = -(-N // fine)
    n_coarse_real = -(-N // cb)
    dev = corpus_p.device
    bm_coarse = bm_coarse.masked_fill(
        torch.arange(n_coarse, device=dev) >= n_coarse_real, float("-inf")
    )
    with span("cocodr.search.select"):
        _, fine_ids = _select_fine_blocks(
            bm_fine, bm_coarse, k_sel=k_sel, k_fine=k + extra,
            coarse=coarse, supers=supers, n_fine_real=n_fine_real,
            k_super=k + (1 if N % (cb * supers) else 0),
        )
    kf = fine_ids.shape[1]

    # rescore the candidates: whole fine blocks, gathered in query chunks
    # that keep the gather buffer near 750M elements
    blocks = corpus_p.view(Np // fine, fine, D)
    chunk = max(128, min(Q, (750 * 1024 * 1024) // (kf * fine * D)))
    offs = torch.arange(fine, device=dev)
    vals, ids = [], []
    with span("cocodr.search.rescore"):
        for s in range(0, Q, chunk):
            q_c, fid_c = qq[s:s + chunk], fine_ids[s:s + chunk]
            C = q_c.shape[0]
            rows = blocks[fid_c].reshape(C, kf * fine, D)
            cand = (fid_c[:, :, None] * fine + offs).reshape(C, kf * fine)
            scores = torch.bmm(rows.float(), q_c.float()[:, :, None])[:, :, 0]
            scores = scores.masked_fill(cand >= N, float("-inf"))
            v, pos = topk(scores.contiguous(), k)
            vals.append(v)
            ids.append(cand.gather(1, pos.long()))
    return torch.cat(vals), torch.cat(ids)


def mips_topk_fast(queries, corpus, k: int, tile: int = 2048, fine: int = 8,
                   coarse: int = 8, supers: int = 8, n_real: int = 0):
    """Rescore-free approximate top-k by block argmax -> (scores [Q, k]
    float32, ids [Q, k] int64).

    The sweep packs each fine block's first-occurrence argmax row into the
    3 low mantissa bits of its max (K2, pack=True); the selection over the
    packed maxima then gives doc ids directly, with no candidate gather and
    no rescore. At most one row per fine block is returned, so a true
    top-k row is missed only when it shares its 8-row block with a better
    top-k row. Scores are the block maxima with their 3 low bits cleared
    (<= 7 ULP low). Padding and n_real as in mips_topk_hierarchical. As in
    the JAX package, a selected slot whose value is -inf (a corpus with
    fewer real fine blocks than k) keeps the id its bits give, and a
    result narrower than k (tiny corpora) is padded with -inf scores and
    id 0."""
    Q, D = queries.shape
    N = corpus.shape[0]
    if n_real:
        if n_real > N:
            raise ValueError(f"n_real={n_real} > corpus rows {N}")
        N = n_real
    k = min(k, N)
    cb = fine * coarse
    if fine > 8:
        raise ValueError("argmax packing uses 3 mantissa bits: fine <= 8")
    corpus_p = _pad_replicate(corpus, max(tile, cb)).to(torch.bfloat16)
    n_coarse = corpus_p.shape[0] // cb
    n_fine_real = -(-N // fine)
    n_coarse_real = -(-N // cb)
    qq = queries.to(torch.bfloat16).contiguous()

    bm_fine, bm_coarse = dual_sweep(qq, corpus_p, fine, coarse, pack=True)
    bm_coarse = bm_coarse.masked_fill(
        torch.arange(n_coarse, device=corpus_p.device) >= n_coarse_real,
        float("-inf"),
    )
    vals, blocks = _select_fine_blocks(
        bm_fine, bm_coarse, k_sel=min(k, n_coarse), k_fine=k, coarse=coarse,
        supers=supers, n_fine_real=n_fine_real, k_super=k,
    )
    kk = vals.shape[1]
    bits = vals.contiguous().view(torch.int32)
    ids = torch.clamp_max(blocks.long() * fine + (bits & 7), N - 1)
    clean = clear_low_bits(vals.contiguous(), 3)
    if kk < k:  # tiny corpus: pad the result width to k
        clean = F.pad(clean, (0, k - kk), value=float("-inf"))
        ids = F.pad(ids, (0, k - kk))
    return clean, ids
