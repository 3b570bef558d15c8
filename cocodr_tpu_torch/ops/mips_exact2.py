"""Exact top-k by an argmax certificate: K9 (top-2 certificate sweep) and
`mips_topk_exact2`.

Counterpart of cocodr_tpu/ops/pallas_mips.py: `_top2_sweep` /
`_sweep_kernel_top2` (-> `top2_sweep`, kernel `csrc/mips_top2.cu`),
`_clear6`, `_exact2_core` and `mips_topk_exact2`.

The sweep keeps, per 64-row coarse block, its exact max, its argmax row
(6 bits packed into the second-best value) and its second-best value.
Selection picks the top-(k+slack) blocks by max; their argmax rows are k+
distinct docs with exact scores, so the k-th best of them is a lower bound
s_lb on the k-th result. A block can hide a further top-k doc only if its
second best reaches s_lb, so only those blocks are rescored. Whether every
flagged block fit the rescore budget is checked on the card; if one did
not, the search falls back to `mips_topk_hierarchical` (exactness never
rests on the estimate of how many blocks get flagged).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cocodr_tpu_torch.ops import _build
from cocodr_tpu_torch.ops.mips_hier import (
    REFERENCE_CHUNK,
    SWEEP_DEPTH,
    SWEEP_ROWS,
    _pad_replicate,
    clear_low_bits,
    mips_topk_hierarchical,
    pack_low_bits,
    scores,
    topk,
)

NEG_KEY = -1e38  # the rescore key of an unflagged block (see _exact2_core)


# --- K9: top-2 certificate sweep ----------------------------------------

def top2_sweep_reference(queries, corpus, cb: int = 64):
    """Plain version of K9: scores from bf16 operands summed in float32,
    per cb-row block -> (best [Q, N/cb] the exact max, pack [Q, N/cb] the
    second element of the block's multiset with the first-occurrence
    argmax row in its 6 low bits). cb % 8 == 0, cb <= 64."""
    Q = queries.shape[0]
    N = corpus.shape[0]
    if N % cb or cb % 8 or cb > 64:
        raise ValueError(f"cb={cb} must be a multiple of 8, <= 64, and "
                         f"divide N={N}")
    iota = torch.arange(cb, device=corpus.device)
    bests, packs = [], []
    for s in range(0, N, REFERENCE_CHUNK):
        s3 = scores(queries, corpus[s:s + REFERENCE_CHUNK]).view(
            Q, -1, cb)
        best = s3.amax(-1)
        arg = torch.where(s3 == best[..., None], iota, cb).amin(-1)
        second = s3.masked_fill(iota == arg[..., None], float("-inf"))
        bests.append(best)
        packs.append(pack_low_bits(second.amax(-1), arg.to(torch.int32), 6))
    return torch.cat(bests, dim=1), torch.cat(packs, dim=1)


def top2_sweep(queries, corpus, cb: int = 64):
    """K9 wrapper: queries [Q, D], corpus [N, D] -> (best [Q, N/cb], pack
    [Q, N/cb]) float32, as top2_sweep_reference. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (bf16 operands,
    cb = 64, N % 256 == 0, D % 32 == 0; a bf16 wgmma GEMM whose epilogue
    keeps each block's best, second and argmax in registers) or raises."""
    if corpus.device.type == "cpu":
        return top2_sweep_reference(queries, corpus, cb)
    bf16 = (torch.bfloat16,)
    _build.require_cuda_operand("queries", queries, bf16, 2)
    _build.require_cuda_operand("corpus", corpus, bf16, 2)
    Q, D = queries.shape
    N = corpus.shape[0]
    if cb != 64:
        raise ValueError(f"the kernel takes cb=64; got {cb}")
    if corpus.shape[1] != D or N % SWEEP_ROWS or D % SWEEP_DEPTH:
        raise ValueError(
            f"the kernel takes N % {SWEEP_ROWS} == 0 and D % {SWEEP_DEPTH} "
            f"== 0; got queries {tuple(queries.shape)}, corpus "
            f"{tuple(corpus.shape)}"
        )
    best = torch.empty((Q, N // cb), dtype=torch.float32, device=corpus.device)
    pack = torch.empty_like(best)
    if Q == 0:
        return best, pack
    p = _build.ptr
    err = _build.library().lib.cocodr_top2_sweep_bf16(
        p(queries), p(corpus), p(best), p(pack), Q, N, D,
        _build.stream_of(corpus),
    )
    _build.check(err, "top2_sweep kernel")
    top2_sweep.launches += 1
    return best, pack


top2_sweep.launches = 0


# --- search -------------------------------------------------------------

def _exact2_core(queries, corpus_p, n_real: int, k: int, cb: int,
                 supers: int, rescore_blocks: int):
    """-> (vals [Q, k], ids [Q, k] int64, ok): ok is a 0-dim bool tensor,
    False when some query flagged a block that did not fit the
    rescore_blocks budget (the caller then falls back)."""
    Q, D = queries.shape
    Np = corpus_p.shape[0]
    N = int(n_real)
    R = rescore_blocks
    dev = corpus_p.device
    qq = queries.to(torch.bfloat16).contiguous()
    best, pack = top2_sweep(qq, corpus_p, cb)  # [Q, n_cb] each

    n_cb = Np // cb
    n_cb_real = -(-N // cb)
    col_pad = torch.arange(n_cb, device=dev) >= n_cb_real
    bm = best.masked_fill(col_pad, float("-inf"))
    pk = pack.masked_fill(col_pad, float("-inf"))

    # super level: top-(k + slack) super blocks, then the top kc coarse
    # blocks among the survivors' runs of coarse blocks
    n_super = -(-n_cb // supers)
    pad_c = n_super * supers - n_cb
    bm_p = F.pad(bm, (0, pad_c), value=float("-inf")).view(Q, n_super, supers)
    pk_p = F.pad(pk, (0, pad_c), value=float("-inf")).view(Q, n_super, supers)
    sup = bm_p.amax(2)
    # bounded by the count of real supers: K3 pads with finfo.min, which
    # outranks the -inf masked pad supers
    n_super_real = -(-n_cb_real // supers)
    ks = min(k + (1 if N % (cb * supers) else 0), n_super_real)
    _, sup_ids = topk(sup.contiguous(), ks)
    sup_ids = sup_ids.long()
    run_idx = sup_ids[:, :, None].expand(Q, ks, supers)
    best_runs = bm_p.gather(1, run_idx).reshape(Q, ks * supers)
    pack_runs = pk_p.gather(1, run_idx).reshape(Q, ks * supers)
    cand_blk = (sup_ids[:, :, None] * supers
                + torch.arange(supers, device=dev)).reshape(Q, ks * supers)

    extra = 1 if N % cb else 0
    kc = min(k + extra, n_cb_real, ks * supers)
    vals, pos = topk(best_runs, kc)
    pos = pos.long()
    blk = cand_blk.gather(1, pos)
    pks = pack_runs.gather(1, pos)

    pk_bits = pks.view(torch.int32)
    finite = torch.isfinite(pks)
    arg = torch.where(finite, pk_bits & 63, 0)
    second = torch.where(finite, pk_bits & ~63, pk_bits).view(torch.float32)
    doc = torch.clamp_max(blk * cb + arg, N - 1)

    # the certificate: the kc selected blocks' argmax docs are kc distinct
    # real docs with exact scores, so vals[:, k-1] bounds the k-th best
    # score from below; only blocks whose second best reaches it can hide
    # another top-k doc
    s_lb = clear_low_bits(vals[:, k - 1].contiguous(), 6)
    flag = second >= s_lb[:, None]

    # rescore the top R flagged blocks. Unflagged slots carry -1e38:
    # above K3's finfo.min padding and extraction value, so an all
    # unflagged row still yields R distinct positions; below any real
    # second, so flagged blocks always win the R slots
    key = torch.where(flag, second, torch.full_like(second, NEG_KEY))
    _, rpos = topk(key.contiguous(), R)
    rpos = rpos.long()
    resc_blk = blk.gather(1, rpos)  # [Q, R]
    blocks = corpus_p.view(n_cb, cb, D)
    offs = torch.arange(cb, device=dev)
    budget_rows = max(1, (512 * 1024 * 1024) // (R * cb * D * 2))
    chunk = max(128, min(Q, budget_rows))
    rs, rc = [], []
    for s in range(0, Q, chunk):
        q_c, rb_c = qq[s:s + chunk], resc_blk[s:s + chunk]
        C = q_c.shape[0]
        rows = blocks[rb_c].reshape(C, R * cb, D)
        sc = torch.bmm(rows.float(), q_c.float()[:, :, None])[:, :, 0]
        c2 = (rb_c[:, :, None] * cb + offs).reshape(C, R * cb)
        rs.append(sc.masked_fill(c2 >= N, float("-inf")))
        rc.append(c2)
    rs, rc = torch.cat(rs), torch.cat(rc)

    # suppress the argmax candidate of every rescored block (its rows, the
    # argmax row among them, are all in the rescored set), so no doc
    # appears twice
    sup_mask = (torch.arange(kc, device=dev)[None, :, None]
                == rpos[:, None, :]).any(2)
    argv = vals.masked_fill(sup_mask, float("-inf"))
    # the certificate itself: every flagged block got a rescore slot
    ok = torch.logical_not((flag & ~sup_mask).any())

    allv = torch.cat([argv, rs], dim=1).contiguous()
    alli = torch.cat([doc, torch.clamp_max(rc, N - 1)], dim=1)
    fv, fp = topk(allv, k)
    return fv, alli.gather(1, fp.long()), ok


def mips_topk_exact2(queries, corpus, k: int, tile: int = 2048, cb: int = 64,
                     supers: int = 8, rescore_blocks: int = 0):
    """Exact top-k by the argmax certificate -> (scores [Q, k] float32,
    ids [Q, k] int64). rescore_blocks = 0 sizes the budget from the
    expected flag count. Small corpora delegate to mips_topk_hierarchical,
    and so does a search whose certificate fails on the card (a host read
    of one boolean); each fallback counts in mips_topk_exact2.fallbacks.
    Scores are the sweep's float32 sums; ties go lowest index first."""
    Q, D = queries.shape
    N = corpus.shape[0]
    k = min(k, N)
    n_cb_real = -(-N // cb)
    if n_cb_real < k + 2 or N < max(tile, cb * supers * 2):
        # the certificate needs >= k selectable blocks and the tile
        # pipeline; the classic path is already fast here
        return mips_topk_hierarchical(queries, corpus, k)
    if rescore_blocks <= 0:
        lam = k * (k - 1) / 2 * cb / N
        rescore_blocks = int(min(32, max(4, lam + 6 * lam ** 0.5 + 3)))
    corpus_p = _pad_replicate(corpus, max(tile, cb * supers)).to(
        torch.bfloat16)
    vals, ids, ok = _exact2_core(queries, corpus_p, n_real=N, k=k, cb=cb,
                                 supers=supers, rescore_blocks=rescore_blocks)
    if not bool(ok.item()):
        mips_topk_exact2.fallbacks += 1
        return mips_topk_hierarchical(queries, corpus, k)
    return vals, ids


mips_topk_exact2.fallbacks = 0
