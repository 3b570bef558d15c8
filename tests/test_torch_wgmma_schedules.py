"""The schedules of the port's kernels on the wgmma main loop
(cocodr_tpu_torch/csrc/gemm_wgmma.cuh), emulated on the CPU:

- K7 (csrc/ffn_block_int8.cu): the up GEMM by column tiles, each tile's
  h written and its row max |h| folded into a running max in any tile
  order (the kernel's atomicMax), then h quantized with the final row
  scale in a row pass;
- K2 (both pack modes) and K10 (csrc/mips_sweep.cu) and, on integers, K6
  (csrc/mips_int8.cu): the epilogue of csrc/sweep_epi.cuh on wgmma's
  accumulator layout, a thread's column pair reduced in registers, then
  two shuffle steps inside a quad with the argmaxes sent as bits;
- K9 (csrc/mips_top2.cu): a strict '>' chain over a thread's 16 values of
  each 64-row block, keeping (best, second, arg), then two shuffle steps
  inside a quad that merge the blocks' statistics, args sent as 6 bits.

Each is held against the port's plain version (bit for bit) and the JAX
package's Pallas kernel in interpret mode, on the same numpy inputs."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cocodr_tpu.ops import int8_matmul as jq
from cocodr_tpu.ops.pallas_ffn import fused_ffn_block_int8 as jax_k7
from cocodr_tpu.ops.pallas_mips import (
    _dual_sweep_mixed,
    _int8_sweep,
    _top2_sweep,
    blockmax_sweep_pallas,
)
from cocodr_tpu_torch.ops import ffn as tffn
from cocodr_tpu_torch.ops import int8_matmul as tq
from cocodr_tpu_torch.ops import mips_blockmax, mips_exact2, mips_hier, mips_int8

torch.set_num_threads(1)


# --- K7 -----------------------------------------------------------------

def quantize(x, s):
    """clip(rint(x / s), -127, 127) with row scales s [T, 1]."""
    return torch.round(x / s).clamp(-127, 127).to(torch.int8)


def row_scale(maxabs):
    return maxabs.clamp_min(1e-30) / 127.0


def k7_schedule(r, s1, c1, w1q, sw1, b1, w2q, sw2, b2, s2, c2, tile, eps,
                act="gelu"):
    """K7's launches: LN1 + quantize; the up GEMM by column tiles of
    `tile` (the last one ragged), in reverse order, each writing its h and
    folding its row max into hmax; the quantize pass with the final
    scales; the down GEMM with the residual; LN2."""
    u32 = tffn.layer_norm_f32(r.float(), s1, c1, eps)
    su = row_scale(u32.abs().amax(1, keepdim=True))
    uq = quantize(u32, su)
    T, F = uq.shape[0], w1q.shape[0]
    h = torch.empty(T, F)
    hmax = torch.zeros(T)
    for n0 in reversed(range(0, F, tile)):
        cols = slice(n0, n0 + tile)
        acc = tq.int8_matmul(uq, w1q[cols]).float()
        ht = tffn.activation(act)(acc * (su * sw1[cols][None, :])
                                  + b1[cols][None, :])
        h[:, cols] = ht
        hmax = torch.maximum(hmax, ht.abs().amax(1))
    sh = row_scale(hmax)[:, None]
    hq = quantize(h, sh)
    y = tq.int8_matmul(hq, w2q).float() * (sh * sw2[None, :])
    z32 = u32 + y + b2[None, :]
    return tffn.layer_norm_f32(z32, s2, c2, eps).to(r.dtype)


def _k7_inputs(T, H, F, seed):
    rng = np.random.RandomState(seed)
    f = np.float32
    return dict(
        r=rng.randn(T, H).astype(f),
        s1=(1 + 0.1 * rng.randn(H)).astype(f), c1=(0.1 * rng.randn(H)).astype(f),
        w1=(0.1 * rng.randn(H, F)).astype(f), b1=(0.1 * rng.randn(F)).astype(f),
        w2=(0.1 * rng.randn(F, H)).astype(f), b2=(0.1 * rng.randn(H)).astype(f),
        s2=(1 + 0.1 * rng.randn(H)).astype(f), c2=(0.1 * rng.randn(H)).astype(f),
    )


@pytest.mark.parametrize("T,H,F,tile", [
    (32, 128, 256, 128),   # F a multiple of the tile
    (32, 128, 384, 256),   # F not a multiple: a ragged last tile
    (24, 256, 640, 192),   # wider H, a ragged last tile
])
def test_k7_schedule_matches_plain_and_pallas(T, H, F, tile):
    """float32 r, the JAX package's quantized weights (transposed to
    nn.Linear layout). The schedule equals ffn_block_int8_reference bit for
    bit: int8 sums are exact and a row max does not depend on the order of
    the tiles, so quantizing after the last tile with the final scale gives
    the plain version's integers.
    Against the Pallas kernel in interpret mode, 2e-5 as
    test_torch_int8.py::test_plain_k7_matches_pallas_kernel (LayerNorm
    statistics and float32 sums in another order, and the kernel's A&S erf
    polynomial against erf)."""
    x = _k7_inputs(T, H, F, seed=T + F)
    w1q, sw1 = jq.quantize_cols(jnp.asarray(x["w1"]))
    w2q, sw2 = jq.quantize_cols(jnp.asarray(x["w2"]))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    args = (t(x["r"]), t(x["s1"]), t(x["c1"]), t(np.asarray(w1q).T),
            t(np.asarray(sw1)[0]), t(x["b1"]), t(np.asarray(w2q).T),
            t(np.asarray(sw2)[0]), t(x["b2"]), t(x["s2"]), t(x["c2"]))
    got = k7_schedule(*args, tile=tile, eps=1e-12)
    want = tffn.ffn_block_int8_reference(*args)
    assert torch.equal(got, want)
    pallas = jax_k7(jnp.asarray(x["r"]), jnp.asarray(x["s1"]),
                    jnp.asarray(x["c1"]), w1q, sw1[0], jnp.asarray(x["b1"]),
                    w2q, sw2[0], jnp.asarray(x["b2"]), jnp.asarray(x["s2"]),
                    jnp.asarray(x["c2"]), token_tile=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=2e-5,
                               rtol=2e-5)


# --- K2 and K10 ---------------------------------------------------------

ROWS, BN = 64, 256  # a consumer warpgroup's rows, a sweep block's columns


def accumulator_layout(scores):
    """[64, BN] scores -> d [4 warps, 32 lanes, BN / 2] as wgmma m64nBN
    leaves them: lane l of warp w holds rows 16w + l/4 and 16w + l/4 + 8,
    d[4j + 2h + e] = row (16w + l/4 + 8h), column 8j + 2(l % 4) + e."""
    w = np.arange(4)[:, None, None, None, None]
    lane = np.arange(32)[None, :, None, None, None]
    j = np.arange(BN // 8)[None, None, :, None, None]
    h = np.arange(2)[None, None, None, :, None]
    e = np.arange(2)[None, None, None, None, :]
    rows = 16 * w + lane // 4 + 8 * h
    cols = 8 * j + 2 * (lane % 4) + e
    return scores[rows, cols].reshape(4, 32, BN // 2)


LANE = np.arange(32)
QUAD_C = LANE % 4  # c: this lane's column pair in each 8-column group


def shfl_xor(x, m):
    """__shfl_xor_sync over the lanes axis (1) of [4, 32, ...]."""
    return x[:, LANE ^ m]


def scatter_step(v, step):
    """mips_sweep.cu::scatter_step: keep half of v, max with the partner's."""
    half = v.shape[-1] >> 1
    upper = ((QUAD_C >> step) & 1).astype(bool)[None, :, None]
    ov = shfl_xor(np.where(upper, v[..., :half], v[..., half:]), 1 << step)
    return np.maximum(np.where(upper, v[..., half:], v[..., :half]), ov)


def scatter_arg_step(v, a, step):
    """mips_sweep.cu::scatter_arg_step: the partner's argmaxes arrive as
    1 (step 0) or 2 (step 1) bits an entry, all in one word."""
    half = v.shape[-1] >> 1
    width = step + 1
    mask = (1 << width) - 1
    upper = ((QUAD_C >> step) & 1).astype(bool)[None, :, None]
    send_a = np.where(upper, a[..., :half], a[..., half:])
    shift = (width * np.arange(half)).astype(np.uint32)
    bits = ((send_a & mask).astype(np.uint32) << shift).sum(-1, dtype=np.uint32)
    bits = shfl_xor(bits, 1 << step)
    c = QUAD_C[None, :, None]
    base = (c ^ 1) << 1 if step == 0 else ((c ^ 2) >> 1) << 2
    ov = shfl_xor(np.where(upper, v[..., :half], v[..., half:]), 1 << step)
    oa = base | ((bits[..., None] >> shift) & mask).astype(np.int64)
    kv = np.where(upper, v[..., half:], v[..., :half])
    ka = np.where(upper, a[..., half:], a[..., :half])
    take = (ov > kv) | ((ov == kv) & (oa < ka))
    return np.where(take, ov, kv), np.where(take, oa, ka)


def pack3(v, a):
    """sweep_epi.cuh::pack3: float32 bits (bits & ~7) | a, int (v << 3) | a."""
    if v.dtype == np.int32:
        return (v << 3) | a.astype(np.int32)
    return ((v.view(np.int32) & ~7) | a.astype(np.int32)).view(np.float32)


def sweep_epilogue(scores, mode):
    """SweepEpi<mode, T>::tile over a [64, 256] score tile (float32 or
    int32) -> (fine [64, 32], coarse [64, 4]) for "max" and "pack", or
    blocks [64, 8] for "block32", assembled from what each lane stores."""
    d = accumulator_layout(scores)
    w = np.arange(4)[:, None]
    b0, b1 = QUAD_C & 1, QUAD_C >> 1
    if mode == "block32":
        outs = (np.zeros((ROWS, BN // 32), scores.dtype),)
    else:
        outs = (np.zeros((ROWS, BN // 8), scores.dtype),
                np.zeros((ROWS, BN // 64), scores.dtype))
    for h in range(2):
        rows = 16 * w + LANE[None, :] // 4 + 8 * h  # [4, 32]
        x0, x1 = d[..., 2 * h::4], d[..., 2 * h + 1::4]  # [4, 32, 32]
        if mode == "block32":
            v = np.maximum(x0, x1).reshape(4, 32, 8, 4).max(-1)
            v = scatter_step(scatter_step(v, 0), 1)  # blocks 4 b0 + 2 b1 + i
            for i in range(2):
                outs[0][rows, (4 * b0 + 2 * b1)[None, :] + i] = v[..., i]
            continue
        second = x1 > x0
        v = np.where(second, x1, x0)
        a = 2 * QUAD_C[None, :, None] + second
        if mode == "pack":
            for step in range(2):
                v, a = scatter_arg_step(v, a, step)
            v = pack3(v, a)
        else:
            v = scatter_step(scatter_step(v, 0), 1)
        j0 = 16 * b0 + 8 * b1  # this lane's first fine block: one coarse
        for i in range(8):
            outs[0][rows, j0[None, :] + i] = v[..., i]
        outs[1][rows, j0[None, :] // 8] = v.max(-1)
    return outs


def _integer_sweep_inputs(seed, D=16):
    """Small integers (scores exact in every summation order) with rows
    repeated inside each fine block: rows 0 and 1 (one lane's pair) and
    rows 3 and 6 (two lanes of a quad), so that equal maxima meet at both
    levels of the reduction, besides the ties of random small integers."""
    rng = np.random.RandomState(seed)
    q = rng.randint(-2, 3, (ROWS, D)).astype(np.float32)
    c = rng.randint(-2, 3, (BN, D)).astype(np.float32)
    c[1::8] = c[0::8]
    c[6::8] = c[3::8]
    return q, c


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["max", "pack", "block32"])
def test_sweep_epilogue_on_accumulator_layout(mode, seed):
    """The epilogue's maxima and packed first-occurrence argmaxes equal
    dual_sweep_reference (pack False / True) or block_sweep_reference
    exactly, and the Pallas sweeps in interpret mode exactly (integer
    scores: no summation order shows)."""
    q, c = _integer_sweep_inputs(seed)
    got = sweep_epilogue(q @ c.T, mode)
    tq_, tc = torch.from_numpy(q), torch.from_numpy(c)
    if mode == "block32":
        want = (mips_blockmax.block_sweep_reference(tq_, tc).numpy(),)
        pallas = (np.asarray(blockmax_sweep_pallas(
            jnp.asarray(q), jnp.asarray(c), tile=BN, block=32, q_tile=8,
            interpret=True)),)
    else:
        pack = mode == "pack"
        want = tuple(x.numpy() for x in mips_hier.dual_sweep_reference(
            tq_, tc, pack=pack))
        fj, cj = _dual_sweep_mixed(jnp.asarray(q), jnp.asarray(c), tile=BN,
                                   fine=8, coarse=8, q_tile=8,
                                   interpret=True, pack=pack)
        pallas = (np.asarray(fj), np.asarray(cj).T)
    for g, w, p in zip(got, want, pallas):
        assert g.shape == w.shape == p.shape
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
        np.testing.assert_array_equal(g.view(np.int32), p.view(np.int32))
    if mode == "pack":
        # ties were decided: some blocks' argmax is not the last row
        assert (got[0].view(np.int32) & 7).max() > 0


# --- K6 and K9 ----------------------------------------------------------

# float32 sums of exact bf16 products, taken in another order than XLA's
# (as tests/test_torch_search.py)
TOL = 2e-6


def _repeat_rows(c):
    """Repeated corpus rows in every 64-row block: rows 0 and 1 of each
    fine block (one lane's pair), rows 3 and 6 (two lanes of a quad), and
    rows 5 and 18 (lanes 2 and 1, which end up holding different 64-row
    blocks in K9's scatter)."""
    c[1::8] = c[0::8]
    c[6::8] = c[3::8]
    c[18::64] = c[5::64]
    return c


def scatter_top2_step(b, s, a, step):
    """mips_top2.cu::scatter_top2_step: send half of the blocks' (best,
    second, arg) to the partner, args as 6 bits an entry in one word, and
    merge the kept half with what arrives."""
    half = b.shape[-1] >> 1
    upper = ((QUAD_C >> step) & 1).astype(bool)[None, :, None]

    def send(x):
        return np.where(upper, x[..., :half], x[..., half:])

    def keep(x):
        return np.where(upper, x[..., half:], x[..., :half])

    shift = (6 * np.arange(half)).astype(np.uint32)
    bits = (send(a).astype(np.uint32) << shift).sum(-1, dtype=np.uint32)
    oa = ((shfl_xor(bits, 1 << step)[..., None] >> shift) & 63).astype(
        np.int64)
    ob, os_ = shfl_xor(send(b), 1 << step), shfl_xor(send(s), 1 << step)
    kb, ks, ka = keep(b), keep(s), keep(a)
    gt = ob > kb
    second = np.where(gt, np.maximum(kb, os_), np.maximum(ks, ob))
    take = gt | ((ob == kb) & (oa < ka))
    return np.where(take, ob, kb), second, np.where(take, oa, ka)


def top2_epilogue(scores):
    """Top2Epi::tile over a [64, 256] float32 score tile -> (best [64, 4],
    pack [64, 4]), assembled from what each lane stores."""
    d = accumulator_layout(scores)
    w = np.arange(4)[:, None]
    c = QUAD_C[None, :, None]
    best = np.zeros((ROWS, BN // 64), np.float32)
    pack = np.zeros((ROWS, BN // 64), np.float32)
    for h in range(2):
        rows = 16 * w + LANE[None, :] // 4 + 8 * h  # [4, 32]
        # x[..., blk, k]: column 8 (k >> 1) + 2c + (k & 1) of block blk
        x = d.reshape(4, 32, 4, 8, 4)[..., 2 * h:2 * h + 2].reshape(
            4, 32, 4, 16)
        b, s = x[..., 0], np.full(x.shape[:-1], -np.inf, np.float32)
        a = np.broadcast_to(2 * c, b.shape)
        for k in range(1, 16):
            v = x[..., k]
            gt = v > b
            s = np.where(gt, b, np.maximum(s, v))
            a = np.where(gt, 8 * (k >> 1) + 2 * c + (k & 1), a)
            b = np.where(gt, v, b)
        for step in range(2):
            b, s, a = scatter_top2_step(b, s, a, step)
        blk = (2 * (QUAD_C & 1) + (QUAD_C >> 1))[None, :]
        best[rows, blk] = b[..., 0]
        pack[rows, blk] = ((s[..., 0].view(np.int32) & ~63)
                           | a[..., 0].astype(np.int32)).view(np.float32)
    return best, pack


def _pallas_top2(q, c):
    bj, pj = _top2_sweep(jnp.asarray(q), jnp.asarray(c), tile=BN, cb=64,
                         q_tile=8, interpret=True)
    return np.asarray(bj)[:, :ROWS].T, np.asarray(pj)[:, :ROWS].T


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("value_range", [2, 127])
def test_int8_epilogue_on_accumulator_layout(value_range, seed):
    """K6: K2-packed's epilogue on int32 scores (the integer pack
    (max << 3) | arg) equals int8_sweep_reference and the Pallas int8
    sweep in interpret mode bit for bit: integer sums are exact in every
    order. int8 inputs in [-value_range, value_range], D = 192 (half of
    the kernel's last 128-column stage), rows repeated as _repeat_rows."""
    rng = np.random.RandomState(seed)
    D = 192
    q = rng.randint(-value_range, value_range + 1, (ROWS, D)).astype(np.int8)
    c = _repeat_rows(rng.randint(-value_range, value_range + 1,
                                 (BN, D)).astype(np.int8))
    got = sweep_epilogue(q.astype(np.int32) @ c.astype(np.int32).T, "pack")
    want = mips_int8.int8_sweep_reference(torch.from_numpy(q),
                                          torch.from_numpy(c))
    fj, cj = _int8_sweep(jnp.asarray(q), jnp.asarray(c), tile=BN, fine=8,
                         coarse=8, q_tile=8, interpret=True)
    for g, w, p in zip(got, want, (np.asarray(fj), np.asarray(cj).T)):
        assert g.dtype == np.int32 and g.shape == w.shape == p.shape
        np.testing.assert_array_equal(g, w.numpy())
        np.testing.assert_array_equal(g, p)
    # rows 0 and 1 of a fine block are equal: where they hold its max,
    # the first occurrence (arg 0) won over the partner's column
    tie = (q.astype(np.int32) @ c[0::8].astype(np.int32).T
           == (got[0] >> 3))
    assert tie.any() and ((got[0] & 7)[tie] == 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_top2_epilogue_integer_scores_bit_equal(seed):
    """K9 on small integers (scores exact in every summation order) with
    rows repeated as _repeat_rows: best and the packed second with its
    first-occurrence argmax equal top2_sweep_reference and the Pallas
    kernel in interpret mode bit for bit."""
    rng = np.random.RandomState(seed)
    q = rng.randint(-2, 3, (ROWS, 16)).astype(np.float32)
    c = _repeat_rows(rng.randint(-2, 3, (BN, 16)).astype(np.float32))
    got = top2_epilogue(q @ c.T)
    want = mips_exact2.top2_sweep_reference(torch.from_numpy(q),
                                            torch.from_numpy(c))
    for g, w, p in zip(got, want, _pallas_top2(q, c)):
        assert g.shape == w.shape == p.shape == (ROWS, BN // 64)
        np.testing.assert_array_equal(g.view(np.int32),
                                      w.numpy().view(np.int32))
        np.testing.assert_array_equal(g.view(np.int32), p.view(np.int32))
    # ties were decided: equal maxima (second == best) with an argmax past
    # row 0, so the first occurrence had to win a merge
    best, pack = got
    second = (pack.view(np.int32) & ~63).view(np.float32)
    assert ((second == best) & ((pack.view(np.int32) & 63) > 0)).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_top2_epilogue_float_scores(seed):
    """K9 on normal float inputs: fed the plain version's scores, the
    epilogue equals top2_sweep_reference bit for bit (the chain and the
    merges select, they do not round). Against the Pallas kernel in
    interpret mode (float32 sums in XLA's order): best and the second with
    its 6 low bits cleared within TOL, the packed argmax equal wherever the
    block's best and second differ by more than TOL."""
    rng = np.random.RandomState(10 + seed)
    q = rng.randn(ROWS, 32).astype(np.float32)
    c = rng.randn(BN, 32).astype(np.float32)
    tq_, tc = torch.from_numpy(q), torch.from_numpy(c)
    got = top2_epilogue(mips_hier.scores(tq_, tc).numpy())
    want = [x.numpy() for x in mips_exact2.top2_sweep_reference(tq_, tc)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    best, pack = got
    pb, pp = _pallas_top2(q, c)
    np.testing.assert_allclose(best, pb, atol=TOL, rtol=TOL)

    def cleared(x):
        return (x.view(np.int32) & ~63).view(np.float32)

    np.testing.assert_allclose(cleared(pack), cleared(pp), atol=TOL,
                               rtol=TOL)
    decided = pb - cleared(pp) > TOL
    assert decided.mean() > 0.9
    np.testing.assert_array_equal((pack.view(np.int32) & 63)[decided],
                                  (pp.view(np.int32) & 63)[decided])
