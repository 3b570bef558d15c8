"""K3's radix select (cocodr_tpu_torch/csrc/topk.cu), emulated on the CPU:

- order-preserving uint32 keys (float32: negative values with all bits
  flipped, the others with the sign bit flipped, -0.0 first mapped to
  +0.0; int32: the sign bit flipped);
- MSB-first passes over 8-bit digits, each a 256-bin histogram of the keys
  above key(neg) that match the digits found so far, the digit found by one
  warp's scan from bin 255 down, and a stop once the digit's bin holds
  exactly the entries still needed;
- the gather: every key above the threshold in any order, the keys equal to
  it in index order by the kernel's ordered compaction (per-thread counts of
  4 entries, warp scans, a scan over the warps' totals of each round);
- after the first digit, the entries of its bin and above in a list (at
  most LIST_CAP, rows from LIST_MIN_WIDTH wide), which the later passes
  and the gather read instead of the row; a row of at most
  min(RANK_MAX, threads a row) entries above neg skips the digits;
- the order: by counting (at most RANK_MAX candidates) or the kernel's
  bitonic network, in segments of at most MAX_CAND candidates;
- the tail rule: with m < k entries above neg, (neg, j*) after them, or
  (x[0], 0) then (neg, 0) when every entry is -inf and the row has no pad.

Each is held bit for bit against the port's plain version and the JAX
package's Pallas kernel in interpret mode, on the same numpy inputs."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
import torch

from cocodr_tpu.ops.pallas_mips import pallas_topk
from cocodr_tpu_torch.ops import mips_hier

torch.set_num_threads(1)

# the kernel's kMaxCand, kRankMax, kListCap and kListMinWidth
MAX_CAND, RANK_MAX, LIST_CAP, LIST_MIN_WIDTH = 2048, 128, 1024, 2048
FULL = np.uint64(2 ** 64 - 1)


def keys_of(x):
    """The kernel's order-preserving keys of a float32 or int32 array."""
    u = x.view(np.uint32).copy()
    if x.dtype == np.float32:
        u[u == 0x80000000] = 0
        return u ^ np.where(u >> 31, np.uint32(0xFFFFFFFF),
                            np.uint32(0x80000000)).astype(np.uint32)
    return u ^ np.uint32(0x80000000)


def key_neg(dtype):
    """key(finfo(float32).min) or key(iinfo(int32).min)."""
    neg = (np.finfo(np.float32).min if dtype == np.float32
           else np.iinfo(np.int32).min)
    return int(keys_of(np.array([neg], dtype))[0])


def composite(keys, idx):
    """(key << 32) | (0x7fffffff - index): larger comes first."""
    return ((keys.astype(np.uint64) << np.uint64(32))
            | (np.uint64(0x7FFFFFFF) - idx.astype(np.uint64)))


def find_digit(hist, want):
    """One warp's scan: lane l sums bins 255 - 8l .. 248 - 8l, an
    inclusive scan over the lanes, then the lane whose range reaches want
    walks its bins. -> (digit, entries in higher bins, entries in it)."""
    c = hist[::-1].reshape(32, 8)  # lane l holds bins 255 - 8l - i
    incl = np.cumsum(c.sum(1))
    lane = int(np.searchsorted(incl, want))  # first lane with incl >= want
    acc = int(incl[lane] - c[lane].sum())
    for i in range(8):
        if acc + c[lane, i] >= want:
            return 255 - 8 * lane - i, acc, int(c[lane, i])
        acc += int(c[lane, i])
    raise AssertionError("want above the histogram's total")


def ordered_compaction(flags, rem, group):
    """The kernel's index-ordered compaction of the flagged entries of a
    row, G = group threads a row, 4 consecutive entries a thread and round:
    -> the positions of the first rem flagged entries, each at its rank."""
    Wp = flags.size
    step = 4 * group
    rounds = -(-Wp // step)
    f = np.zeros(rounds * step, bool)
    f[:Wp] = flags
    f = f.reshape(rounds, group // 32, 32, 4)  # round, warp, lane, entry
    ne = f.sum(3)
    warp_incl = np.cumsum(ne, 2)
    cnt = warp_incl[:, :, -1].reshape(-1)  # warp totals, (round, warp) order
    cnt_excl = (np.cumsum(cnt) - cnt).reshape(rounds, group // 32)
    out = np.full(rem, -1)
    for r, w, lane, e in zip(*np.nonzero(f)):
        rank = (cnt_excl[r, w] + warp_incl[r, w, lane] - ne[r, w, lane]
                + f[r, w, lane, :e].sum())
        if rank < rem:
            out[rank] = ((r * (group // 32) + w) * 32 + lane) * 4 + e
    return out


def bitonic_descending(a):
    """The kernel's bitonic network on a power-of-two array."""
    a = a.copy()
    P = a.size
    half = np.arange(P // 2)
    size = 2
    while size <= P:
        stride = size // 2
        while stride:
            lo = 2 * half - (half & (stride - 1))
            x, y = a[lo], a[lo + stride]
            swap = (x < y) == ((lo & size) == 0)
            a[lo[swap]], a[lo[swap] + stride] = y[swap], x[swap]
            stride //= 2
        size *= 2
    return a


def radix_topk(x, k, group=256, max_cand=MAX_CAND, rank_max=RANK_MAX,
               list_cap=LIST_CAP, seed=0):
    """The kernel's algorithm on a [Q, W] float32 or int32 array, row by
    row. -> (vals, ids int32). Unordered gathers are shuffled: the order of
    the kernel's atomics is not the result's."""
    rng = np.random.RandomState(seed)
    Q, W = x.shape
    if not 1 <= k <= W:
        raise ValueError(k)
    Wp = -(-W // 128) * 128
    kneg = key_neg(x.dtype)
    neg = x.dtype.type(np.finfo(np.float32).min if x.dtype == np.float32
                       else np.iinfo(np.int32).min)
    P = max(1 << (min(k, max_cand) - 1).bit_length(), rank_max)
    vals = np.empty((Q, k), x.dtype)
    ids = np.empty((Q, k), np.int32)
    for row in range(Q):
        keys = np.full(Wp, kneg, np.uint32)
        keys[:W] = keys_of(x[row])
        idx = np.arange(Wp)
        comp = composite(keys, idx)
        above = keys > kneg
        ge = np.nonzero(keys >= kneg)[0]  # pad slots included
        kk = min(k, int(above.sum()))
        emitted, bound = 0, FULL
        while emitted < kk:
            in_r = above & (comp < bound)
            want = min(kk - emitted, max_cand)
            prefix, rem, n_cand, eq, lo = 0, want, want, False, 0
            pool = in_r  # the row, or the list after the first digit
            for shift in (24, 16, 8, 0):
                sel = pool if shift == 24 else (
                    pool & ((keys >> np.uint32(shift + 8)) == prefix))
                hist = np.bincount((keys[sel] >> np.uint32(shift)) & 255,
                                   minlength=256)
                if (emitted == 0 and shift == 24
                        and sel.sum() <= min(rank_max, group)):
                    n_cand = int(sel.sum())  # order all m, one a thread
                    break
                d, higher, hd = find_digit(hist, rem)
                rem -= higher
                prefix = (prefix << 8) | d
                if hd == rem:  # every entry of the bin is needed
                    lo = prefix << shift
                    break
                if shift == 0:
                    lo, eq = prefix + 1, True
                elif (shift == 24 and Wp >= LIST_MIN_WIDTH
                      and want - rem + hd <= list_cap):
                    pool = in_r & ((keys >> np.uint32(24)) >= d)
                    assert pool.sum() == want - rem + hd
            take = np.nonzero(pool & (keys.astype(np.int64) >= lo))[0]
            rng.shuffle(take)
            cand = np.zeros(P, np.uint64)
            cand[:take.size] = comp[take]
            if eq:
                assert take.size == want - rem
                pos = ordered_compaction(in_r & (keys == prefix), rem, group)
                cand[want - rem:want] = comp[pos]
            else:
                assert take.size == n_cand
            if n_cand <= rank_max:
                c = cand[:n_cand]
                rank = (c[None, :] > c[:, None]).sum(1)
                order = np.empty(n_cand, np.uint64)
                order[rank] = c
                order = order[:want]
            else:
                order = bitonic_descending(cand)[:want]
                bound = order[-1]
            j = (np.uint64(0x7FFFFFFF) - (order & np.uint64(0xFFFFFFFF))
                 ).astype(np.int64)
            vals[row, emitted:emitted + want] = x[row, j]
            ids[row, emitted:emitted + want] = j
            emitted += want
        if emitted < k:  # the tail rule
            if ge.size:
                vals[row, emitted:], ids[row, emitted:] = neg, ge[0]
            else:  # every entry -inf, no pad slot
                vals[row, emitted], ids[row, emitted] = x[row, 0], 0
                vals[row, emitted + 1:], ids[row, emitted + 1:] = neg, 0
    return vals, ids


def assert_same(x, k, **kw):
    """The emulation against the plain version and the Pallas kernel:
    ids equal, values equal as bits wherever they lie above the
    sentinel, and as values (+0.0 == -0.0) everywhere."""
    ev, ei = radix_topk(x, k, **kw)
    tv, ti = mips_hier.topk_reference(torch.from_numpy(x), k)
    jv, ji = pallas_topk(jnp.asarray(x), k, interpret=True)
    np.testing.assert_array_equal(ei, ti.numpy())
    np.testing.assert_array_equal(ei, np.asarray(ji))
    np.testing.assert_array_equal(ev, tv.numpy())
    np.testing.assert_array_equal(ev, np.asarray(jv))
    real = ev > (np.finfo(np.float32).min if x.dtype == np.float32
                 else np.iinfo(np.int32).min)
    own = np.take_along_axis(x, np.minimum(ei, x.shape[1] - 1), 1)
    np.testing.assert_array_equal(ev.view(np.int32)[real],
                                  own.view(np.int32)[real])


# --- keys ---------------------------------------------------------------

def test_float_keys_preserve_order_and_tie_zeros():
    """Sorting by key sorts by value; +0.0 and -0.0 share a key; -inf and
    every value below finfo.min's key lie at or below it, denormals in
    place."""
    f = np.float32
    special = np.array([-np.inf, np.finfo(f).min, -1.0, -1e-45, -0.0, 0.0,
                        1e-45, 1e-38, 1.0, np.finfo(f).max, np.inf], f)
    x = np.concatenate([special,
                        np.random.RandomState(0).randn(500).astype(f)])
    k = keys_of(x)
    order = np.argsort(k, kind="stable")
    assert np.all(np.diff(x[order]) >= 0)
    assert keys_of(np.array([-0.0], f))[0] == keys_of(np.array([0.0], f))[0]
    assert key_neg(np.float32) == 0x00800000
    assert keys_of(np.array([-np.inf], f))[0] < key_neg(np.float32)
    assert len(set(k.tolist())) == len(set(x.tolist()))  # ±0 as one value


def test_int_keys_preserve_order():
    i = np.iinfo(np.int32)
    x = np.concatenate([np.array([i.min, i.min + 1, -1, 0, 1, i.max],
                                 np.int32),
                        np.random.RandomState(1).randint(
                            i.min, i.max, 500, dtype=np.int64)
                        .astype(np.int32)])
    order = np.argsort(keys_of(x), kind="stable")
    assert np.all(np.diff(x[order].astype(np.int64)) >= 0)
    assert key_neg(np.int32) == 0


# --- the algorithm against the plain version and Pallas ---------------------

def _case(name):
    """The six cases of tests/test_torch_mips.py, then rows of ±0 ties,
    INT_MIN, k = W, an all -inf row without a pad slot, and small-width
    versions of the search's shapes."""
    rng = np.random.RandomState(2)
    f = np.float32
    if name == "f32":
        return rng.randn(9, 300).astype(f), 17
    if name == "i32":
        return rng.randint(-1000, 1000, (9, 260)).astype(np.int32), 12
    if name == "ties":
        return rng.randint(0, 4, (6, 200)).astype(f), 30
    if name == "ties_i32":
        return rng.randint(0, 3, (6, 256)).astype(np.int32), 40
    if name == "neg_inf":
        x = rng.randn(5, 300).astype(f)
        x[:, 10] = x[:, 20] = 5.0
        x[2, :] = -np.inf
        x[3, 5:] = -np.inf
        return x, 8
    if name == "finfo_min":
        x = rng.randn(4, 128).astype(f)
        x[:, ::2] = np.finfo(f).min
        return x, 70
    if name == "zeros":  # +0.0 and -0.0 tie: lowest index first
        x = np.where(rng.rand(6, 300) < 0.5, f(0.0), f(-0.0)).astype(f)
        x[:, ::7] = 1.0
        x[1, :] = -0.0
        return x, 120
    if name == "int_min":
        x = rng.randint(-3, 3, (6, 300)).astype(np.int32)
        x[x == -3] = np.iinfo(np.int32).min
        x[:, 1::11] = np.iinfo(np.int32).max
        x[2, :] = np.iinfo(np.int32).min
        return x, 150
    if name == "k_eq_w":
        return rng.randn(4, 200).astype(f), 200
    if name == "all_neg_inf_no_pad":
        x = np.full((3, 256), -np.inf, f)
        x[1, 40] = 2.0
        return x, 9
    if name == "super":
        return rng.randn(8, 2048).astype(f), 100
    if name == "fine":
        return rng.randn(4, 6400).astype(f), 100
    if name == "rescore":
        return rng.randn(8, 800).astype(f), 100
    if name == "int8_packed":
        return (rng.randn(8, 2048) * 2 ** 24).astype(np.int32), 100
    if name == "exact2_slots":
        x = rng.randn(8, 100).astype(f)
        x[:, rng.rand(100) < 0.7] = -1e38  # unflagged blocks tie
        return x, 6
    if name == "exact2_merge":
        x = rng.randn(8, 484).astype(f)
        x[:, 100:130] = -np.inf
        return x, 100
    if name == "k_1000":
        return rng.randn(2, 1200).astype(f), 1000
    raise KeyError(name)


CASES = ["f32", "i32", "ties", "ties_i32", "neg_inf", "finfo_min", "zeros",
         "int_min", "k_eq_w", "all_neg_inf_no_pad", "super", "fine",
         "rescore", "int8_packed", "exact2_slots", "exact2_merge", "k_1000"]


@pytest.mark.parametrize("case", CASES)
def test_radix_select_matches_plain_and_pallas(case):
    """Bit for bit (no tolerance): the kernel's algorithm reproduces the
    extract-max rounds, tie order and sentinel."""
    x, k = _case(case)
    assert_same(x, k)


@pytest.mark.parametrize("group", [32, 256])
@pytest.mark.parametrize("case", ["ties", "ties_i32", "zeros", "int_min"])
def test_ordered_compaction_by_group(case, group):
    """Ties at the threshold keep the lowest indices whatever the threads a
    row: one warp (rows up to 512 wide) or a block of 256."""
    x, k = _case(case)
    assert_same(x, k, group=group)


@pytest.mark.parametrize("case", ["f32", "ties", "int_min", "k_eq_w"])
def test_segments_and_bitonic_order(case):
    """More candidates than a segment holds: with MAX_CAND = 16 and
    RANK_MAX = 4, rows go in segments of 16, each ordered by the bitonic
    network and bounded by the last composite written; every pass reads
    the row (no list)."""
    x, k = _case(case)
    assert_same(x, k, max_cand=16, rank_max=4, list_cap=0)


def test_ordered_compaction_keeps_index_order():
    rng = np.random.RandomState(3)
    for group in (32, 256):
        flags = rng.rand(1536) < 0.3
        want = np.nonzero(flags)[0]
        np.testing.assert_array_equal(
            ordered_compaction(flags, 100, group), want[:100])


def test_bitonic_network_sorts_descending():
    a = np.random.RandomState(4).randint(0, 2 ** 40, 256).astype(np.uint64)
    np.testing.assert_array_equal(bitonic_descending(a), np.sort(a)[::-1])


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_tie_heavy_rows_property(data):
    """Rows drawn from a few values (ties, ±0, the sentinel, -inf, or the
    int32 extremes) at any width and k: the emulation equals the plain
    version bit for bit."""
    is_int = data.draw(st.booleans())
    W = data.draw(st.integers(1, 300))
    k = data.draw(st.integers(1, W))
    Q = data.draw(st.integers(1, 3))
    if is_int:
        i = np.iinfo(np.int32)
        pool = np.array([i.min, i.min + 1, -1, 0, 1, 2, i.max], np.int32)
    else:
        f = np.float32
        pool = np.array([-np.inf, np.finfo(f).min, -1e38, -1.0, -0.0, 0.0,
                         1.0, 2.0], f)
    picks = data.draw(st.lists(st.integers(0, pool.size - 1),
                               min_size=Q * W, max_size=Q * W))
    x = pool[np.array(picks)].reshape(Q, W)
    ev, ei = radix_topk(x, k, group=data.draw(st.sampled_from([32, 256])),
                        max_cand=data.draw(st.sampled_from([8, MAX_CAND])),
                        rank_max=4)
    tv, ti = mips_hier.topk_reference(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ei, ti.numpy())
    np.testing.assert_array_equal(ev, tv.numpy())
