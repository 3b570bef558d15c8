#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cocodr_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases, each printed with its elapsed seconds:
  1. environment: torch and CUDA versions, the card's name and power limit;
     fails when CUDA is not available;
  2. build: nvcc compiles cocodr_tpu_torch/csrc/*.cu for sm_90a;
  3. kernel checks: each kernel against its plain PyTorch version on the
     card, with its time, the plain version's time, the time of one
     library call that computes the same function where there is one, and
     the least time the card could take (all but K3 by loops of
     back-to-back launches, K3 and K8 in turns with torch.topk and
     scaled_dot_product_attention): K1 fused FFN half-layer (serving
     and encode shapes; checked also at T = 64 and ragged T at bert-base
     and bert-large widths) and K2 dual block-max sweep at the serving
     shapes; K3 radix-select top-k at every shape of its paths (the
     search's at Q = 1024, k = 100, float32 and the int8 method's int32, a
     super level at MS MARCO's size, k = 1000, and the serving path's at
     k = 10) and on rows of ties, +-0, INT_MIN, finfo.min and -inf (with
     and without pad slots), k = W, more candidates than one segment holds
     and rows too wide for shared memory, each equal to its plain version
     bit for bit; K4 (K1 at bert-large widths), K7 (W8A8 FFN
     half-layer, T = 64 to 32,768 at bert-base and bert-large widths, its
     launches split by a profiler trace beside torch._int_mm of its GEMMs'
     shapes) and K8 (fused attention, beside scaled_dot_product_attention)
     at the encode shapes, K5 (the FFN of the dropout path) at the training
     shapes; K1 then K7 on weights at one address (the TMA map cache);
     then the sweeps K2 (plain and packed), K6 (int8), K9 (top-2
     certificate) and K10 (block-32) at Q = 64 and Q = 1024 over the
     1,048,576-doc corpus, packed argmaxes held exactly wherever a block's
     top two scores differ by more than the tolerance, all timed by loops
     of launches, beside torch.mm (K2, K9) and torch._int_mm (K6) of the
     sweep's product at Q = 1024; all five also at Q = 1 and 100, on a
     2,048-row corpus, at D = 96 (a k tail; K6 at D = 192, half an int8
     stage), and bit for bit on integer inputs with repeated rows; the
     sweep kernels without a stack frame in nvcc's report;
  4. search: search_topk over 1,024 row-normalised bf16 queries x the
     corpus at k = 100 with each method (pallas, exact2, fast, blockmax,
     refined, naive), plus mips_topk_int8 and mips_topk_blockmax_pallas:
     queries/s and card span of each, and for pallas, fast, exact2 and
     int8 K3's launches a search and its share of the card span (a
     torch.profiler trace); the exact methods equal an exact plain search
     up to near-ties, fast and int8 meet recall@100 bounds;
  5. serve: BERT-base (rdot_nll_condenser, random weights from the seed)
     behind RetrievalService over the same corpus, in the default (exact),
     fast_search, quantize_int8, int8_encode (a matmul_int8 tower, K7) and
     exact_fp32 modes: three batches of 64 queries through search_stream
     and one single query through search, then timed batches; ids checked
     against an exact plain search (exact modes) or their recall@10
     measured (approximate modes);
  6. encode: 32,768 random records of up to 128 tokens written with the
     port's RecordWriter, encoded by encode_cache (body tower, batch 256)
     in five configurations: (a) bert-base bf16, (b) the same with length
     buckets (32, 64, 128), (c) attention_impl="fused" (K8), (d)
     matmul_int8 (K7), (e) bert-large (24 layers) on the first 8,192
     records; docs/s, card span and the host's enqueue time of each; the
     first records of (a), (c), (d) and (e) re-encoded on the CPU through
     the plain versions, and (b), (c), (d) held against (a) by cosine;
  7. train: BM25-warmup training of BERT-base (rdot_nll_condenser, random
     weights from the seed, bf16 compute, batch 64 of 128-token triples of
     hashed words) through run_warmup: with dropout 0.1, every FFN runs K5
     (36 per step); 20 steps saving at 10 and 20, then a second run_warmup
     that resumes from checkpoint-20 to step 25; triplets/s, the card's
     forward, backward and optimizer ms per step beside the host's time
     to issue them, K5's share of the forward, the card's busy share of
     one profiled step, peak memory and the step's bound; then 5 steps
     without
     dropout and with attention_impl="fused" (K1 and K8, 36 per step
     each); then one step at batch 8, dropout off, on the card and on the
     CPU through the plain versions from the same weights, held together
     by the loss and the clipped gradients' cosines.
Every path (the search phase, each serve mode, each encode configuration,
each training run) runs with every kernel's launch count set to 0 just
before it and read just after, and fails if a kernel of the path never
launched or a count differs from the path's own. Then one JSON line of per-kernel numbers,
the card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Any failure raises and the process exits
non-zero; a hang ends at the watchdog with a traceback.
"""
from __future__ import annotations

import faulthandler

faulthandler.dump_traceback_later(1100, exit=True)

import argparse  # noqa: E402
import copy  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
import zlib  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()

# H100 SXM data-sheet peaks (dense): the bound of each kernel is the larger
# of its bytes over the memory rate and its operations over the peak rate
# of their type
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
FP32_OP_PER_S = 67e12

N_DOCS = 1_048_576
DIM = 768
BATCH = 64
QUERY_LEN = 64
TOP_K = 10
SEARCH_Q = 1024  # the mining / evaluation query chunk
SEARCH_K = 100
ENC_DOCS = 32768  # records of the encode phase
ENC_LEN = 128  # their max_len
ENC_BATCH = 256  # the JAX bench's encode batch
ENC_TOKENS = ENC_BATCH * ENC_LEN  # T of the FFN kernels on the encode path
LARGE_DOCS = 8192  # bert-large encodes the first records only
# Limits on the share of outputs where a kernel and its plain version differ
# at all (check_ffn and check_k8 give the readings they separate).
K1_MAX_SHARE = 0.05
K5_MAX_SHARE = 0.05
K7_MAX_SHARE = 0.01
K8_MAX_SHARE = 0.01
TRAIN_BATCH = 64  # triples per step (the warmup preset's large batch)
TRAIN_LEN = 128  # max_seq_len of every tower
TRAIN_T = TRAIN_BATCH * TRAIN_LEN  # T of K5 (one tower's FFN)
TRAIN_STEPS, TRAIN_SAVE, TRAIN_RESUME = 20, 10, 25
NODROP_STEPS = 5
CMP_BATCH = 8  # the card-against-CPU step, at full depth
# card against the CPU's plain versions, one step, dropout off. bf16
# rounding at other places moves the clipped gradients: at BERT-base,
# random weights, on the H100 the global cosine was 0.9936 and the loss
# 1.6% apart; bf16 against float32 on the CPU gives 0.9949, 1.4% and a
# worst tensor of 0.925. With 2 layers the three towers' embeddings
# barely depend on their inputs (loss ~ln 2), the gradient is a
# difference of near-equal terms, and rounding alone took the cosine to
# 0.96. A backward that ignores a kernel's input or differentiates
# another formulation gives cosines of 0.0-0.7, or leaves the global
# cosine near 1 and the worst tensor near 0 (q ignored in K8's
# backward): tests/test_torch_train.py::test_compare_bounds_*.
CMP_LOSS_RTOL = 0.05
CMP_GLOBAL_COSINE = 0.98
CMP_TENSOR_COSINE = 0.8


def phase(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() over `runs` calls, CUDA events around
    each single call (the host's work between the first event and the
    launch counts too: the plain versions are timed so)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# a sleep kernel ahead of a timed loop: ~25 ms at the H100's 1,980 MHz,
# longer than the host takes to issue the loop's launches
SLEEP_CYCLES = 50_000_000


def loop_ms(fn, n: int) -> float:
    """Device time per call of n back-to-back calls of fn between one pair
    of CUDA events. The card sleeps first while the host issues the calls,
    so the events time the card's work alone, with no launch, event or
    host cost between two calls: a kernel of 30 us timed one launch per
    event pair reads mostly those costs."""
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def time_turns(kernel, library, n: int, rounds: int = 3):
    """A kernel and the library call that computes the same function, each
    timed by loop_ms in turns (kernel, library, library, kernel) for
    `rounds` rounds, so that both see the card in the same state ->
    (median kernel ms, median library ms)."""
    for fn in (kernel, library, kernel, library):
        fn()
    torch.cuda.synchronize()
    ks, ls = [], []
    for _ in range(rounds):
        ks.append(loop_ms(kernel, n))
        ls.append(loop_ms(library, n))
        ls.append(loop_ms(library, n))
        ks.append(loop_ms(kernel, n))
    return statistics.median(ks), statistics.median(ls)


def device_ms(fn, n: int) -> float:
    """Median of three loop_ms readings after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(loop_ms(fn, n) for _ in range(3))


def bound(nbytes: float, ops: float, op_rate: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / op_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class HashTokenizer:
    """Stand-in tokenizer with the HuggingFace call signature, for the
    smoke only: [CLS]=101, words hashed into ids 1000..30521, [SEP]=102,
    [PAD]=0."""

    def __call__(self, texts, padding="max_length", truncation=True,
                 max_length=64, return_tensors="np"):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            words = [1000 + zlib.crc32(w.encode()) % (30522 - 1000)
                     for w in text.lower().split()]
            toks = [101] + words[:max_length - 2] + [102]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def make_queries(rng, n):
    return [" ".join(f"w{x}" for x in rng.integers(0, 50000,
                                                    rng.integers(4, 24)))
            for _ in range(n)]


def ffn_inputs(gen, dev, T, H, F, int8=False):
    """Inputs of the FFN half-layer: r [T, H] bf16, LayerNorm parameters
    float32, weights at BERT's init scale in nn.Linear layout: bf16 weights
    and biases for K1, or (int8 weights, float32 scales, float32 biases)
    quantized from float32 weights for K7."""
    def rnd(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * std + mean
    bf = torch.bfloat16
    r, s1, c1 = rnd(T, H).to(bf), rnd(H, std=0.1, mean=1.0), rnd(H, std=0.1)
    w1, b1 = rnd(F, H, std=0.02), rnd(F, std=0.02)
    w2, b2 = rnd(H, F, std=0.02), rnd(H, std=0.02)
    s2, c2 = rnd(H, std=0.1, mean=1.0), rnd(H, std=0.1)
    if not int8:
        return (r, s1, c1, w1.to(bf), b1.to(bf), w2.to(bf), b2.to(bf), s2, c2)
    from cocodr_tpu_torch.ops.int8_matmul import quantize_cols

    w1q, sw1 = quantize_cols(w1)
    w2q, sw2 = quantize_cols(w2)
    return (r, s1, c1, w1q, sw1[:, 0], b1, w2q, sw2[:, 0], b2, s2, c2)


def check_ffn(name, kern, plain, args, what, max_share):
    """A half-layer kernel against its plain version. Tolerance: two bf16
    ulps of the largest output (bf16 spacing <= 2^-7 |x|): h and out round
    to bf16 (K1), or an activation's quantized value moves by one (K7),
    after float32 sums taken in another order. A kernel that rounds at
    another point stays inside that bound, so the share of outputs that
    differ at all must also stay under `max_share`. On the H100 K1 differed
    from its plain version in 0.7-1.3% of outputs and K7 in 0.03-0.05%; on
    the CPU (tests/test_torch_ffn.py and test_torch_int8.py,
    *_share_limit_*) moving one rounding point of K1 moves 22-29% of them,
    and skipping K7's re-quantization of h or taking bf16 weights 67-76%.
    -> max abs err."""
    got = kern(*args).float()
    ref = plain(*args).float()
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    err = diff.max().item()
    tol = 2.0 ** -6 * ref.abs().max().item()
    share = (diff > 0).float().mean().item()
    phase(f"  {name} {what}: max_abs_err={err:.3e} tol={tol:.3e}, "
          f"{share:.2e} of elements differ (limit {max_share:.0e})")
    if (not err <= tol or not share <= max_share
            or not torch.isfinite(got).all()):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"max abs err {err}, share differing {share}")
    return err


def ffn_bytes(T, H, F, w_bytes, b_bytes):
    """r in and out (bf16), both weights, both biases, four LayerNorm
    vectors (float32)."""
    return 2 * T * H * 2 + 2 * H * F * w_bytes + (F + H) * b_bytes + 4 * H * 4


def time_ffn(name, kern, plain, args, nbytes, ops, rate, loops):
    """A half-layer kernel's device time (loop_ms over `loops` calls) and
    its single-launch time (time_ms, as PRs 4-7 timed it), the plain
    version's and the bound -> (device ms, plain ms, bound ms, bound by)."""
    ms = device_ms(lambda: kern(*args), loops)
    single = time_ms(lambda: kern(*args))
    plain_ms = time_ms(lambda: plain(*args))
    b_ms, b_by = bound(nbytes, ops, rate)
    phase(f"  {name}: kernel {ms:.4f} ms ({single:.4f} ms one launch per "
          f"event pair), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}), {100 * b_ms / ms:.1f}% of it")
    return ms, plain_ms, b_ms, b_by


def kernel_split(fn, runs: int = 5) -> dict:
    """Device ms per call of each CUDA kernel that fn launches, summed by
    kernel name over a torch.profiler trace of `runs` calls (empty when
    the trace holds no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / runs / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


# K1's four launches, by a part of their kernels' names
K1_PARTS = (("LN1", "ln1_kernel"), ("up GEMM", "UpEpi"),
            ("down GEMM", "ResidualEpi"), ("LN2", "ln2_kernel"))


def k1_split(ffn, args):
    """Where K1's time goes at the args' shape: each launch's device ms
    from a profiler trace, beside torch.mm of the up GEMM's shape (r .
    W1^T, no bias or GELU; a yardstick for the GEMM main loop)."""
    split = kernel_split(lambda: ffn.fused_ffn_block(*args))
    parts = {name: sum(ms for key, ms in split.items() if tag in key)
             for name, tag in K1_PARTS}
    r, w1 = args[0], args[3]
    mm = device_ms(lambda: torch.mm(r, w1.t()), 20)
    T, H = r.shape
    what = (", ".join(f"{name} {ms:.4f}" for name, ms in parts.items())
            if split else "not measured (the trace holds no device time)")
    phase(f"  K1 T={T} H={H} launches (device ms, profiler): {what}; "
          f"torch.mm of the up GEMM's shape {mm:.4f} ms")


# token counts of the K1/K4/K5 card checks: one served query (T = 64, half
# of a GEMM's 128-row tile, the rest zeros from TMA), ragged T (1000, and
# 4,104 = 4,096 + 8 rows in a last tile), the serving batch and the encode
# path's T
FFN_CHECK_T = (64, 1000, 4096, 4104, ENC_TOKENS)


def check_k1(ffn, gen, dev):
    """K1 at bert-base widths, bf16, at FFN_CHECK_T; timed at T = 64 * 64
    tokens (serving) and the encode path's T = 256 * 128."""
    H, F = 768, 3072
    errs = [check_ffn("K1", ffn.fused_ffn_block, ffn.ffn_block_reference,
                      ffn_inputs(gen, dev, T, H, F), f"T={T} H={H} F={F}",
                      K1_MAX_SHARE)
            for T in FFN_CHECK_T]
    out = None
    for T in (4096, ENC_TOKENS):
        args = ffn_inputs(gen, dev, T, H, F)
        ms, plain, b_ms, b_by = time_ffn(
            f"K1 T={T}", ffn.fused_ffn_block, ffn.ffn_block_reference, args,
            ffn_bytes(T, H, F, 2, 2), 4 * T * H * F, BF16_FLOP_PER_S,
            100 if T == 4096 else 20)
        if T == ENC_TOKENS:
            k1_split(ffn, args)
        if out is None:  # the serving shape stands for K1 in the summary
            out = dict(name="K1_ffn_block", route="cuda",
                       source="cocodr_tpu_torch/csrc/ffn_block.cu",
                       replaces="cocodr_tpu/ops/pallas_ffn.py:130",
                       max_abs_err=max(errs), ms=ms, plain_ms=plain,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return out


def check_k4(ffn, gen, dev):
    """K4: the JAX package's F-chunked half-layer (bert-large widths,
    H = 1024, F = 4096) is K1's function; K1 at FFN_CHECK_T, timed at the
    encode path's T."""
    H, F = 1024, 4096
    errs = [check_ffn("K4 (K1)", ffn.fused_ffn_block, ffn.ffn_block_reference,
                      ffn_inputs(gen, dev, T, H, F), f"T={T} H={H} F={F}",
                      K1_MAX_SHARE)
            for T in FFN_CHECK_T]
    T = ENC_TOKENS
    args = ffn_inputs(gen, dev, T, H, F)
    ms, plain, b_ms, b_by = time_ffn(
        f"K4 (K1) T={T} H={H} F={F}", ffn.fused_ffn_block,
        ffn.ffn_block_reference, args, ffn_bytes(T, H, F, 2, 2),
        4 * T * H * F, BF16_FLOP_PER_S, 20)
    k1_split(ffn, args)
    return dict(name="K4_ffn_block_chunked", route="cuda",
                source="cocodr_tpu_torch/csrc/ffn_block.cu",
                replaces="cocodr_tpu/ops/pallas_ffn.py:156",
                max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def check_k5(ffn, gen, dev):
    """K5 (the FFN of the dropout path) at bert-base widths at
    FFN_CHECK_T, the training path's T = 64 * 128 (one tower of a warmup
    step) and the JAX warmup preset's T = 256 * 128; timed at the last
    two. Besides the max-abs bound, the share of outputs that differ at
    all stays under K5_MAX_SHARE: on the CPU (tests/test_torch_ffn.py,
    test_k5_share_limit_*; T = 128) sums in another order move 0.5% of
    them, a moved rounding point (h in float32, a bf16 pre-activation, y
    rounded before b2) 27-59%. -> the summary entry of T = TRAIN_T."""
    H, F = 768, 3072
    errs, out = [], None
    for T in sorted(set(FFN_CHECK_T + (TRAIN_T, 4 * TRAIN_T))):
        x, _, _, w1, b1, w2, b2, _, _ = ffn_inputs(gen, dev, T, H, F)
        args = (x, w1, b1, w2, b2)
        errs.append(check_ffn("K5", ffn.fused_ffn, ffn.ffn_reference, args,
                              f"T={T} H={H} F={F}", K5_MAX_SHARE))
        if T not in (TRAIN_T, 4 * TRAIN_T):
            continue
        # x in, out, both weights, both biases (bf16)
        ms, plain, b_ms, b_by = time_ffn(
            f"K5 T={T}", ffn.fused_ffn, ffn.ffn_reference, args,
            2 * T * H * 2 + 2 * H * F * 2 + (F + H) * 2, 4 * T * H * F,
            BF16_FLOP_PER_S, 50 if T == TRAIN_T else 20)
        if out is None:
            out = dict(name="K5_ffn", route="cuda",
                       source="cocodr_tpu_torch/csrc/ffn_block.cu",
                       replaces="cocodr_tpu/ops/pallas_ffn.py:62",
                       ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None)
    out["max_abs_err"] = max(errs)
    return out


def check_k7(ffn, gen, dev):
    """K7 at FFN_CHECK_T at bert-base and bert-large widths; timed by loops
    of back-to-back launches (time_ffn, the one-launch time beside) at
    T = 4,096 (serve int8_encode) and the encode path's T at bert-base, and
    at the encode path's T at bert-large; its launches split by a profiler
    trace at the encode path's T (k7_split). -> the summary entry of the
    bert-base shape at the encode path's T (the path (d) runs)."""
    errs, out = [], None
    for H, F in ((768, 3072), (1024, 4096)):
        for T in FFN_CHECK_T:
            args = ffn_inputs(gen, dev, T, H, F, int8=True)
            errs.append(check_ffn("K7", ffn.fused_ffn_block_int8,
                                  ffn.ffn_block_int8_reference, args,
                                  f"T={T} H={H} F={F}", K7_MAX_SHARE))
            if T != ENC_TOKENS and (T != 4096 or H != 768):
                continue
            # int8 weights, float32 scales and biases
            ms, plain, b_ms, b_by = time_ffn(
                f"K7 T={T} H={H} F={F}", ffn.fused_ffn_block_int8,
                ffn.ffn_block_int8_reference, args, ffn_bytes(T, H, F, 1, 8),
                4 * T * H * F, INT8_OP_PER_S, 100 if T == 4096 else 20)
            if T == ENC_TOKENS:
                k7_split(ffn, args, gen)
                if out is None:
                    out = dict(name="K7_ffn_block_int8", route="cuda",
                               source="cocodr_tpu_torch/csrc/ffn_block_int8.cu",
                               replaces="cocodr_tpu/ops/pallas_ffn.py:304",
                               ms=ms, plain_ms=plain, bound_ms=b_ms,
                               bound_by=b_by, library_ms=None)
    out["max_abs_err"] = max(errs)
    return out


# K7's five launches, by a part of their kernels' names
K7_PARTS = (("LN1 + quantize", "ln1_quant_kernel"), ("up GEMM", "UpEpi"),
            ("quantize h", "quant_h_kernel"), ("down GEMM", "DownEpi"),
            ("LN2", "ln2_kernel"))


def k7_split(ffn, args, gen):
    """Where K7's time goes at the args' shape: each launch's device ms
    from a profiler trace, beside torch._int_mm of its up and down GEMMs'
    shapes (int8 operands, int32 products; no scales, bias or activation),
    each timed in turns with K7 (time_turns): yardsticks for the int8 main
    loop, not the kernel's function."""
    split = kernel_split(lambda: ffn.fused_ffn_block_int8(*args))
    parts = {name: sum(ms for key, ms in split.items() if tag in key)
             for name, tag in K7_PARTS}
    r, w1q, w2q = args[0], args[3], args[6]
    T, H = r.shape
    F = w1q.shape[0]
    a_up = torch.randint(-127, 128, (T, H), generator=gen, device=r.device,
                         dtype=torch.int8)
    a_down = torch.randint(-127, 128, (T, F), generator=gen, device=r.device,
                           dtype=torch.int8)
    kern = lambda: ffn.fused_ffn_block_int8(*args)  # noqa: E731
    k_up, up = time_turns(kern, lambda: torch._int_mm(a_up, w1q.t()), 10)
    k_down, down = time_turns(kern, lambda: torch._int_mm(a_down, w2q.t()),
                              10)
    what = (", ".join(f"{name} {ms:.4f}" for name, ms in parts.items())
            if split else "not measured (the trace holds no device time)")
    phase(f"  K7 T={T} H={H} launches (device ms, profiler): {what}; "
          f"torch._int_mm of the up GEMM's shape {up:.4f} ms, of the down "
          f"GEMM's {down:.4f} ms (in turns with K7: {k_up:.4f}, "
          f"{k_down:.4f} ms)")


def check_map_cache(ffn, gen, dev):
    """K1 and then K7 on weights at one address. gemm_wgmma.cuh caches a
    TMA tensor map per (element type, address, shape, box), and the
    caching allocator hands a freed block to the next tensor, so a bf16
    W1 [F, H] and an int8 W1q [F, H] can lie at one address in turn. Here
    both are views of one byte buffer: K1 runs on its W1 written there,
    then K7 on its W1q written over it, then K1 again, each held against
    its plain version as check_ffn holds them. With a key without the
    element type, K7 would read its weight through K1's bf16 map."""
    T, H, F = 4096, 768, 3072
    k1 = ffn_inputs(gen, dev, T, H, F)
    k7 = ffn_inputs(gen, dev, T, H, F, int8=True)
    buf = torch.empty(F * H * 2, dtype=torch.uint8, device=dev)
    w1 = buf.view(torch.bfloat16).view(F, H)
    w1q = buf[:F * H].view(torch.int8).view(F, H)
    if w1.data_ptr() != w1q.data_ptr():
        raise AssertionError("the two views do not share an address")
    for name in ("K1", "K7", "K1"):
        if name == "K1":
            w1.copy_(k1[3])
            kern, plain = ffn.fused_ffn_block, ffn.ffn_block_reference
            args, limit = k1[:3] + (w1,) + k1[4:], K1_MAX_SHARE
        else:
            w1q.copy_(k7[3])
            kern, plain = ffn.fused_ffn_block_int8, ffn.ffn_block_int8_reference
            args, limit = k7[:3] + (w1q,) + k7[4:], K7_MAX_SHARE
        check_ffn(f"{name} (W1 at {buf.data_ptr():#x})", kern, plain, args,
                  f"T={T} H={H} F={F}", limit)


def check_k8(att, gen, dev):
    """K8 at the encode shape B = 256, S = 128, N = 12, D = 64, with a
    padding bias (lengths 16..128), timed in turns with
    scaled_dot_product_attention on the same inputs (time_turns; SDPA is
    timed only: it defers no rounding the way K8 does). Also odd shapes:
    bucket widths, S not a multiple of 16, the kernel's two-pass schedule
    (S > 128) with its shared-memory ring two deep (S = 384) and one deep
    (S = 392, 512).
    Besides the bound, the share of outputs that differ at all stays under
    K8_MAX_SHARE: on the CPU (tests/test_torch_attention.py,
    test_k8_share_limit_separates_rounding_points; B = 16, S = 128,
    N = 12) sums in another order (float64) move 0.01% of them, while a
    softmax normalised after the PV product (an online softmax) moves 47%
    and float32 probabilities 41%, all inside the max-abs bound."""
    import torch.nn.functional as F

    err = 0.0
    for B, S, N in ((ENC_BATCH, ENC_LEN, 12), (ENC_BATCH, 32, 12),
                    (ENC_BATCH, 64, 16), (8, 200, 16), (4, 384, 12),
                    (4, 392, 12), (4, 512, 16), (3, 40, 3)):
        q, k, v = (torch.randn(B, S, N, 64, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        lens = torch.randint(min(16, S), S + 1, (B,), generator=gen,
                             device=dev)
        bias = torch.where(torch.arange(S, device=dev)[None, :]
                           < lens[:, None], 0.0, -1e9).float().contiguous()
        got = att.fused_attention_seq_major(q, k, v, bias, 0.125).float()
        ref = att.attention_reference(q, k, v, bias, 0.125).float()
        torch.cuda.synchronize()
        diff = (got - ref).abs()
        e = diff.max().item()
        share = (diff > 0).float().mean().item()
        # one bf16 ulp of the output, plus one ulp of a probability times
        # max |v|: a probability or an output rounded to the other side of
        # a bf16 boundary after float32 sums in another order
        tol = 2.0 ** -8 * (ref.abs().max().item() + v.abs().max().item())
        phase(f"  K8 B={B} S={S} N={N} D=64: max_abs_err={e:.3e} "
              f"tol={tol:.3e}, {share:.2e} of elements differ "
              f"(limit {K8_MAX_SHARE:.0e})")
        if (not e <= tol or not share <= K8_MAX_SHARE
                or not torch.isfinite(got).all()):
            raise AssertionError(f"K8 disagrees with its plain version: max "
                                 f"abs err {e}, share differing {share}")
        err = max(err, e)
        if S != ENC_LEN:
            continue
        single = time_ms(lambda: att.fused_attention_seq_major(
            q, k, v, bias, 0.125))
        plain = time_ms(lambda: att.attention_reference(q, k, v, bias,
                                                        0.125))
        mask = bias[:, None, None, :].to(torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms, lib = time_turns(
            lambda: att.fused_attention_seq_major(q, k, v, bias, 0.125),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                   scale=0.125), 100)
        b_ms, b_by = bound(4 * B * S * N * 64 * 2 + B * S * 4,
                           4 * B * N * S * S * 64, BF16_FLOP_PER_S)
        phase(f"  K8 B={B} S={S} N={N}: kernel {ms:.4f} ms, "
              f"scaled_dot_product_attention {lib:.4f} ms (in turns, 100 "
              f"launches an event pair: {ms / lib:.2f}x); one launch per "
              f"event pair {single:.4f} ms; plain {plain:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of it")
        entry = dict(name="K8_attention", route="cuda",
                     source="cocodr_tpu_torch/csrc/attention.cu",
                     replaces="cocodr_tpu/ops/pallas_attention.py:41",
                     ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib)
    entry["max_abs_err"] = err
    return entry


def check_k2(mips, corpus, gen, dev):
    """K2 at Q = 64 over the served corpus (N = 1,048,576, D = 768)."""
    Q = BATCH
    q = torch.randn(Q, DIM, generator=gen, device=dev).to(torch.bfloat16)
    fine, coarse = mips.dual_sweep(q, corpus)
    rfine, rcoarse = mips.dual_sweep_reference(q, corpus)
    torch.cuda.synchronize()
    err = max((fine - rfine).abs().max().item(),
              (coarse - rcoarse).abs().max().item())
    # float32 sums of D = 768 exact bf16 products in another order
    tol = 1e-4 * max(1.0, rfine.abs().max().item())
    phase(f"  K2 Q={Q} N={N_DOCS} D={DIM}: max_abs_err={err:.3e} "
          f"tol={tol:.3e}")
    if not err <= tol:
        raise AssertionError(f"K2 disagrees with its plain version: {err}")
    ms = device_ms(lambda: mips.dual_sweep(q, corpus), 20)
    single = time_ms(lambda: mips.dual_sweep(q, corpus))
    plain = time_ms(lambda: mips.dual_sweep_reference(q, corpus))
    nbytes = N_DOCS * DIM * 2 + Q * DIM * 2 + Q * (N_DOCS // 8
                                                   + N_DOCS // 64) * 4
    b_ms, b_by = bound(nbytes, 2 * Q * N_DOCS * DIM, BF16_FLOP_PER_S)
    phase(f"  K2: kernel {ms:.4f} ms ({single:.4f} ms one launch per event "
          f"pair), plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
          f"{100 * b_ms / ms:.1f}% of it")
    return dict(name="K2_dual_sweep", route="cuda",
                source="cocodr_tpu_torch/csrc/mips_sweep.cu",
                replaces="cocodr_tpu/ops/pallas_mips.py:100",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


# K3's shapes on its paths: (what, dtype, Q, W, k). The search at
# Q = 1024, k = 100: the super level of pallas, fast and exact2, the fine
# blocks of pallas and fast, pallas's rescore and exact2's runs, the int8
# method's packed maxima (int32), exact2's rescore slots (k = R = 6) and
# final merge; a super level at MS MARCO's 8,841,823 docs; k = 1000 (ANCE
# mining may ask for more than 100); the serving path's three at k = 10.
K3_SHAPES = (
    ("super", torch.float32, SEARCH_Q, 2048, SEARCH_K),
    ("fine", torch.float32, SEARCH_Q, 6400, SEARCH_K),
    ("rescore, exact2 runs", torch.float32, SEARCH_Q, 800, SEARCH_K),
    ("int8 super", torch.int32, SEARCH_Q, 2048, SEARCH_K),
    ("int8 fine", torch.int32, SEARCH_Q, 6400, SEARCH_K),
    ("exact2 slots", torch.float32, SEARCH_Q, 100, 6),
    ("exact2 merge", torch.float32, SEARCH_Q, 484, SEARCH_K),
    ("MARCO super", torch.float32, SEARCH_Q, 17272, SEARCH_K),
    ("k=1000", torch.float32, SEARCH_Q, 6400, 1000),
    ("serve super", torch.float32, BATCH, 2048, TOP_K),
    ("serve fine", torch.float32, BATCH, 640, TOP_K),
    ("serve rescore", torch.float32, BATCH, 80, TOP_K),
)
K3_SUMMARY = "fine"  # the shape that stands for K3 in the kernels line


def k3_input(gen, dev, dtype, Q, W):
    """Normal float32 rows, or int32 rows spread like the int8 method's
    packed maxima (scores of up to ~2^27 with the argmax in the low bits)."""
    x = torch.randn(Q, W, generator=gen, device=dev)
    return x if dtype == torch.float32 else (x * 2 ** 24).to(torch.int32)


def k3_cases(gen, dev):
    """(name, x, k): every K3 shape, then rows that exercise ties, the
    sentinel and the tail rule."""
    cases = [(f"{what} [{Q},{W}]", k3_input(gen, dev, dt, Q, W), k)
             for what, dt, Q, W, k in K3_SHAPES]
    cases.append(("i32 ties [64,2048]", torch.randint(
        0, 8, (BATCH, 2048), generator=gen, device=dev,
        dtype=torch.int32), TOP_K))
    cases.append(("i32 ties [1024,100]", torch.randint(
        0, 4, (SEARCH_Q, 100), generator=gen, device=dev,
        dtype=torch.int32), 60))
    cases.append(("i32 ties [1024,2048]", torch.randint(
        0, 8, (SEARCH_Q, 2048), generator=gen, device=dev,
        dtype=torch.int32), SEARCH_K))
    x = torch.randn(BATCH, 640, generator=gen, device=dev)
    x[:, 5:] = float("-inf")
    x[1, :] = float("-inf")
    cases.append(("-inf rows", x, TOP_K))
    # every entry -inf and W % 128 = 0 (no pad slot): round 1 returns
    # (-inf, 0), the later rounds (finfo.min, 0)
    cases.append(("all -inf, no pad [64,640]", torch.full(
        (BATCH, 640), float("-inf"), device=dev), SEARCH_K))
    x = torch.full((SEARCH_Q, 2048), torch.finfo(torch.float32).min,
                   device=dev)
    x[::2, 7] = 1.0
    cases.append(("finfo.min rows [1024,2048]", x, SEARCH_K))
    # +0.0 and -0.0 tie: lowest index first across both
    zeros = torch.randint(0, 2, (BATCH, 2048), generator=gen, device=dev)
    x = torch.where(zeros.bool(), 0.0, -0.0)
    x[:, ::9] = 1.0
    cases.append(("+-0 ties [64,2048]", x, SEARCH_K))
    x = torch.randint(-3, 3, (BATCH, 2048), generator=gen, device=dev,
                      dtype=torch.int32)
    x[x == -3] = torch.iinfo(torch.int32).min
    x[:, 1::7] = torch.iinfo(torch.int32).max
    x[2, :] = torch.iinfo(torch.int32).min
    cases.append(("i32 INT_MIN [64,2048]", x, SEARCH_K))
    cases.append(("k=W [64,640]", torch.randn(BATCH, 640, generator=gen,
                                              device=dev), 640))
    cases.append(("k=W [1024,100]", torch.randn(SEARCH_Q, 100, generator=gen,
                                                device=dev), 100))
    cases.append(("k=W [8,6000] (segments)", torch.randn(
        8, 6000, generator=gen, device=dev), 6000))
    cases.append(("wide f32 [4,100000]",
                  torch.randn(4, 100_000, generator=gen, device=dev), TOP_K))
    cases.append(("wide f32 [4,100000] k=3000", torch.randn(
        4, 100_000, generator=gen, device=dev), 3000))
    return cases


def k3_agrees(mips, x, k):
    """K3 against its plain version: ids equal, values equal (+0.0 and
    -0.0 compare equal), and every value above the sentinel the bits of
    the entry its id names. -> max |value difference| (0 when equal)."""
    v, i = mips.topk(x, k)
    rv, ri = mips.topk_reference(x, k)
    torch.cuda.synchronize()
    if not (torch.equal(v, rv) and torch.equal(i, ri)):
        bad = (v != rv) | (i != ri)
        r = int(bad.any(1).nonzero()[0, 0])
        c = int(bad[r].nonzero()[0, 0])
        raise AssertionError(
            f"kernel != plain version, row {r} rank {c}: "
            f"({v[r, c].item()}, {i[r, c].item()}) != "
            f"({rv[r, c].item()}, {ri[r, c].item()})")
    neg = (torch.finfo(x.dtype).min if x.dtype.is_floating_point
           else torch.iinfo(x.dtype).min)
    real = v > neg
    own = x.gather(1, i.long().clamp_max(x.shape[1] - 1))
    bits = torch.int32
    if not torch.equal(v.view(bits)[real], own.view(bits)[real]):
        raise AssertionError("a value is not its entry's own bits")
    # equal values give 0, and -inf - -inf gives NaN, counted as 0
    return (v.double() - rv.double()).nan_to_num(0.0).abs().max().item()


def k3_bound(Q, W, k):
    """One read of the row, k values and ids written; one compare an entry
    of the padded row."""
    Wp = -(-W // 128) * 128
    return bound(Q * W * 4 + Q * k * 8, Q * Wp, FP32_OP_PER_S)


def check_k3(mips, gen, dev):
    """K3 on every shape of its paths and on rows of ties, sentinels and
    -inf (all must equal the plain version exactly), then timed at each
    shape in turns with torch.topk, beside the plain version and the
    bound."""
    err = 0.0
    for name, x, k in k3_cases(gen, dev):
        err = max(err, k3_agrees(mips, x, k))
        phase(f"  K3 {name} k={k}: values and ids equal to the plain "
              f"version (tol 0)")
    card = nvidia_smi()
    out = None
    for what, dt, Q, W, k in K3_SHAPES:
        x = k3_input(gen, dev, dt, Q, W)
        n = 200 if Q == BATCH else 50
        ms, lib = time_turns(lambda: mips.topk(x, k),
                             lambda: torch.topk(x, k, dim=1), n)
        plain = time_ms(lambda: mips.topk_reference(x, k), runs=3, warmup=1)
        b_ms, b_by = k3_bound(Q, W, k)
        phase(f"  K3 {what} [{Q},{W}] {str(dt)[6:]} k={k}: kernel "
              f"{ms:.4f} ms, torch.topk {lib:.4f} ms (in turns, {n} "
              f"launches an event pair: {ms / lib:.2f}x), plain "
              f"{plain:.4f} ms, bound {b_ms:.6f} ms ({b_by}, "
              f"{100 * b_ms / ms:.1f}% of it) [{card}]")
        if what == K3_SUMMARY:
            out = dict(name="K3_topk", route="cuda",
                       source="cocodr_tpu_torch/csrc/topk.cu",
                       replaces="cocodr_tpu/ops/pallas_mips.py:214",
                       max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib)
    return out


def block_gaps(mips_hier, q, corpus, rows):
    """[Q, N/rows]: the best minus the second-best plain score of every
    rows-row block; a block within the tolerance is a near-tie, whose
    argmax may differ between two summation orders."""
    Q = q.shape[0]
    parts = []
    for s in range(0, corpus.shape[0], 131072):
        s3 = mips_hier.scores(q, corpus[s:s + 131072]).view(Q, -1, rows)
        top2 = s3.topk(2, dim=-1).values
        parts.append(top2[..., 0] - top2[..., 1])
    return torch.cat(parts, dim=1)


def check_packed(name, got, want, nbits, gaps, tol):
    """Packed float32 maxima: values with nbits low bits cleared within
    tol; the packed argmax exactly equal wherever the block is no
    near-tie. -> (max abs err of the cleared values, near-tie blocks)."""
    mask = (1 << nbits) - 1
    gb, wb = got.view(torch.int32), want.view(torch.int32)
    err = ((gb & ~mask).view(torch.float32)
           - (wb & ~mask).view(torch.float32)).abs().max().item()
    decided = gaps > tol
    wrong = int(((gb & mask) != (wb & mask))[decided].sum().item())
    ties = int((~decided).sum().item())
    if not err <= tol or wrong:
        raise AssertionError(f"{name} disagrees with its plain version: err "
                             f"{err}, {wrong} decided argmaxes differ")
    return err, ties


def check_sweeps(gen, dev, corpus, corpus_i8, dim_scale):
    """K2 (plain and packed), K6, K9 and K10 against their plain versions
    at Q = 64 (serving) and Q = 1024 (search and mining chunks) over the
    corpus. -> {(kernel, Q): summary entry}."""
    from cocodr_tpu_torch.ops import mips_blockmax, mips_exact2, mips_hier
    from cocodr_tpu_torch.ops import mips_int8

    N, D = corpus.shape
    out = {}
    for Q in (BATCH, SEARCH_Q):
        x = torch.randn(Q, D, generator=gen, device=dev)
        q = (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        q_i8, _ = mips_int8.quantize_queries(q, dim_scale)
        tol = 1e-4 * max(1.0, mips_hier.scores(q, corpus[:131072])
                         .abs().max().item())

        f, c = mips_hier.dual_sweep(q, corpus)
        rf, rc = mips_hier.dual_sweep_reference(q, corpus)
        err = max((f - rf).abs().max().item(), (c - rc).abs().max().item())
        if not err <= tol:
            raise AssertionError(f"K2 disagrees with its plain version: {err}")
        errs = {"K2_dual_sweep": (err, "")}

        f, c = mips_hier.dual_sweep(q, corpus, pack=True)
        rf, rc = mips_hier.dual_sweep_reference(q, corpus, pack=True)
        fine_gaps = block_gaps(mips_hier, q, corpus, 8)
        err, ties = check_packed("K2 packed fine", f, rf, 3, fine_gaps, tol)
        cerr = (mips_hier.clear_low_bits(c, 3)
                - mips_hier.clear_low_bits(rc, 3)).abs().max().item()
        if not cerr <= tol:
            raise AssertionError(f"K2 packed coarse disagrees: {cerr}")
        del fine_gaps
        errs["K2_dual_sweep_packed"] = (max(err, cerr),
                                        f"{ties} near-tie fine blocks")

        b, pk = mips_exact2.top2_sweep(q, corpus)
        rb, rpk = mips_exact2.top2_sweep_reference(q, corpus)
        berr = (b - rb).abs().max().item()
        if not berr <= tol:
            raise AssertionError(f"K9 best disagrees: {berr}")
        gaps = rb - mips_hier.clear_low_bits(rpk, 6)
        err, ties = check_packed("K9 second", pk, rpk, 6, gaps, tol)
        errs["K9_top2_sweep"] = (max(err, berr),
                                 f"{ties} near-tie coarse blocks")

        bm = mips_blockmax.block_sweep(q, corpus)
        rbm = mips_blockmax.block_sweep_reference(q, corpus)
        err = (bm - rbm).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"K10 disagrees: {err}")
        errs["K10_block32_sweep"] = (err, "")

        fi, ci = mips_int8.int8_sweep(q_i8, corpus_i8)
        rfi, rci = mips_int8.int8_sweep_reference(q_i8, corpus_i8)
        if not (torch.equal(fi, rfi) and torch.equal(ci, rci)):
            raise AssertionError("K6 != its plain version (integer sums)")
        errs["K6_int8_sweep"] = (0.0, "bit-equal")
        torch.cuda.synchronize()

        runs = {
            "K2_dual_sweep": (
                lambda: mips_hier.dual_sweep(q, corpus),
                lambda: mips_hier.dual_sweep_reference(q, corpus),
                2, (N // 8 + N // 64) * 4, BF16_FLOP_PER_S),
            "K2_dual_sweep_packed": (
                lambda: mips_hier.dual_sweep(q, corpus, pack=True),
                lambda: mips_hier.dual_sweep_reference(q, corpus, pack=True),
                2, (N // 8 + N // 64) * 4, BF16_FLOP_PER_S),
            "K6_int8_sweep": (
                lambda: mips_int8.int8_sweep(q_i8, corpus_i8),
                lambda: mips_int8.int8_sweep_reference(q_i8, corpus_i8),
                1, (N // 8 + N // 64) * 4, INT8_OP_PER_S),
            "K9_top2_sweep": (
                lambda: mips_exact2.top2_sweep(q, corpus),
                lambda: mips_exact2.top2_sweep_reference(q, corpus),
                2, 2 * (N // 64) * 4, BF16_FLOP_PER_S),
            "K10_block32_sweep": (
                lambda: mips_blockmax.block_sweep(q, corpus),
                lambda: mips_blockmax.block_sweep_reference(q, corpus),
                2, (N // 32) * 4, BF16_FLOP_PER_S),
        }
        for name, (kern, plain, elem, out_bytes, rate) in runs.items():
            if name == "K2_dual_sweep" and Q == BATCH:
                continue  # check_k2 times it at the serving shape
            # loops of back-to-back launches, the one-launch time beside
            ms = device_ms(kern, 20 if Q == BATCH else 5)
            single = f" ({time_ms(kern):.4f} ms one launch per event pair)"
            plain_ms = time_ms(plain)
            b_ms, b_by = bound((N + Q) * D * elem + Q * out_bytes,
                               2 * Q * N * D, rate)
            err, note = errs[name]
            phase(f"  {name} Q={Q} N={N} D={D}: kernel {ms:.4f} ms{single}, "
                  f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                  f"{100 * b_ms / ms:.1f}% of it; max_abs_err={err} "
                  f"tol={tol:.3e} {note}")
            out[name, Q] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, max_abs_err=err)
        if Q == SEARCH_Q:
            # yardsticks for the main loop: the same product into a [Q, N]
            # matrix, no block maxima (not the sweeps' function), in turns
            # with K2 and K9 (bf16, torch.mm) and K6 (int8, torch._int_mm)
            prod = torch.empty((Q, N), dtype=torch.bfloat16, device=dev)
            bf16_mm = lambda: torch.mm(q, corpus.t(), out=prod)  # noqa: E731
            for name in ("K2_dual_sweep", "K9_top2_sweep"):
                k_ms, mm = time_turns(runs[name][0], bf16_mm, 3)
                phase(f"  torch.mm of the sweep's [{Q}, {D}] x [{D}, {N}] "
                      f"bf16 product: {mm:.4f} ms (in turns with {name}: "
                      f"{k_ms:.4f} ms)")
            del prod
            prod = torch.empty((Q, N), dtype=torch.int32, device=dev)
            k_ms, mm = time_turns(
                runs["K6_int8_sweep"][0],
                lambda: torch._int_mm(q_i8, corpus_i8.t(), out=prod), 3)
            del prod
            phase(f"  torch._int_mm of the sweep's [{Q}, {D}] x [{D}, {N}] "
                  f"int8 product into int32: {mm:.4f} ms (in turns with "
                  f"K6_int8_sweep: {k_ms:.4f} ms)")
    return out


# (Q, N, D) of check_sweep_shapes beside check_sweeps' Q = 64 and 1024
# over the corpus: one query, a ragged query tile, a small corpus, and a
# D that leaves a k tail past the last 64-column bf16 stage (K6 takes
# D = 192 there instead: half of its last 128-column int8 stage)
SWEEP_SHAPES = ((1, N_DOCS, DIM), (100, N_DOCS, DIM), (100, 2048, DIM),
                (1, 2048, 96), (64, 2048, 96), (100, 2048, 96),
                (1024, 2048, 96))
INT8_TAIL_DEPTH = 192


def normed(gen, dev, n, d):
    x = torch.randn(n, d, generator=gen, device=dev)
    return (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)


def check_sweep_shapes(gen, dev, corpus, corpus_i8):
    """K2 (plain and packed), K9 and K10 against their plain versions at
    SWEEP_SHAPES, with check_sweeps' limits (1e-4 x max |score|, packed
    argmaxes exact outside near-ties), and K6 bit for bit at the same
    shapes (D = 192 where the others take 96, random int8); then at
    Q = 100, N = 2,048, D = 96 with small integers (scores exact in every
    summation order) and repeated corpus rows (ties inside a thread's
    column pair, across a quad's lanes, and between two fine blocks of a
    64-row block), where the kernels must equal their plain versions bit
    for bit, first-occurrence argmaxes included."""
    from cocodr_tpu_torch.ops import mips_blockmax, mips_exact2, mips_hier
    from cocodr_tpu_torch.ops import mips_int8

    def sweeps(q, c):
        return {"K2": mips_hier.dual_sweep(q, c),
                "K2 packed": mips_hier.dual_sweep(q, c, pack=True),
                "K9": mips_exact2.top2_sweep(q, c),
                "K10": (mips_blockmax.block_sweep(q, c),)}, {
                "K2": mips_hier.dual_sweep_reference(q, c),
                "K2 packed": mips_hier.dual_sweep_reference(q, c, pack=True),
                "K9": mips_exact2.top2_sweep_reference(q, c),
                "K10": (mips_blockmax.block_sweep_reference(q, c),)}

    def check_k6(q_i8, c_i8, what):
        got = mips_int8.int8_sweep(q_i8, c_i8)
        want = mips_int8.int8_sweep_reference(q_i8, c_i8)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"K6 {what}: != its plain version")

    for Q, N, D in SWEEP_SHAPES:
        c = corpus if N == N_DOCS else normed(gen, dev, N, D)
        q = normed(gen, dev, Q, D)
        tol = 1e-4 * max(1.0, mips_hier.scores(q, c[:131072]).abs().max()
                         .item())
        got, want = sweeps(q, c)
        err = max((a - b).abs().max().item() for name in ("K2", "K10")
                  for a, b in zip(got[name], want[name]))
        if not err <= tol:
            raise AssertionError(f"K2/K10 Q={Q} N={N} D={D}: {err}")
        gaps = block_gaps(mips_hier, q, c, 8)
        perr, ties = check_packed("K2 packed fine", got["K2 packed"][0],
                                  want["K2 packed"][0], 3, gaps, tol)
        cerr = (mips_hier.clear_low_bits(got["K2 packed"][1], 3)
                - mips_hier.clear_low_bits(want["K2 packed"][1], 3)
                ).abs().max().item()
        if not cerr <= tol:
            raise AssertionError(f"K2 packed coarse Q={Q} N={N} D={D}: {cerr}")
        (b, pk), (rb, rpk) = got["K9"], want["K9"]
        berr = (b - rb).abs().max().item()
        if not berr <= tol:
            raise AssertionError(f"K9 best Q={Q} N={N} D={D}: {berr}")
        gaps = rb - mips_hier.clear_low_bits(rpk, 6)
        kerr, k9_ties = check_packed("K9 second", pk, rpk, 6, gaps, tol)
        phase(f"  K2, K2 packed, K9, K10 Q={Q} N={N} D={D}: max_abs_err="
              f"{max(err, perr, cerr, berr, kerr):.3e} tol={tol:.3e}, packed "
              f"argmax equal outside {ties} near-tie fine blocks (K2) and "
              f"{k9_ties} near-tie 64-row blocks (K9)")
        if N == N_DOCS:
            c_i8, Di = corpus_i8, D
        else:
            Di = INT8_TAIL_DEPTH if D % 64 else D
            c_i8 = torch.randint(-127, 128, (N, Di), generator=gen,
                                 device=dev, dtype=torch.int8)
        q_i8 = torch.randint(-127, 128, (Q, Di), generator=gen, device=dev,
                             dtype=torch.int8)
        check_k6(q_i8, c_i8, f"Q={Q} N={N} D={Di}")
        phase(f"  K6 Q={Q} N={N} D={Di}: equal to its plain version bit for "
              f"bit")
    Q, N, D = 100, 2048, 96
    qi, ci = repeated_rows_ints(gen, dev, Q, N, D)
    got, want = sweeps(qi.to(torch.bfloat16), ci.to(torch.bfloat16))
    for name in got:
        if not all(torch.equal(a, b) for a, b in zip(got[name], want[name])):
            raise AssertionError(f"{name} on exact integer scores differs "
                                 f"from its plain version")
    qi, ci = repeated_rows_ints(gen, dev, Q, N, INT8_TAIL_DEPTH)
    check_k6(qi.to(torch.int8), ci.to(torch.int8),
             "integers with repeated rows")
    phase(f"  K2, K2 packed, K9, K10 Q={Q} N={N} D={D} and K6 at "
          f"D={INT8_TAIL_DEPTH}, integer inputs with repeated rows: equal to "
          f"the plain versions bit for bit")


def repeated_rows_ints(gen, dev, Q, N, D):
    """Small integers (scores exact in every summation order) with rows
    repeated inside each 8-row fine block and across two of a 64-row
    block's fine blocks."""
    qi = torch.randint(-3, 4, (Q, D), generator=gen, device=dev)
    ci = torch.randint(-3, 4, (N, D), generator=gen, device=dev)
    ci[1::8] = ci[0::8]  # rows 0 and 1 of every fine block: one pair
    ci[6::8] = ci[3::8]  # rows 3 and 6: two lanes of a quad
    ci[18::64] = ci[5::64]  # rows 5 and 18 of a 64-row block: two groups
    return qi, ci


# the sweeps' GEMM instances, by their epilogues' names: K2 (two modes),
# K10, K6 (SweepEpi) and K9 (Top2Epi)
# kernels that must have no stack frame, by a part of their names: the
# five sweeps (by their epilogues) and K3's ten instantiations (float32 and
# int32 x 32, 128, 256, 512 threads a staged row and 512 a row in global
# memory)
NO_STACK_FRAME = {"SweepEpi": 4, "Top2Epi": 1, "radix_topk_kernel": 10}


def check_stack_frames(log):
    """Every sweep and top-k kernel in nvcc's -Xptxas -v report has no
    stack frame: register arrays that nvcc cannot index by constants move
    to local memory, and the report shows a frame."""
    lines = log.splitlines()
    found = dict.fromkeys(NO_STACK_FRAME, 0)
    for line, nxt in zip(lines, lines[1:] + [""]):
        name = next((e for e in NO_STACK_FRAME
                     if "Function properties for" in line and e in line), None)
        if name is None:
            continue
        found[name] += 1
        if not nxt.strip().startswith("0 bytes stack frame"):
            raise AssertionError(f"a kernel has a stack frame: {line} "
                                 f"{nxt.strip()}")
    if found != NO_STACK_FRAME:
        raise AssertionError(f"kernels in the ptxas report: {found}, "
                             f"expected {NO_STACK_FRAME}")
    phase(f"  ptxas: no stack frame in the {sum(found.values())} sweep and "
          f"top-k kernels")


def make_corpus(gen, dev):
    """N_DOCS x DIM bf16, row-normalised, drawn on the card in chunks."""
    corpus = torch.empty((N_DOCS, DIM), dtype=torch.bfloat16, device=dev)
    step = 131072
    for s in range(0, N_DOCS, step):
        x = torch.randn(min(step, N_DOCS - s), DIM, generator=gen, device=dev)
        corpus[s:s + step] = (x / x.norm(dim=1, keepdim=True)).to(
            torch.bfloat16)
    return corpus


def exact_search(emb, corpus, k):
    """Plain exact search: float32 scores of the bf16 operands + topk."""
    q = emb.to(torch.bfloat16).float()
    parts = [q @ corpus[s:s + 131072].float().t()
             for s in range(0, corpus.shape[0], 131072)]
    scores = torch.cat(parts, dim=1)
    v, i = torch.topk(scores, k, dim=1)
    return scores, v, i


def check_results(vals, ids, scores, ref_v, tol):
    """ids equal the exact search's as sets, up to near-ties within tol of
    the k-th score; scores agree within tol."""
    vals = torch.as_tensor(np.asarray(vals), device=scores.device)
    ids = torch.as_tensor(np.asarray(ids), device=scores.device)
    if vals.shape != ref_v.shape or not torch.isfinite(vals).all():
        raise AssertionError(f"bad result shape/values {tuple(vals.shape)}")
    err = (vals - ref_v).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"scores differ from exact search by {err}")
    kth = ref_v[:, -1:]
    own = scores.gather(1, ids)  # exact scores of the returned ids
    if not ((own - vals).abs().max().item() <= tol
            and bool((own >= kth - tol).all())):
        raise AssertionError("returned ids are not the exact top-k")
    for row in range(ids.shape[0]):
        got = set(ids[row].tolist())
        if len(got) != ids.shape[1]:
            raise AssertionError(f"duplicate ids in row {row}")
    return err


def kernel_counters():
    """name -> (wrapper, attribute) of every kernel's launch count."""
    from cocodr_tpu_torch.ops import (
        attention,
        ffn,
        mips_blockmax,
        mips_exact2,
        mips_hier,
        mips_int8,
    )

    return {"K1_ffn_block": (ffn.fused_ffn_block, "launches"),
            "K5_ffn": (ffn.fused_ffn, "launches"),
            "K2_dual_sweep": (mips_hier.dual_sweep, "launches"),
            "K2_dual_sweep_packed": (mips_hier.dual_sweep, "pack_launches"),
            "K3_topk": (mips_hier.topk, "launches"),
            "K6_int8_sweep": (mips_int8.int8_sweep, "launches"),
            "K7_ffn_block_int8": (ffn.fused_ffn_block_int8, "launches"),
            "K8_attention": (attention.fused_attention_seq_major,
                             "launches"),
            "K9_top2_sweep": (mips_exact2.top2_sweep, "launches"),
            "K10_block32_sweep": (mips_blockmax.block_sweep, "launches")}


def check_counts(path, counts, expect):
    """Every count equal to the path's own: expect names the kernels the
    path launches, every other count must be 0."""
    want = {name: 0 for name in counts}
    want.update(expect)
    if counts != want:
        raise AssertionError(f"{path}: launch counts {counts} != {want}")


def zero_counts():
    for fn, attr in kernel_counters().values():
        setattr(fn, attr, 0)


def read_counts(path, needed):
    """The launch counts after a path; raises if a kernel in `needed`
    never launched."""
    counts = {name: getattr(fn, attr)
              for name, (fn, attr) in kernel_counters().items()}
    phase(f"  {path} launches: {counts}")
    missing = [name for name in needed if not counts[name]]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing}")
    return counts


def recall(ids, ref_ids):
    """Mean over queries of |ids & ref_ids| / k."""
    ids = np.asarray(ids)
    ref = ref_ids.cpu().numpy()
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / len(b)
                          for a, b in zip(ids, ref)]))


def check_approximate(name, vals, ids, n_docs, k):
    vals, ids = np.asarray(vals), np.asarray(ids)
    if (vals.shape != (ids.shape[0], k) or not np.isfinite(vals).all()
            or ids.min() < 0 or ids.max() >= n_docs
            or any(len(set(row.tolist())) != k for row in ids)):
        raise AssertionError(f"{name}: bad result (shape {vals.shape}, ids "
                             f"{ids.min()}..{ids.max()}, or duplicates)")


def search(gen, dev, corpus, corpus_i8, dim_scale):
    """search_topk with every ported method, mips_topk_int8 and
    mips_topk_blockmax_pallas over SEARCH_Q queries at k = SEARCH_K."""
    from cocodr_tpu_torch.ops import mips_exact2
    from cocodr_tpu_torch.ops.mips_blockmax import mips_topk_blockmax_pallas
    from cocodr_tpu_torch.ops.mips_int8 import mips_topk_int8
    from cocodr_tpu_torch.parallel.topk import search_topk

    N = corpus.shape[0]
    x = torch.randn(SEARCH_Q, DIM, generator=gen, device=dev)
    q = (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    scores, ref_v, ref_i = exact_search(q, corpus, SEARCH_K)
    tol = 1e-4 * max(1.0, scores.abs().max().item())

    def host(fn):
        return lambda: tuple(t.cpu().numpy() for t in fn())

    runs = {m: (lambda m=m: search_topk(q, corpus, SEARCH_K, method=m,
                                        device=dev))
            for m in ("pallas", "exact2", "fast", "blockmax", "refined",
                      "naive")}
    runs["int8"] = host(lambda: mips_topk_int8(q, corpus_i8, dim_scale,
                                               SEARCH_K))
    runs["blockmax_pallas"] = host(lambda: mips_topk_blockmax_pallas(
        q, corpus, SEARCH_K))
    fallbacks = mips_exact2.mips_topk_exact2.fallbacks
    zero_counts()
    results = {name: fn() for name, fn in runs.items()}
    counts = read_counts("search", ["K2_dual_sweep", "K2_dual_sweep_packed",
                                    "K3_topk", "K6_int8_sweep",
                                    "K9_top2_sweep", "K10_block32_sweep"])
    fallbacks = mips_exact2.mips_topk_exact2.fallbacks - fallbacks
    phase(f"  exact2: {fallbacks} of 1 chunk fell back to the "
          f"hierarchical search")

    card = nvidia_smi()  # the card's name and power limit
    spans = {}
    for name, fn in runs.items():
        vals, ids = results[name]
        if name in ("fast", "int8"):
            check_approximate(name, vals, ids, N, SEARCH_K)
            r = recall(ids, ref_i)
            need = 0.99 if name == "fast" else 0.95
            if not r >= need:
                raise AssertionError(f"{name}: recall@{SEARCH_K} {r} < {need}")
            what = f"recall@{SEARCH_K} {r:.5f} (>= {need})"
        else:
            err = check_results(vals, ids, scores, ref_v, tol)
            what = f"exact, max score err {err:.3e}"
        walls, span_ms = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            fn()
            end.record()
            end.synchronize()
            walls.append(time.perf_counter() - t)
            span_ms.append(start.elapsed_time(end))
        wall = statistics.median(walls)
        spans[name] = statistics.median(span_ms)
        phase(f"  {name}: {SEARCH_Q / wall:.1f} queries/s ({wall * 1e3:.3f} "
              f"ms per {SEARCH_Q} queries, card span {spans[name]:.3f} ms), "
              f"{what} [{card}]")
    # K3's share of the searches that run it, traced after all the timings:
    # on the H100 a profiler trace between two timings slowed the second
    for name in ("pallas", "fast", "exact2", "int8"):
        k3_share(name, runs[name], spans[name])
    return counts


def k3_share(name, fn, span):
    """K3's launches in one search, and their device ms beside the search's
    card span, from a torch.profiler trace of three searches."""
    from cocodr_tpu_torch.ops import mips_hier

    before = mips_hier.topk.launches
    fn()
    launches = mips_hier.topk.launches - before
    split = kernel_split(fn, runs=3)
    if not split:
        phase(f"  {name}: K3 {launches} launches a search; its device time "
              f"not measured (the trace holds no device time)")
        return
    k3 = sum(ms for kern, ms in split.items() if "topk_kernel" in kern)
    busy = sum(split.values())
    phase(f"  {name}: K3 {launches} launches a search, {k3:.4f} ms of "
          f"device time ({100 * k3 / span:.1f}% of the {span:.3f} ms card "
          f"span; all kernels {busy:.3f} ms)")


# mode -> (ServeConfig flags, matmul_int8 tower, launches per call of the
# kernels other than the tower's FFN kernel, which launches once a layer)
SERVE_MODES = {
    "default": ({}, False, {"K2_dual_sweep": 1, "K3_topk": 3}),
    "fast_search": ({"fast_search": True}, False,
                    {"K2_dual_sweep_packed": 1, "K3_topk": 2}),
    "quantize_int8": ({"quantize_int8": True}, False,
                      {"K6_int8_sweep": 1, "K3_topk": 2}),
    "int8_encode": ({}, True, {"K2_dual_sweep": 1, "K3_topk": 3}),
    "exact_fp32": ({"exact_fp32": True}, False, {}),
}
EXACT_MODES = ("default", "int8_encode", "exact_fp32")


def serve(args, dev, corpus):
    """RetrievalService in each mode of SERVE_MODES. -> {mode: counts}."""
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder

    def tower(int8):
        # the same random weights from the seed; the int8 tower keeps its
        # FFN weights float32 and quantizes them per call (K7)
        cfg = BertConfig.base(dtype=torch.bfloat16, matmul_int8=int8)
        return build_dual_encoder("rdot_nll_condenser", cfg, device=dev,
                                  generator=torch.Generator().manual_seed(
                                      args.seed))

    models = {False: tower(False)}
    counts = {}
    for mode, (_, int8, _) in SERVE_MODES.items():
        if int8 not in models:
            models[int8] = tower(int8)
        counts[mode] = serve_mode(args, dev, corpus, models[int8], mode)
    return counts


def serve_mode(args, dev, corpus, model, mode):
    from cocodr_tpu_torch.pipelines.serve import RetrievalService, ServeConfig

    flags, int8, per_call = SERVE_MODES[mode]
    svc = RetrievalService(
        model, HashTokenizer(), corpus,
        cfg=ServeConfig(top_k=TOP_K, max_query_len=QUERY_LEN,
                        max_batch=BATCH, **flags),
        device=dev,
    )
    tower = "int8 FFN (K7)" if int8 else "bf16"
    phase(f"  {mode}: service up, BERT-base {tower}, {svc.n_docs} docs "
          f"resident as {svc.corpus.dtype}")
    rng = np.random.default_rng(args.seed)
    batches = [make_queries(rng, BATCH) for _ in range(3)]
    single = make_queries(rng, 1)
    svc.search(make_queries(rng, BATCH))  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    ffn_kernel = "K7_ffn_block_int8" if int8 else "K1_ffn_block"
    zero_counts()
    t = time.perf_counter()
    results = list(svc.search_stream(batches))
    stream_s = time.perf_counter() - t
    one = svc.search(single)
    calls = len(batches) + 1
    layers = model.cfg.bert.num_hidden_layers
    expect = {name: n * calls for name, n in per_call.items()}
    expect[ffn_kernel] = layers * calls
    counts = read_counts(f"serve {mode}", list(expect))
    check_counts(f"serve {mode}", counts, expect)

    errs, recalls = [], []
    with torch.inference_mode():
        for texts, (vals, ids) in zip(batches + [single],
                                      results + [one]):
            # the service's own bucket padding, so that the encoder runs
            # the same shapes and gives the same embeddings
            pad = svc._bucket(len(texts)) - len(texts)
            tok_ids, tok_mask = svc._tokenize(texts + [""] * pad)
            emb = model.query_emb(torch.from_numpy(tok_ids).to(dev),
                                  torch.from_numpy(tok_mask).to(dev))
            scores, ref_v, ref_i = exact_search(emb[:len(texts)], corpus,
                                                TOP_K)
            if mode in EXACT_MODES:
                tol = 1e-4 * max(1.0, scores.abs().max().item())
                errs.append(check_results(vals, ids, scores, ref_v, tol))
            else:
                check_approximate(mode, vals, ids, svc.n_docs, TOP_K)
                recalls.append(recall(ids, ref_i))
    if mode in EXACT_MODES:
        phase(f"  results equal the exact plain search: max score err "
              f"{max(errs):.3e} (tol 1e-4 x max |score|)")
    else:
        r = float(np.mean(recalls))
        phase(f"  recall@{TOP_K} against the exact plain search: {r:.5f} "
              f"(per batch {[round(x, 5) for x in recalls]})")
        if not r >= 0.9:
            raise AssertionError(f"{mode}: recall@{TOP_K} {r} < 0.9")

    n_timed = 10
    timed = [make_queries(rng, BATCH) for _ in range(n_timed)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in svc.search_stream(timed):
        pass
    torch.cuda.synchronize()
    per_batch = (time.perf_counter() - t) / n_timed
    t = time.perf_counter()
    svc.search(single)
    single_ms = (time.perf_counter() - t) * 1e3
    card = nvidia_smi()  # the card's name and power limit
    phase(f"  {mode} search_stream: {per_batch * 1e3:.3f} ms/batch of "
          f"{BATCH}, {BATCH / per_batch:.1f} queries/s over {n_timed} "
          f"batches (first 3-batch run {stream_s * 1e3:.1f} ms); single "
          f"query {single_ms:.3f} ms [{card}]")

    # where a batch's time goes: host tokenization, then the encoder's and
    # the search's spans on the card's timeline (CUDA events; a span also
    # holds any gap where the card waited for the host to launch)
    t = time.perf_counter()
    for _ in range(n_timed):
        tok_ids, tok_mask = svc._tokenize(timed[0])
    tok_ms = (time.perf_counter() - t) * 1e3 / n_timed
    ids_t = torch.from_numpy(tok_ids).to(dev)
    mask_t = torch.from_numpy(tok_mask).to(dev)
    with torch.inference_mode():
        emb = model.query_emb(ids_t, mask_t)
        enc_ms = time_ms(lambda: model.query_emb(ids_t, mask_t))
        search_ms = time_ms(lambda: svc._search(emb, TOP_K))
        # host time to enqueue the encoder alone: when it is near the
        # encoder's card span, the card waits on the host's launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n_timed):
            model.query_emb(ids_t, mask_t)
        enq_ms = (time.perf_counter() - t) * 1e3 / n_timed
        torch.cuda.synchronize()
    phase(f"  {mode} per batch of {BATCH}: tokenize {tok_ms:.3f} ms (host), "
          f"encode {enc_ms:.3f} ms, search {search_ms:.3f} ms (card spans); "
          f"encoder enqueue {enq_ms:.3f} ms (host) [{card}]")
    del svc
    return counts


def write_records(args, path):
    """ENC_DOCS records of lengths uniform in 16..128, token ids in
    [1000, 30522), through the port's RecordWriter. -> a TokenCache."""
    from cocodr_tpu_torch.data.records import RecordWriter, TokenCache

    rng = np.random.default_rng(args.seed)
    lengths = rng.integers(16, ENC_LEN + 1, ENC_DOCS)
    tokens = rng.integers(1000, 30522, (ENC_DOCS, ENC_LEN))
    with RecordWriter(path, ENC_LEN) as w:
        for n, row in zip(lengths, tokens):
            w.write(row[:n])
    return TokenCache(path)


# configuration -> (BertConfig changes, length buckets, records)
ENCODE_CONFIGS = {
    "a_default": ({}, (), ENC_DOCS),
    "b_buckets": ({}, (32, 64, 128), ENC_DOCS),
    "c_fused_attention": ({"attention_impl": "fused"}, (), ENC_DOCS),
    "d_matmul_int8": ({"matmul_int8": True}, (), ENC_DOCS),
    "e_bert_large": ({"large": True}, (), LARGE_DOCS),
}
CPU_DOCS = {"a_default": 16, "c_fused_attention": 16, "d_matmul_int8": 16,
            "e_bert_large": 4}
# min per-row cosine, card against the plain versions on the CPU: bf16
# activations rounded at other points after float32 sums in other orders
CPU_COSINE = 0.999
# min per-row cosine against (a): bucketing changes only the padding the
# attention masks, fused attention rounds the probabilities before PV;
# the int8 bound is tests/test_int8_encode.py's
VS_DEFAULT_COSINE = {"b_buckets": 0.999, "c_fused_attention": 0.999,
                     "d_matmul_int8": 0.99}


def cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def expected_encode_counts(name, bert, cache, buckets, n):
    """The launches of one encode configuration: one FFN kernel (K1, or K7
    with matmul_int8) per layer and batch, and K8 per layer and batch with
    fused attention (every bucket width is a multiple of 8)."""
    if buckets:
        lengths = cache.lengths()[:n]
        edges = (0,) + tuple(buckets)
        batches = sum(
            math.ceil(int(((lengths > lo) & (lengths <= hi)).sum())
                      / ENC_BATCH)
            for lo, hi in zip(edges, edges[1:]))
    else:
        batches = math.ceil(n / ENC_BATCH)
    per_batch = bert.num_hidden_layers * batches
    expect = {("K7_ffn_block_int8" if bert.matmul_int8 else "K1_ffn_block"):
              per_batch}
    if bert.attention_impl == "fused":
        expect["K8_attention"] = per_batch
    return expect, batches


def layer_breakdown(name, model, tokens, mask):
    """Card time of the first encoder layer and of its parts at a
    full-width batch (CUDA events, median of 5): self-attention (the Q, K,
    V projections and the attention itself, einsum or K8), the output
    projection with the residual add, and the rest of the layer, the FFN
    half-layer (K1 or K7)."""
    from cocodr_tpu_torch.models.bert import linear, make_attention_bias

    bert = model.encoder
    layer = bert.encoder.layer[0]
    dev = next(model.parameters()).device
    with torch.inference_mode():
        ids = torch.as_tensor(tokens).to(dev)
        bias = make_attention_bias(torch.as_tensor(mask).to(dev))
        pos = torch.arange(ids.shape[1], device=dev)[None, :]
        h = bert.embeddings(ids, torch.zeros_like(ids), pos)
        ctx = layer.attention.self(h, bias)
        attn = time_ms(lambda: layer.attention.self(h, bias), runs=5)
        proj = time_ms(lambda: h + linear(ctx, layer.attention.output.dense,
                                          bert.cfg.dtype), runs=5)
        whole = time_ms(lambda: layer(h, bias), runs=5)
    phase(f"  encode {name} layer 0 of {bert.cfg.num_hidden_layers}: "
          f"{whole:.3f} ms = self-attention {attn:.3f} + output projection "
          f"{proj:.3f} + FFN half-layer {whole - attn - proj:.3f} (card, "
          f"by difference)")


def encode_config(args, dev, cache, name):
    """encode_cache over one configuration -> (embeddings, counts)."""
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.pipelines.encode import (
        EncodeConfig,
        Encoder,
        encode_cache,
    )

    changes, buckets, n = ENCODE_CONFIGS[name]
    changes = dict(changes)
    make = BertConfig.large if changes.pop("large", False) else BertConfig.base
    bert = make(dtype=torch.bfloat16, **changes)
    model = build_dual_encoder("rdot_nll_condenser", bert, device=dev,
                               generator=torch.Generator().manual_seed(
                                   args.seed))
    enc = Encoder(model, is_query=False, device=dev)
    tokens, mask = cache.batch_with_mask(np.arange(ENC_BATCH))
    enc.collect(enc.dispatch(tokens, mask))  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    cfg = EncodeConfig(batch_size=ENC_BATCH, length_buckets=buckets)
    idx = np.arange(n)
    zero_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    out = encode_cache(enc, cache, cfg, indices=idx)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t
    span = start.elapsed_time(end)
    expect, batches = expected_encode_counts(name, bert, cache, buckets, n)
    counts = read_counts(f"encode {name}", list(expect))
    check_counts(f"encode {name}", counts, expect)
    if out.shape != (n, bert.hidden_size) or not np.isfinite(out).all():
        raise AssertionError(f"encode {name}: bad output {out.shape}")

    # the host's time to enqueue one full-width batch on an idle card (a
    # run of batches would fill the launch queue and time the card), beside
    # the batch's span on the card: when the two are close, the host's
    # launches bound encoding
    enq = []
    with torch.inference_mode():
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            enc(tokens, mask)
            enq.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        batch_ms = time_ms(lambda: enc(tokens, mask), runs=5)
    card = nvidia_smi()
    phase(f"  encode {name}: {n / wall:.1f} docs/s ({n} docs, {batches} "
          f"batches of {ENC_BATCH}, {wall:.3f} s host clock, card span "
          f"{span:.1f} ms); per full-width batch: card {batch_ms:.3f} ms, "
          f"host enqueue {statistics.median(enq):.3f} ms [{card}]")
    if not buckets:  # (b) runs (a)'s model
        layer_breakdown(name, model, tokens, mask)

    if name in CPU_DOCS:
        # the same model on the CPU takes the kernels' plain versions
        m = CPU_DOCS[name]
        cpu_enc = Encoder(copy.deepcopy(model).cpu(), device="cpu")
        ref = encode_cache(cpu_enc, cache, EncodeConfig(batch_size=m),
                           indices=np.arange(m), prefetch_depth=0)
        cos = cosines(out[:m], ref)
        phase(f"  encode {name}: {m} records re-encoded on the CPU through "
              f"the plain versions: min cosine {cos.min():.6f} (bound "
              f"{CPU_COSINE}), max abs diff "
              f"{np.abs(out[:m] - ref).max():.4f}")
        if not cos.min() >= CPU_COSINE:
            raise AssertionError(f"encode {name}: card and CPU disagree")
    del enc, model
    return out, counts


def encode(args, dev):
    """The encode phase -> {configuration: counts}."""
    counts, outs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        cache = write_records(args, os.path.join(tmp, "passages"))
        phase(f"  {len(cache)} records (max_len {cache.max_len}, lengths "
              f"16..128) written and mapped in "
              f"{time.perf_counter() - t:.2f} s")
        for name in ENCODE_CONFIGS:
            outs[name], counts[name] = encode_config(args, dev, cache, name)
            torch.cuda.empty_cache()
    for name, bound_cos in VS_DEFAULT_COSINE.items():
        cos = cosines(outs[name], outs["a_default"])
        phase(f"  encode {name} against a_default: min cosine "
              f"{cos.min():.6f}, mean {cos.mean():.6f} (bound {bound_cos})")
        if not cos.min() >= bound_cos:
            raise AssertionError(f"encode {name} disagrees with a_default")
    return counts


def write_triples(args, path, n):
    """n lines of `query \t positive \t negative`: queries of 4-15 and
    passages of 30-119 random words (hashed by HashTokenizer, truncated at
    TRAIN_LEN tokens)."""
    rng = np.random.default_rng(args.seed + 1)

    def text(lo, hi):
        return " ".join(f"w{x}" for x in rng.integers(0, 50000,
                                                       rng.integers(lo, hi)))

    with open(path, "w", encoding="utf8") as f:
        for _ in range(n):
            f.write(f"{text(4, 16)}\t{text(30, 120)}\t{text(30, 120)}\n")
    return path


def train_step_flops(bert, tokens):
    """Operations of one warmup step (three towers, `tokens` tokens of
    TRAIN_LEN-token sequences), counted from the code: per token and
    layer the forward's Q, K, V and output projections (8 H^2), the
    scores and the PV product (4 S H) and the FFN (4 H F); the backward
    twice the forward's; the backward's recompute of the FFN (K1's and
    K5's autograd.Functions run the XLA pair again, 4 H F)."""
    H, F, L = bert.hidden_size, bert.intermediate_size, bert.num_hidden_layers
    fwd = 8 * H * H + 4 * TRAIN_LEN * H + 4 * H * F
    return tokens * L * (3 * fwd + 4 * H * F)


class StepRecorder:
    """Wraps a train step: synchronises after each step and records its
    step number, loss (float), end time on the host clock and every
    kernel's launches in the step."""

    def __init__(self, step):
        self.step, self.records, self.launches = step, [], []

    def __call__(self, state, batch, gens):
        before = {n: getattr(f, a) for n, (f, a) in kernel_counters().items()}
        loss, acc = self.step(state, batch, gens)
        value = loss.item()  # waits for the card
        self.records.append((state.step, value, time.perf_counter()))
        self.launches.append({n: getattr(f, a) - before[n]
                              for n, (f, a) in kernel_counters().items()})
        return loss, acc


class CountingTokenizer(HashTokenizer):
    calls = 0

    def __call__(self, texts, **kw):
        self.calls += 1
        return super().__call__(texts, **kw)


def warmup_run(args, dev, path, ckpt, bert, steps, resume, dropout):
    """One run_warmup of a model built from the seed, to step `steps` ->
    (state, recorder, tokenizer)."""
    from cocodr_tpu_torch.core.configs import OptimizerConfig
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.pipelines.train_step import build_train_step
    from cocodr_tpu_torch.pipelines.warmup import WarmupConfig, run_warmup
    from cocodr_tpu_torch.utils.train_state import TrainState

    model = build_dual_encoder("rdot_nll_condenser", bert, device=dev,
                               generator=torch.Generator().manual_seed(
                                   args.seed))
    opt = OptimizerConfig(lr=2e-4, warmup_steps=5, total_steps=100
                          ).build(model.parameters())
    state = TrainState(model, opt)
    rec, tok = StepRecorder(build_train_step()), CountingTokenizer()
    cfg = WarmupConfig(max_seq_len=TRAIN_LEN, batch_size=TRAIN_BATCH,
                       num_epochs=1, save_steps=TRAIN_SAVE, max_steps=steps,
                       log_every=10 ** 9, keep_checkpoints=2)
    run_warmup(state, rec, path, tok, cfg, ckpt, resume=resume,
               dropout_seed=args.seed if dropout else None)
    return state, rec, tok


def check_steps(name, rec, first_step, last_step, per_step):
    """Steps first_step..last_step ran, each launching exactly per_step
    (every other kernel 0 times), each loss finite -> the losses."""
    for i, launched in enumerate(rec.launches):
        check_counts(f"{name} step {first_step + i}", launched, per_step)
    steps = [r[0] for r in rec.records]
    losses = [r[1] for r in rec.records]
    if steps != list(range(first_step, last_step + 1)):
        raise AssertionError(f"{name}: steps {steps}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss in {losses}")
    return losses


def step_phases(state, batch, seed, dev, runs=3):
    """A dropout step's forward (three towers and the loss), backward and
    optimizer (clip + LAMB): card ms (CUDA events) and the host's ms to
    issue each (host clock, no synchronisation inside the step; where the
    two are close, the card waits on the host), medians of `runs`."""
    from cocodr_tpu_torch.pipelines.train_step import (
        apply_gradients,
        dropout_generators,
        nll_loss,
    )

    card, host = [], []
    for _ in range(runs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        gens = dropout_generators(seed, state.step, dev)
        state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        ev[0].record()
        loss, _ = nll_loss(state.model, batch, gens)
        ev[1].record()
        t.append(time.perf_counter())
        loss.backward()
        ev[2].record()
        t.append(time.perf_counter())
        apply_gradients(state, 1.0)
        ev[3].record()
        t.append(time.perf_counter())
        ev[3].synchronize()
        card.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        host.append([(t[i + 1] - t[i]) * 1e3 for i in range(3)])
    return ([statistics.median(c[i] for c in card) for i in range(3)],
            [statistics.median(h[i] for h in host) for i in range(3)])


def step_busy(state, batch, seed, dev):
    """One dropout step under torch.profiler -> the card's kernel time
    summed from the trace, ms (0 when the trace holds no device time).
    The profiler's own host cost stretches the traced step's wall time
    2-3x, so the busy time is held against an unprofiled step's card
    span instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cocodr_tpu_torch.pipelines.train_step import (
        apply_gradients,
        dropout_generators,
        nll_loss,
    )

    gens = dropout_generators(seed, state.step, dev)
    state.optimizer.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss, _ = nll_loss(state.model, batch, gens)
        loss.backward()
        apply_gradients(state, 1.0)
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def compare_step(args, dev, path, bert):
    """One step at CMP_BATCH, dropout off, on the card (K1, K8) and on the
    CPU (their plain versions) from the same weights and batch: the loss
    and the clipped gradients (global cosine and the worst tensor's)."""
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.pipelines.train_step import (
        clip_by_global_norm_,
        nll_loss,
    )
    from cocodr_tpu_torch.pipelines.warmup import (
        TripleTextBatcher,
        stream_triples,
    )

    triples = [t for t, _ in zip(stream_triples(path), range(CMP_BATCH))]
    arrays = TripleTextBatcher(HashTokenizer(), TRAIN_LEN).collate(triples)
    model = build_dual_encoder("rdot_nll_condenser", bert, device=dev,
                               generator=torch.Generator().manual_seed(
                                   args.seed + 2))
    cpu_model = copy.deepcopy(model).cpu()
    out = {}
    zero_counts()
    for name, m in (("card", model), ("cpu", cpu_model)):
        d = next(m.parameters()).device
        t = time.perf_counter()
        loss, _ = nll_loss(m, {k: torch.from_numpy(v).to(d)
                               for k, v in arrays.items()})
        loss.backward()
        clip_by_global_norm_(m.parameters(), 1.0)
        out[name] = (loss.item(), {k: p.grad.detach().double().cpu()
                                   for k, p in m.named_parameters()})
        phase(f"  compare: {name} step {time.perf_counter() - t:.2f} s, "
              f"loss {out[name][0]:.6f}")
        if name == "card":
            counts = read_counts("compare (card)", ["K1_ffn_block",
                                                    "K8_attention"])
            check_counts("compare (card)", counts, {
                "K1_ffn_block": 3 * bert.num_hidden_layers,
                "K8_attention": 3 * bert.num_hidden_layers})
    (la, ga), (lb, gb) = out["card"], out["cpu"]
    rel, glob, worst, cos = step_agreement(la, ga, lb, gb)
    phase(f"  compare card vs CPU (batch {CMP_BATCH}, dropout off): loss "
          f"{la:.6f} vs {lb:.6f} (rel {rel:.2e}, bound {CMP_LOSS_RTOL}); "
          f"clipped-gradient cosine {glob:.6f} (bound {CMP_GLOBAL_COSINE}); "
          f"worst tensor {worst} {cos:.6f} (bound {CMP_TENSOR_COSINE})")
    if not steps_agree(rel, glob, cos):
        raise AssertionError("card and CPU train steps disagree")


def step_agreement(loss_a, grads_a, loss_b, grads_b):
    """Two train steps' losses and {name: gradient} -> (relative loss
    difference, global cosine of all gradients, the name and cosine of
    the worst tensor). The key projections' biases are left out of the
    worst: their exact gradient is zero (a softmax does not see a
    constant added to a row of scores), so theirs is rounding noise."""
    a = torch.cat([g.double().flatten() for g in grads_a.values()])
    b = torch.cat([grads_b[k].double().flatten() for k in grads_a])
    glob = (a @ b / (a.norm() * b.norm())).item()
    per = {}
    for k, ga in grads_a.items():
        if k.endswith("attention.self.key.bias"):
            continue
        ga, gb = ga.double().flatten(), grads_b[k].double().flatten()
        per[k] = (ga @ gb / (ga.norm() * gb.norm()).clamp_min(1e-300)).item()
    worst = min(per, key=per.get)
    return (abs(loss_a - loss_b) / max(abs(loss_b), 1e-6), glob, worst,
            per[worst])


def steps_agree(rel, glob, cos):
    return (rel <= CMP_LOSS_RTOL and glob >= CMP_GLOBAL_COSINE
            and cos >= CMP_TENSOR_COSINE)


def train(args, dev, k5_ms):
    """The train phase -> the dropout run's launch counts."""
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.pipelines.warmup import (
        TripleTextBatcher,
        stream_triples,
    )
    from cocodr_tpu_torch.utils.train_state import (
        latest_checkpoint,
        list_checkpoints,
        load_checkpoint,
    )

    bert = BertConfig.base(dtype=torch.bfloat16)
    layers = bert.num_hidden_layers
    with tempfile.TemporaryDirectory() as tmp:
        path = write_triples(args, os.path.join(tmp, "triples.tsv"),
                             TRAIN_BATCH * (TRAIN_RESUME + 2))
        ckpt = os.path.join(tmp, "ckpt")
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        state, rec, _ = warmup_run(args, dev, path, ckpt, bert, TRAIN_STEPS,
                                   resume=False, dropout=True)
        counts = read_counts("train (dropout)", ["K5_ffn"])
        check_counts("train (dropout)", counts,
                     {"K5_ffn": 3 * layers * TRAIN_STEPS})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = check_steps("train", rec, 1, TRAIN_STEPS,
                             {"K5_ffn": 3 * layers})
        # host-clock step intervals after 2 untimed steps, leaving out the
        # interval that holds the save at TRAIN_SAVE
        ends = {s: t for s, _, t in rec.records}
        gaps = [ends[s] - ends[s - 1] for s in range(3, TRAIN_STEPS + 1)
                if s != TRAIN_SAVE + 1]
        tps = TRAIN_BATCH * len(gaps) / sum(gaps)
        saved = [os.path.basename(p) for p in list_checkpoints(ckpt)]
        if saved != [f"checkpoint-{TRAIN_SAVE}", f"checkpoint-{TRAIN_STEPS}"]:
            raise AssertionError(f"checkpoints {saved}")
        final = {k: v.clone() for k, v in state.model.state_dict().items()}
        del state
        torch.cuda.empty_cache()

        # resume: a fresh model takes checkpoint-20 and skips 20 batches
        # before tokenizing them
        zero_counts()
        state, rec2, tok = warmup_run(args, dev, path, ckpt, bert,
                                      TRAIN_RESUME, resume=True, dropout=True)
        counts2 = read_counts("train (resume)", ["K5_ffn"])
        check_counts("train (resume)", counts2, {
            "K5_ffn": 3 * layers * (TRAIN_RESUME - TRAIN_STEPS)})
        losses += check_steps("train (resume)", rec2, TRAIN_STEPS + 1,
                              TRAIN_RESUME, {"K5_ffn": 3 * layers})
        # the tokenizer ran only for the batches after step 20 (3 calls a
        # batch, and up to 3 batches prefetched past the last step)
        if tok.calls > 3 * (TRAIN_RESUME - TRAIN_STEPS + 3):
            raise AssertionError(f"resume tokenized {tok.calls // 3} batches")
        check = copy.deepcopy(state)
        load_checkpoint(os.path.join(ckpt, f"checkpoint-{TRAIN_STEPS}"),
                        check)
        for k, v in check.model.state_dict().items():
            if not torch.equal(v, final[k]):
                raise AssertionError(f"checkpoint-{TRAIN_STEPS} lost {k}")
        del check, final
        if not latest_checkpoint(ckpt).endswith(f"-{TRAIN_RESUME}"):
            raise AssertionError("no checkpoint at the end of the resume")
        phase(f"  losses: steps 1-5 mean {statistics.mean(losses[:5]):.4f}, "
              f"steps {TRAIN_RESUME - 4}-{TRAIN_RESUME} mean "
              f"{statistics.mean(losses[-5:]):.4f}; all "
              f"{', '.join(f'{x:.4f}' for x in losses)}")

        triples = [t for t, _ in zip(stream_triples(path),
                                     range(TRAIN_BATCH))]
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 TripleTextBatcher(HashTokenizer(), TRAIN_LEN)
                 .collate(triples).items()}
        (fwd, bwd, opt), host = step_phases(state, batch, args.seed, dev)
        busy = step_busy(state, batch, args.seed, dev)
        span = fwd + bwd + opt
        phase(f"  one profiled step: card kernels busy {busy:.3f} ms against "
              f"an unprofiled step's {span:.3f} ms card span: busy share "
              + (f"{busy / span:.3f}" if busy > 0
                 else "not measured (the trace holds no device time)"))
        flops = train_step_flops(bert, 3 * TRAIN_T)
        b_ms = flops / BF16_FLOP_PER_S * 1e3
        card = nvidia_smi()
        phase(f"  train (dropout 0.1, batch {TRAIN_BATCH} x {TRAIN_LEN}): "
              f"{tps:.1f} triplets/s (host clock, {len(gaps)} steps after "
              f"2 untimed); card ms per step: forward {fwd:.3f}, backward "
              f"{bwd:.3f}, optimizer {opt:.3f} (total {fwd + bwd + opt:.3f});"
              f" host ms to issue them {host[0]:.3f}, {host[1]:.3f}, "
              f"{host[2]:.3f}; K5 {3 * layers} x {k5_ms:.4f} ms = "
              f"{100 * 3 * layers * k5_ms / fwd:.1f}% of the forward; peak "
              f"memory {peak:.2f} GiB; step bound {b_ms:.3f} ms "
              f"({flops / 1e12:.2f} TFLOP at 989 TFLOP/s, operations) "
              f"[{card}]")
        del state, batch
        torch.cuda.empty_cache()

        # no dropout, fused attention: K1 and K8 on every layer
        nodrop = BertConfig.base(dtype=torch.bfloat16,
                                 attention_impl="fused")
        zero_counts()
        state, rec3, _ = warmup_run(args, dev, path,
                                    os.path.join(tmp, "ckpt_nodrop"), nodrop,
                                    NODROP_STEPS, resume=False, dropout=False)
        counts3 = read_counts("train (no dropout, fused attention)",
                              ["K1_ffn_block", "K8_attention"])
        check_counts("train (no dropout, fused attention)", counts3, {
            "K1_ffn_block": 3 * layers * NODROP_STEPS,
            "K8_attention": 3 * layers * NODROP_STEPS})
        nd = check_steps("train (no dropout)", rec3, 1, NODROP_STEPS,
                         {"K1_ffn_block": 3 * layers,
                          "K8_attention": 3 * layers})
        ends = [t for _, _, t in rec3.records]
        nd_tps = TRAIN_BATCH * (len(ends) - 2) / (ends[-1] - ends[1])
        phase(f"  train (no dropout, fused attention): {nd_tps:.1f} "
              f"triplets/s over steps 3-{NODROP_STEPS}; losses "
              f"{', '.join(f'{x:.4f}' for x in nd)}")
        del state
        torch.cuda.empty_cache()

        compare_step(args, dev, path, nodrop)
    return counts


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    phase(f"environment: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs a GPU")
    smi = nvidia_smi()
    phase(f"  card: {smi}; devices: {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False

    import cocodr_tpu_torch
    from cocodr_tpu_torch.ops import _build, attention, ffn, mips_hier
    from cocodr_tpu_torch.ops import mips_int8

    if Path(cocodr_tpu_torch.__file__).resolve().parent.parent != ROOT:
        raise RuntimeError("cocodr_tpu_torch must come from this checkout")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    phase("build: nvcc -> " + str(_build.BUILD_ROOT))
    lib = _build.library()
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Function properties" in line:
            phase("  ptxas: " + line.strip())
    phase(f"  built={lib.built} in {lib.seconds:.2f} s: {lib.path}")
    check_stack_frames(lib.log)

    phase("kernel checks")
    k5 = check_k5(ffn, gen, dev)
    kernels = [check_k1(ffn, gen, dev), k5]
    corpus = make_corpus(gen, dev)
    kernels.append(check_k2(mips_hier, corpus, gen, dev))
    kernels.append(check_k3(mips_hier, gen, dev))
    kernels.append(check_k4(ffn, gen, dev))
    kernels.append(check_k7(ffn, gen, dev))
    check_map_cache(ffn, gen, dev)
    kernels.append(check_k8(attention, gen, dev))
    corpus_i8, dim_scale = mips_int8.quantize_corpus_int8(corpus)
    sweeps = check_sweeps(gen, dev, corpus, corpus_i8, dim_scale)
    check_sweep_shapes(gen, dev, corpus, corpus_i8)

    phase("search")
    search_counts = search(gen, dev, corpus, corpus_i8, dim_scale)
    del corpus_i8

    phase("serve")
    serve_counts = serve(args, dev, corpus)
    del corpus
    torch.cuda.empty_cache()

    phase("encode")
    encode_counts = encode(args, dev)
    torch.cuda.empty_cache()

    phase("train")
    train_counts = train(args, dev, k5["ms"])

    # each kernel's numbers at the shape of the path that launches it, and
    # its launches on that path: (path's counts, the wrapper's counter)
    paths = {"K1_ffn_block": (serve_counts["default"], "K1_ffn_block"),
             "K2_dual_sweep": (serve_counts["default"], "K2_dual_sweep"),
             "K3_topk": (search_counts, "K3_topk"),
             "K2_dual_sweep_packed": (serve_counts["fast_search"],
                                      "K2_dual_sweep_packed"),
             "K4_ffn_block_chunked": (encode_counts["e_bert_large"],
                                      "K1_ffn_block"),
             "K5_ffn": (train_counts, "K5_ffn"),
             "K6_int8_sweep": (serve_counts["quantize_int8"],
                               "K6_int8_sweep"),
             "K7_ffn_block_int8": (encode_counts["d_matmul_int8"],
                                   "K7_ffn_block_int8"),
             "K8_attention": (encode_counts["c_fused_attention"],
                              "K8_attention"),
             "K9_top2_sweep": (search_counts, "K9_top2_sweep"),
             "K10_block32_sweep": (search_counts, "K10_block32_sweep")}
    sources = {
        "K2_dual_sweep_packed": ("mips_sweep.cu", "pallas_mips.py:100",
                                 BATCH),
        "K6_int8_sweep": ("mips_int8.cu", "pallas_mips.py:63", BATCH),
        "K9_top2_sweep": ("mips_top2.cu", "pallas_mips.py:1059", SEARCH_Q),
        "K10_block32_sweep": ("mips_sweep.cu", "pallas_mips.py:24",
                              SEARCH_Q),
    }
    for name, (src, replaces, q_rows) in sources.items():
        kernels.append(dict(name=name, route="cuda",
                            source="cocodr_tpu_torch/csrc/" + src,
                            replaces="cocodr_tpu/ops/" + replaces,
                            library_ms=None, **sweeps[name, q_rows]))
    for entry in kernels:
        counts, counter = paths[entry["name"]]
        entry["launches"] = counts[counter]
    kernels.sort(key=lambda e: list(paths).index(e["name"]))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()


if __name__ == "__main__":
    main()
