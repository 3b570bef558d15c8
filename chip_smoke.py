#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cocodr_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--phases kernels,variants,...]

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
     bit for bit; K1 also at RoBERTa's LayerNorm eps 1e-5 and the
     multi-chunk encode's T = 64 x 4 x 512, K4 at eps 1e-5, K5 at a
     multi-chunk training step's T = 8 x 2,048, K8 at 256 chunk rows of
     S = 512 of which a quarter are all padding (every key masked);
     K4 (K1 at bert-large widths), K7 (W8A8 FFN
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
     by the loss and the clipped gradients' cosines;
  8. eval: random BERT-base weights from the seed (rdot_nll_condenser, bf16
     compute, float32 parameters) over two synthetic BEIR tasks of BEIR's
     published test sizes, through prepare_beir_task (the hashing
     tokenizer's `encode`) and evaluate_beir_task at top_k 1000 (K1 12 a
     batch, K2, K3): FiQA-2018's shape (57,638 docs at doc_len 128, 648
     queries) and SciFact's (5,183 docs at 256, 300 queries); the seconds
     of tokenize, encode, search and score, docs/s and the launches; the
     ids against an exact plain search of the same embeddings up to
     near-ties, the metrics against that search's (the card's row taken
     only where a relevant id moved by a near-tie), the first 256 FiQA docs
     and queries re-encoded on the CPU through the plain versions (cosine
     >= 0.999); then combined_mrr over the FiQA records with a
     top1000.dev-style candidate file; the model's parameters bit-equal
     and float32 after it all;
  9. ance-train: AnceStageConfig.base()'s model and optimizer (BERT-base,
     LAMB at 5e-6, batch 64, queries 64 and docs 128 tokens, G = 50, K = 3)
     through train_on_ann_file over token caches and an ann file written
     from the seed: 6 idro steps with dropout 0.1 (K5 36 a step), 3
     dro-greedy steps, then 2 idro steps without dropout and with fused
     attention (K1 and K8 36 a step); triplets/s, the card ms of an iDRO
     step's forward, group pass (a product per group, all 50 present),
     training backward and optimizer, the peak memory of the training run
     and of those all-group steps, dro_state_summary; then one idro step
     at batch 8, G 4, dropout off, on the card and on the CPU in float32
     from the same weights and DroState, held together by the loss, the
     clipped gradients' cosines, h_fun and the cosines between the groups'
     gradients that the group pass forms;
 10. ance-mine: hard-negative mining with AnceStageConfig.base()'s model
     (bf16 compute, random weights from the seed, eval batch 512, top 200
     candidates, 30 negatives in 5 splits, k-means into 50 groups, 500
     steps x 5 restarts): (a) two ance_rounds over 32,768 passages
     (16-128 tokens) and 8,192 train and 1,024 dev queries (4-23 tokens,
     one positive each in offset-space qrels), each mining then taking 3
     iDRO steps (G 50, K 3, dropout 0.1); round 1 must mine with the
     weights after round 0's steps; (b) the async pair over those records:
     mine_loop from checkpoint-0, train_loop for 2 nll steps (dropout), a
     second mine_loop that must mine from checkpoint-2, whose weights the
     loader must return equal to the state's; (c) mine() over MS MARCO's
     8,841,823 passages (row-normalised random rows from the seed, a host
     float32 array), 6,980 dev and 131,072 train queries: the corpus must
     reach the card once as one bf16 tensor padded to 8,843,264 rows
     (memory_allocated grows by it within 64 MiB), both searches must get
     that tensor with n_real 8,841,823, and the peak over mine() less the
     corpus must stay within 4 GiB of one lone search_topk of a query
     chunk. In every leg: each ann file parses, with 6 distinct negatives a
     line that are real rows and not the positive, groups in [0, 50); the
     train search's ids equal an exact plain search up to near-ties; the
     card's k-means walks step by step against the CPU's plain float32
     step (kmeans_walk); mine()'s time_* breakdown, docs/s of the corpus
     encode, q/s of the train search at 8.8M docs and the peak memory;
 11. coco: COCO pretraining at CocoStageConfig.base() (BERT-base, bf16
     compute, float32 parameters, random weights from the seed; c_head of 2
     layers from layer 6, late_mlm, MLM budget 0.17, LAMB at 1e-4 with a
     linear warmup of warmup_ratio 0.1) on a span corpus written by
     preprocess_corpus_to_spans (target length 30, break probability 0.1)
     from random-word documents, whole-word masks by a WordPiece-style
     stand-in tokenizer, batches of 200 docs = 400 spans x 128 tokens:
     (a) the direct step with dropout 0.1 through run_coco_pretrain (K5 14
     a step), 10 steps saving at 5 and 10, then a fresh state that loads
     checkpoint-5 and resumes through span_batches(start_batch=5) to step
     10 saving through AsyncSaver: the same batches bit for bit, the
     losses and parameters within bounds (the card's backward is not
     bitwise deterministic), the async checkpoint loading back equal;
     spans/s, the
     card and host ms of a step's forward, backward and optimizer, the MLM
     decoder's ms, the collator's host ms a batch, peak memory and the
     step's bound; (b) the grad cache (4 chunks of 100, dropout 0.1, 3
     steps, K5 104 a step), each chunk's pass-2 CLS equal to its pass-1 CLS
     bit for bit; (c) the cache step against the direct step from the same
     weights, dropout off (K1 104 and 14), by the loss and the gradients'
     cosines, a cache step with the next chunk's cotangents planted must
     fail them; (d) fused attention without dropout (K1 and K8 14 a step);
     (e) one direct step at 16 spans on the card and on the CPU through
     the plain versions in float32, by compare_step's bounds, a step with
     the c_head fed from hidden_states[5] planted must fail them;
 12. variants: the model variants, random weights from the seed, bf16
     compute. A BEIR-shaped task of 4,096 random-word documents of
     128-2,048 tokens and 512 queries tokenized by prepare_beir_task
     (records of 2,048 = 4 chunks of 512). (a) rdot_nll_multi_chunk on
     RoBERTa-base through encode_cache_multivector, 64 documents a batch,
     with einsum and with fused attention (K1 at T = 131,072, K8 at S =
     512): docs/s, rows/s, card ms a batch; row2doc against the documents'
     real chunks, six chunks (partly padded ones among them) against the
     CPU's float32 rows by cosine, RoBERTa positions replaced by arange
     planted must fail; (b) rdot_nll on RoBERTa-large through encode_cache
     (2,048 records of up to 128 tokens, batch 256, K4 24 a batch) against
     the CPU; (c) evaluate_beir_task with (a)'s fused model at top 1000
     over the chunk rows (K1, K8, K2, K3): seconds by stage, row ids
     against an exact plain search, documents' relevant ranks moved only
     by near-ties, metrics recomputed; (d) one mine() round with that
     model (2,048 train and 256 dev queries, top 200): the rows placed
     once, negatives document ids, the _mv emb cache and its row map,
     time_* and peak memory; (e) nll_multichunk with dropout through
     train_on_ann_file over (d)'s ann file (batch 8, queries 64, documents
     2,048: K5 36 a step): triplets/s, card ms by phase, peak memory; then
     an nll and a lane iDRO step (fused attention, dropout off, documents
     of one real chunk and one all padding) against the CPU's float32
     step; (f) DPR on BERT-base through run_warmup (batch 64 x 128, 5
     steps, dropout: K5 36 a step), every parameter of both towers and
     poolers given a gradient and LAMB moments, the checkpoint loaded back;
     an nll step and a two-tower iDRO step against the CPU, a group pass
     over the query tower alone planted must fail the cosine bound. Every
     leg predicts its launches before it runs.
Every path (the search phase, each serve mode, each encode configuration,
each training run, each eval task, combined_mrr, each mining round, each
COCO leg, each variants leg) runs
with every kernel's launch count set to 0 just
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
import itertools  # noqa: E402
import dataclasses  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
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
# COCO (CocoStageConfig.base()): 200 docs = 400 spans of 128 tokens a step,
# the grad cache's chunks of 100 spans
COCO_SPANS, COCO_LEN, COCO_CHUNK = 400, 128, 100
COCO_T = COCO_SPANS * COCO_LEN  # T of K1 and K5 in a direct COCO step
CMP_BATCH = 8  # the card-against-CPU step, at full depth
# the model variants (phase 12): documents of up to 4 chunks of 512 tokens
# (rdot_nll_multi_chunk on RoBERTa-base, LayerNorm eps 1e-5), encoded 64
# documents a batch; multi-chunk training at 8 triplets a step
VAR_DOCS, VAR_DOC_LEN, VAR_CHUNK, VAR_BATCH = 4096, 2048, 512, 64
VAR_T = VAR_BATCH * VAR_DOC_LEN  # T of K1 in a multi-chunk encode batch
ROBERTA_EPS = 1e-5
MC_TRAIN_BATCH = 8
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
    """Stand-in tokenizer with the HuggingFace call and `encode`
    signatures, for the smoke only: [CLS]=101, words hashed into ids
    1000..30521, [SEP]=102, [PAD]=0."""

    def encode(self, text, add_special_tokens=True, max_length=512,
               truncation=True):
        words = text.lower().split()[:max_length - 2]
        return ([101] + [1000 + zlib.crc32(w.encode()) % (30522 - 1000)
                         for w in words] + [102])

    def __call__(self, texts, padding="max_length", truncation=True,
                 max_length=64, return_tensors="np"):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            toks = self.encode(text, max_length=max_length)
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
    """K1 at bert-base widths, bf16, at FFN_CHECK_T and COCO's T (a cache
    chunk's 100 * 128 and a step's 400 * 128), and at RoBERTa's LayerNorm
    eps 1e-5 at the multi-chunk encode's T = 64 docs x 4 chunks x 512;
    timed at T = 64 * 64 tokens (serving) and the encode path's T = 256 *
    128."""
    H, F = 768, 3072
    errs = [check_ffn("K1", ffn.fused_ffn_block, ffn.ffn_block_reference,
                      ffn_inputs(gen, dev, T, H, F), f"T={T} H={H} F={F}",
                      K1_MAX_SHARE)
            for T in FFN_CHECK_T + (COCO_CHUNK * COCO_LEN, COCO_T)]
    errs.append(check_ffn(
        "K1", ffn.fused_ffn_block, ffn.ffn_block_reference,
        ffn_inputs(gen, dev, VAR_T, H, F) + ("gelu", ROBERTA_EPS),
        f"T={VAR_T} H={H} F={F} eps {ROBERTA_EPS}", K1_MAX_SHARE))
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
    H = 1024, F = 4096) is K1's function; K1 at FFN_CHECK_T, and at the
    RoBERTa-large encode's T = 256 * 128 with eps 1e-5, timed at the
    encode path's T."""
    H, F = 1024, 4096
    errs = [check_ffn("K4 (K1)", ffn.fused_ffn_block, ffn.ffn_block_reference,
                      ffn_inputs(gen, dev, T, H, F), f"T={T} H={H} F={F}",
                      K1_MAX_SHARE)
            for T in FFN_CHECK_T]
    errs.append(check_ffn(
        "K4 (K1)", ffn.fused_ffn_block, ffn.ffn_block_reference,
        ffn_inputs(gen, dev, ENC_TOKENS, H, F) + ("gelu", ROBERTA_EPS),
        f"T={ENC_TOKENS} H={H} F={F} eps {ROBERTA_EPS}", K1_MAX_SHARE))
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
    step), the JAX warmup preset's T = 256 * 128 and COCO's (100 * 128 and
    400 * 128) and a multi-chunk training step's document tower (T = 8 x
    2,048); timed at the warmup path's two. Besides the max-abs bound, the
    share of outputs that differ at
    all stays under K5_MAX_SHARE: on the CPU (tests/test_torch_ffn.py,
    test_k5_share_limit_*; T = 128) sums in another order move 0.5% of
    them, a moved rounding point (h in float32, a bf16 pre-activation, y
    rounded before b2) 27-59%. -> the summary entry of T = TRAIN_T."""
    H, F = 768, 3072
    errs, out = [], None
    for T in sorted(set(FFN_CHECK_T + (TRAIN_T, 4 * TRAIN_T,
                                       COCO_CHUNK * COCO_LEN, COCO_T,
                                       MC_TRAIN_BATCH * VAR_DOC_LEN))):
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
    padding bias (lengths 16..128), and at a COCO step's B = 400, timed
    (the encode shape) in turns with
    scaled_dot_product_attention on the same inputs (time_turns; SDPA is
    timed only: it defers no rounding the way K8 does). Also odd shapes:
    bucket widths, S not a multiple of 16, the kernel's two-pass schedule
    (S > 128) with its shared-memory ring two deep (S = 384) and one deep
    (S = 392, 512); and the multi-chunk encode's B = 256 chunk rows at
    S = 512, a quarter of them all padding: every key of such a row
    carries the -1e9 bias, s - 1e9 rounds every score alike in float32 and
    the plain version's softmax is uniform (the mean of v); timed there
    beside the plain version.
    Besides the bound, the share of outputs that differ at all stays under
    K8_MAX_SHARE: on the CPU (tests/test_torch_attention.py,
    test_k8_share_limit_separates_rounding_points; B = 16, S = 128,
    N = 12) sums in another order (float64) move 0.01% of them, while a
    softmax normalised after the PV product (an online softmax) moves 47%
    and float32 probabilities 41%, all inside the max-abs bound."""
    import torch.nn.functional as F

    err = 0.0
    for B, S, N in ((ENC_BATCH, ENC_LEN, 12), (COCO_SPANS, COCO_LEN, 12),
                    (ENC_BATCH, 32, 12),
                    (ENC_BATCH, 64, 16), (8, 200, 16), (4, 384, 12),
                    (4, 392, 12), (4, 512, 16), (3, 40, 3),
                    (4 * VAR_BATCH, VAR_CHUNK, 12)):
        q, k, v = (torch.randn(B, S, N, 64, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        lens = torch.randint(min(16, S), S + 1, (B,), generator=gen,
                             device=dev)
        empty = S == VAR_CHUNK and B == 4 * VAR_BATCH
        if empty:  # the all-pad chunks of multi-chunk documents
            lens[3::4] = 0
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
              f"(limit {K8_MAX_SHARE:.0e})"
              + (f"; {int((lens == 0).sum())} rows with every key masked"
                 if empty else ""))
        if (not e <= tol or not share <= K8_MAX_SHARE
                or not torch.isfinite(got).all()):
            raise AssertionError(f"K8 disagrees with its plain version: max "
                                 f"abs err {e}, share differing {share}")
        err = max(err, e)
        if empty:
            mask = bias[:, None, None, :].to(torch.bfloat16)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            ms, lib = time_turns(
                lambda: att.fused_attention_seq_major(q, k, v, bias, 0.125),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=0.125), 20)
            plain = time_ms(lambda: att.attention_reference(q, k, v, bias,
                                                            0.125), runs=3)
            b_ms, b_by = bound(4 * B * S * N * 64 * 2 + B * S * 4,
                               4 * B * N * S * S * 64, BF16_FLOP_PER_S)
            phase(f"  K8 B={B} S={S} N={N}: kernel {ms:.4f} ms, "
                  f"scaled_dot_product_attention {lib:.4f} ms (in turns, 20 "
                  f"launches an event pair); plain {plain:.4f} ms; bound "
                  f"{b_ms:.4f} ms ({b_by})")
        if (B, S) != (ENC_BATCH, ENC_LEN):
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


def write_records(args, path, n=ENC_DOCS):
    """n records of lengths uniform in 16..128, token ids in [1000,
    30522), through the port's RecordWriter. -> a TokenCache."""
    from cocodr_tpu_torch.data.records import RecordWriter, TokenCache

    rng = np.random.default_rng(args.seed)
    lengths = rng.integers(16, ENC_LEN + 1, n)
    tokens = rng.integers(1000, 30522, (n, ENC_LEN))
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
        layer_breakdown(name, enc.model, tokens, mask)

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
    twice the forward's. The backward's recompute of the FFN (K1's and
    K5's autograd.Functions run the pair again, 4 H F) is this code's
    choice, not the function's, and is left out."""
    H, F, L = bert.hidden_size, bert.intermediate_size, bert.num_hidden_layers
    fwd = 8 * H * H + 4 * TRAIN_LEN * H + 4 * H * F
    return tokens * L * 3 * fwd


class StepRecorder:
    """Wraps a train step: synchronises after each step and records its
    step number, loss (float), end time on the host clock and every
    kernel's launches in the step."""

    def __init__(self, step):
        self.step, self.records, self.launches = step, [], []

    def __call__(self, state, batch, gens):
        before = {n: getattr(f, a) for n, (f, a) in kernel_counters().items()}
        out = self.step(state, batch, gens)  # (loss, acc) or a metrics dict
        value = (out["loss"] if isinstance(out, dict) else out[0]).item()
        self.records.append((state.step, value, time.perf_counter()))
        self.launches.append({n: getattr(f, a) - before[n]
                              for n, (f, a) in kernel_counters().items()})
        return out


class CountingTokenizer(HashTokenizer):
    calls = 0

    def __call__(self, texts, **kw):
        self.calls += 1
        return super().__call__(texts, **kw)


def warmup_run(args, dev, path, ckpt, bert, steps, resume, dropout,
               model_type="rdot_nll_condenser"):
    """One run_warmup of a model built from the seed, to step `steps` ->
    (state, recorder, tokenizer)."""
    from cocodr_tpu_torch.core.configs import OptimizerConfig
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.pipelines.train_step import build_train_step
    from cocodr_tpu_torch.pipelines.warmup import WarmupConfig, run_warmup
    from cocodr_tpu_torch.utils.train_state import TrainState

    model = build_dual_encoder(model_type, bert, device=dev,
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


def step_phases(state, prepare, runs=3):
    """A step's forward (prepare(state) -> a function that returns the
    loss; prepare makes the dropout generators before the timed region),
    backward and optimizer (clip + LAMB): card ms (CUDA events) and the
    host's ms to issue each (host clock, no synchronisation inside the
    step; where the two are close, the card waits on the host), medians
    of `runs`."""
    from cocodr_tpu_torch.pipelines.train_step import apply_gradients

    card, host = [], []
    for _ in range(runs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        forward = prepare(state)
        state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        ev[0].record()
        loss = forward()
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


def step_busy(state, prepare, top=0):
    """One step (prepare(state)() -> the loss, backward, clip + LAMB) under
    torch.profiler -> (the card's kernel time summed from the trace, ms,
    0 when the trace holds no device time; the `top` kernels by device
    time, [(name, ms)]). The profiler's own host cost stretches the traced
    step's wall time 2-3x, so the busy time is held against an unprofiled
    step's card span instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cocodr_tpu_torch.pipelines.train_step import apply_gradients

    forward = prepare(state)
    state.optimizer.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss = forward()
        loss.backward()
        apply_gradients(state, 1.0)
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total / 1e3, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    return (sum(ms for ms, _ in kernels),
            [(name, ms) for ms, name in kernels[:top]])


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
    from cocodr_tpu_torch.pipelines.train_step import (
        dropout_generators,
        nll_loss,
    )
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
        def warmup_loss(st):
            gens = dropout_generators(args.seed, st.step, dev)
            return lambda: nll_loss(st.model, batch, gens)[0]

        (fwd, bwd, opt), host = step_phases(state, warmup_loss)
        busy, _ = step_busy(state, warmup_loss)
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


# --- eval: BEIR-shaped tasks and MS MARCO-style MRR ------------------------

# BEIR's published test sizes (docs, queries) of two tasks, with random
# words: FiQA-2018 at doc_len 128, SciFact (a long-doc task) at 256
BEIR_SHAPES = {
    "fiqa": dict(docs=57_638, queries=648, words=(40, 200), title=False,
                 rel=(1, 5)),
    "scifact": dict(docs=5_183, queries=300, words=(100, 300), title=True,
                    rel=(1, 2)),
}
EVAL_TOP_K = 1000
EVAL_CPU_ROWS = 256  # FiQA docs and queries re-encoded on the CPU
EVAL_CANDIDATES = 1000  # per query in the top1000.dev-style file
EVAL_VOCAB = 30_000


def write_beir_task(rng, root, name, shape=None):
    """A BEIR task directory (corpus.jsonl, queries.jsonl, qrels/test.tsv)
    of random words in the shape BEIR_SHAPES[name] (or `shape`); each
    query holds 5-19 words of its first relevant document."""
    shape = shape or BEIR_SHAPES[name]
    data = os.path.join(root, name)
    os.makedirs(os.path.join(data, "qrels"))
    vocab = np.array([f"w{i}" for i in range(EVAL_VOCAB)])
    lengths = rng.integers(shape["words"][0], shape["words"][1] + 1,
                           shape["docs"])
    words = rng.integers(0, EVAL_VOCAB, int(lengths.sum()))
    starts = np.concatenate([[0], np.cumsum(lengths)])
    with open(os.path.join(data, "corpus.jsonl"), "w") as f:
        for i in range(shape["docs"]):
            ws = vocab[words[starts[i]:starts[i + 1]]]
            title = " ".join(ws[:8]) if shape["title"] else ""
            f.write(json.dumps({"_id": f"{name}-d{i}", "title": title,
                                "text": " ".join(ws)}) + "\n")
    with open(os.path.join(data, "queries.jsonl"), "w") as fq, \
            open(os.path.join(data, "qrels", "test.tsv"), "w") as fr:
        fr.write("query-id\tcorpus-id\tscore\n")
        for j in range(shape["queries"]):
            rel = rng.choice(shape["docs"], rng.integers(
                shape["rel"][0], shape["rel"][1] + 1), replace=False)
            src = words[starts[rel[0]]:starts[rel[0] + 1]]
            q = vocab[rng.choice(src, min(len(src), rng.integers(5, 20)),
                                 replace=False)]
            fq.write(json.dumps({"_id": f"{name}-q{j}",
                                 "text": " ".join(q)}) + "\n")
            for d in rel:
                fr.write(f"{name}-q{j}\t{name}-d{d}\t1\n")
    return data


def recorded_eval(eb, model, paths, cfg, dev):
    """evaluate_beir_task with its encode_cache, encode_cache_multivector
    and search_topk wrapped to keep their outputs and host-clock seconds
    -> (metrics, record)."""
    rec = {"encode_s": [], "emb": []}
    encode_fn, search_fn = eb.encode_cache, eb.search_topk
    mv_fn = eb.encode_cache_multivector

    def encode(encoder, cache, ecfg):
        t = time.perf_counter()
        out = encode_fn(encoder, cache, ecfg)
        rec["encode_s"].append(time.perf_counter() - t)
        rec["emb"].append(out)
        return out

    def encode_mv(encoder, cache, ecfg, chunk_len):
        t = time.perf_counter()
        out = mv_fn(encoder, cache, ecfg, chunk_len=chunk_len)
        rec["mv_s"], rec["mv"] = time.perf_counter() - t, out
        return out

    def search(queries, corpus, k, **kw):
        t = time.perf_counter()
        vals, ids = search_fn(queries, corpus, k, **kw)
        rec["search_s"] = time.perf_counter() - t
        rec["vals"], rec["ids"] = vals, ids
        return vals, ids

    eb.encode_cache, eb.search_topk = encode, search
    eb.encode_cache_multivector = encode_mv
    try:
        t = time.perf_counter()
        metrics = eb.evaluate_beir_task(model, *paths, cfg, device=dev)
        rec["total_s"] = time.perf_counter() - t
    finally:
        eb.encode_cache, eb.search_topk = encode_fn, search_fn
        eb.encode_cache_multivector = mv_fn
    return metrics, rec


def near_tie_moves(plain, card, ref_v, rel, rel_scores, tol):
    """The rows in which a relevant document's rank (or its absence from
    the top k) differs between the card's ids and the exact plain
    search's; raises unless each such move is a near-tie: a relevant
    document at the card's rank r scores within tol of the exact r-th
    score, one that the card leaves out within tol of the exact k-th.
    plain, card [n_q, k] ids; ref_v [n_q, k] the exact scores in order;
    rel[r] row r's relevant ids, rel_scores[r] their exact scores."""
    k = plain.shape[1]
    moved = []
    for r in range(len(plain)):
        at_plain = {d: i for i, d in enumerate(plain[r].tolist())}
        at_card = {d: i for i, d in enumerate(card[r].tolist())}
        for d, s in zip(rel[r], rel_scores[r]):
            rc = at_card.get(d, k)
            if rc == at_plain.get(d, k):
                continue
            off = abs(s - ref_v[r, rc]) if rc < k else s - ref_v[r, k - 1]
            if not off <= tol:
                raise AssertionError(
                    f"row {r}: relevant id {d} at rank {rc} of the card's "
                    f"top {k} scores {s}, {off} off the exact search "
                    f"(tol {tol})")
            moved.append(r)
    return sorted(set(moved))


def eval_task(args, dev, model, root, name):
    """prepare_beir_task + evaluate_beir_task of one BEIR-shaped task on the
    card; its ids against an exact plain search, its metrics against that
    search's -> (paths, (corpus cache, query cache, corpus embeddings,
    query embeddings))."""
    from cocodr_tpu_torch.data.records import TokenCache
    from cocodr_tpu_torch.evals.metrics import evaluate_run, run_from_topk
    from cocodr_tpu_torch.pipelines import eval_beir as eb

    rng = np.random.default_rng([args.seed, len(name)])
    data = write_beir_task(rng, root, name)
    cfg = eb.BeirEvalConfig.for_task(name, top_k=EVAL_TOP_K)
    t = time.perf_counter()
    paths = eb.prepare_beir_task(data, os.path.join(root, name + "_work"),
                                 HashTokenizer(), cfg)
    tok_s = time.perf_counter() - t
    corpus_path, query_path, d2o, q2o, qrels = paths
    n_docs, n_q = len(d2o), len(q2o)

    zero_counts()
    metrics, rec = recorded_eval(eb, model, paths, cfg, dev)
    counts = read_counts(f"eval {name}", ["K1_ffn_block", "K2_dual_sweep",
                                         "K3_topk"])
    L = model.cfg.bert.num_hidden_layers
    batches = (math.ceil(n_docs / cfg.batch_size)
               + math.ceil(n_q / cfg.batch_size))
    check_counts(f"eval {name}", counts, {
        "K1_ffn_block": L * batches, "K2_dual_sweep": 1,
        "K3_topk": counts["K3_topk"]})
    corpus_emb, query_emb = rec["emb"]
    score_s = rec["total_s"] - sum(rec["encode_s"]) - rec["search_s"]
    card = nvidia_smi()
    phase(f"  eval {name} ({n_docs} docs at {cfg.doc_len}, {n_q} queries "
          f"at {cfg.query_len}, top {cfg.top_k}): tokenize {tok_s:.3f} s, "
          f"encode {sum(rec['encode_s']):.3f} s ({n_docs / rec['encode_s'][0]:.1f}"
          f" docs/s), search {rec['search_s']:.3f} s, score {score_s:.3f} s "
          f"(host clock); K1 {counts['K1_ffn_block']}, K2 "
          f"{counts['K2_dual_sweep']}, K3 {counts['K3_topk']} launches "
          f"[{card}]")

    # the card's ids against an exact plain search of the same embeddings
    k = rec["ids"].shape[1]
    corpus = torch.from_numpy(corpus_emb).to(dev).to(torch.bfloat16)
    scores, ref_v, ref_i = exact_search(torch.from_numpy(query_emb).to(dev),
                                        corpus, k)
    tol = 1e-4 * scores.abs().max().item()
    err = check_results(rec["vals"], rec["ids"], scores, ref_v, tol)
    off2doc = {v: d for d, v in d2o.items()}
    qids = [q for q, _ in sorted(q2o.items(), key=lambda kv: kv[1])]
    rel = [[d2o[d] for d in qrels[q]] for q in qids]
    rel_scores = [scores[r, rel[r]].tolist() for r in range(n_q)]
    del scores, corpus
    # metrics: every judged document is relevant here, so a row's metrics
    # are a function of its relevant documents' ranks. The card's row
    # stands in for the plain one only where such a rank moved, and only
    # by a near-tie; the plain run so patched must give the card's metrics
    plain, card_ids = ref_i.cpu().numpy(), np.asarray(rec["ids"])
    differ = sum(not np.array_equal(plain[r], card_ids[r])
                 for r in range(n_q))
    swapped = sum(set(plain[r].tolist()) != set(card_ids[r].tolist())
                  for r in range(n_q))
    moved = near_tie_moves(plain, card_ids, ref_v.cpu().numpy(), rel,
                           rel_scores, tol)
    patched = plain.copy()
    patched[moved] = card_ids[moved]

    def score(ids):
        return evaluate_run(run_from_topk(qids, ids, id_map=off2doc), qrels,
                            ndcg_k=cfg.ndcg_k, recall_ks=cfg.recall_ks)

    want = score(patched)
    if metrics != want:
        raise AssertionError(f"eval {name}: metrics {metrics} != {want}")
    pure = score(plain)
    delta = max(abs(metrics[m] - pure[m]) for m in metrics)
    phase(f"  eval {name}: ids equal the exact plain search up to near-ties "
          f"(max score err {err:.3e}, tol {tol:.3e}; {differ} of {n_q} "
          f"rows order near-ties otherwise, {swapped} of them swap an id at "
          f"the k-th score); metrics equal the plain run's with the "
          f"{len(moved)} rows where a relevant id moved by a near-tie taken "
          f"from the card (without them: max |diff| {delta:.2e}); "
          f"ndcg@10 {metrics['ndcg_cut_10']:.4f}, recall@1000 "
          f"{metrics['recall_1000']:.4f}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"eval {name}: non-finite metrics {metrics}")
    return paths, (TokenCache(corpus_path), TokenCache(query_path),
                   corpus_emb, query_emb)


def eval_cpu_rows(model, caches):
    """The first EVAL_CPU_ROWS docs and queries re-encoded on the CPU
    through the plain versions, against the card's rows (cosine)."""
    from cocodr_tpu_torch.pipelines.encode import (
        EncodeConfig,
        Encoder,
        encode_cache,
    )

    corpus_cache, query_cache, corpus_emb, query_emb = caches
    cpu_model = copy.deepcopy(model).cpu()
    for what, cache, emb, is_query, buckets in (
            ("docs", corpus_cache, corpus_emb, False, ()),
            ("queries", query_cache, query_emb, True, (16, 32, 64))):
        t = time.perf_counter()
        ref = encode_cache(Encoder(cpu_model, is_query=is_query,
                                   device="cpu"), cache,
                           EncodeConfig(batch_size=64,
                                        length_buckets=buckets),
                           indices=np.arange(EVAL_CPU_ROWS),
                           prefetch_depth=0)
        cos = cosines(emb[:EVAL_CPU_ROWS], ref)
        phase(f"  eval fiqa: first {EVAL_CPU_ROWS} {what} re-encoded on the "
              f"CPU through the plain versions in "
              f"{time.perf_counter() - t:.1f} s: min cosine {cos.min():.6f} "
              f"(bound {CPU_COSINE})")
        if not cos.min() >= CPU_COSINE:
            raise AssertionError(f"eval {what}: card and CPU disagree")


def eval_mrr(args, dev, model, root, paths):
    """combined_mrr over the FiQA-shaped records, with a top1000.dev-style
    candidate file (qid \\t pid \\t query \\t passage)."""
    from cocodr_tpu_torch.data.records import TokenCache
    from cocodr_tpu_torch.evals.mrr_eval import combined_mrr, load_top_dev

    corpus_path, query_path, d2o, q2o, qrels = paths
    rng = np.random.default_rng(args.seed + 5)
    n_docs = len(d2o)
    qrels_off = {q2o[q]: [d2o[d] for d in rel] for q, rel in qrels.items()}
    top_dev = os.path.join(root, "top1000.dev")
    with open(top_dev, "w") as f:
        for q, rel in sorted(qrels_off.items()):
            cands = np.concatenate([rel, rng.choice(
                n_docs, EVAL_CANDIDATES - len(rel), replace=False)])
            for d in rng.permutation(np.unique(cands)):
                f.write(f"{100_000 + q}\t{5_000_000 + d}\tquery\tpassage\n")
    cands = load_top_dev(top_dev, {100_000 + i: i for i in range(len(q2o))},
                         {5_000_000 + i: i for i in range(n_docs)})
    zero_counts()
    t = time.perf_counter()
    out = combined_mrr(model, TokenCache(query_path), TokenCache(corpus_path),
                       qrels_off, candidates=cands, top_k=10, device=dev)
    secs = time.perf_counter() - t
    counts = read_counts("eval combined_mrr", ["K1_ffn_block",
                                               "K2_dual_sweep", "K3_topk"])
    L = model.cfg.bert.num_hidden_layers
    check_counts("eval combined_mrr", counts, {
        "K1_ffn_block": L * (math.ceil(n_docs / 512)
                             + math.ceil(len(q2o) / 512)),
        "K2_dual_sweep": 1, "K3_topk": counts["K3_topk"]})
    phase(f"  eval combined_mrr (FiQA records, {len(cands)} queries x "
          f"{EVAL_CANDIDATES} candidates): {out} in {secs:.3f} s (host "
          f"clock)")
    if (out["QueriesRanked"] != len(q2o)
            or not all(0.0 <= out[m] <= 1.0
                       for m in ("MRR @10", "rerank_MRR @10"))):
        raise AssertionError(f"combined_mrr: bad result {out}")


def evaluate(args, dev):
    """The eval phase: random BERT-base weights from the seed, bf16
    compute, float32 parameters that the eval must not touch. Each path's
    launches are checked and printed here."""
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder

    model = build_dual_encoder("rdot_nll_condenser",
                               BertConfig.base(dtype=torch.bfloat16),
                               device=dev, generator=torch.Generator()
                               .manual_seed(args.seed + 4))
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with tempfile.TemporaryDirectory() as root:
        paths, caches = eval_task(args, dev, model, root, "fiqa")
        eval_task(args, dev, model, root, "scifact")
        eval_mrr(args, dev, model, root, paths)
        torch.cuda.empty_cache()
        eval_cpu_rows(model, caches)
    for k, v in model.state_dict().items():
        if v.dtype != torch.float32 or not torch.equal(v, before[k]):
            raise AssertionError(f"eval changed parameter {k}")
    if model.training or not all(p.requires_grad
                                 for p in model.parameters()):
        raise AssertionError("eval changed the model's mode or grad flags")
    phase("  eval: the model's parameters are bit-equal and float32 after "
          "the eval")


# --- ance-train: DRO training on mined triplets ----------------------------

ANCE_QUERIES = 512  # query records (64 tokens)
ANCE_DOCS = 8192  # passage records (128 tokens)
ANCE_LINES = 64  # ann lines: 30 negatives each, 1,920 triplets
ANCE_NEGS = 30
IDRO_STEPS, GREEDY_STEPS, ANCE_NODROP_STEPS = 6, 3, 2
IDRO_CMP_GROUPS = 4  # the card-against-CPU iDRO step, batch CMP_BATCH
# the card-against-CPU iDRO step's h_fun: max |log h_card - log h_cpu|.
# The group pass moves log h by rho (0.05) x a mean of the groups'
# gradient cosines; a rounding that passes the gradient bounds (cosine
# 0.98) moves those cosines by up to ~2e-2, log h by up to ~1e-3.
# tests/test_torch_ance.py::test_idro_compare_bounds_* calibrate it at 2
# layers: a bf16 step against a float32 one reads 6.8e-5, an h_fun left at
# its pre-update value 0.94; a training cotangent of the post-update
# h_fun fails the gradient bounds (cosines 0.900 and 0.884).
IDRO_H_LOG_TOL = 2e-3
# the group pass itself: max |cos_card - cos_cpu| over the [G, G] cosines
# of the groups' gradients (the normalised Gram that feeds the update).
# The same calibration (K = 1 of 2 layers): a bf16 step reads 1.4e-3, a
# group pass over every layer 1.5e-2, one whose rows are the gradients of
# other groups 6.0e-2; the h_fun bound lets both of these through. At
# BERT-base, K = 3 on the H100 (700 W): the card's step 4.58e-3, the two
# wrong passes planted on the card 2.11e-2 and 1.66e-1 (WRONG_GROUP_PASSES,
# held above the bound in every run). The bound sits near the geometric
# mean of the largest sound reading and the smallest wrong one.
IDRO_COSINE_TOL = 8e-3


def write_ance_data(args, root):
    """Query and passage token caches and an ann file (qid \\t pos \\t 30
    negatives \\t weight \\t group, groups < 50) from the seed -> (query
    cache path, passage cache path, ann file)."""
    from cocodr_tpu_torch.data.records import RecordWriter

    rng = np.random.default_rng(args.seed + 6)
    paths = []
    for name, n, width, lo in (("queries", ANCE_QUERIES, 64, 6),
                               ("passages", ANCE_DOCS, 128, 16)):
        path = os.path.join(root, name)
        with RecordWriter(path, width) as w:
            for length in rng.integers(lo, width + 1, n):
                w.write([101] + rng.integers(1000, 30522, length - 2).tolist()
                        + [102])
        paths.append(path)
    ann = os.path.join(root, "ann_training_data_0")
    with open(ann, "w") as f:
        for _ in range(ANCE_LINES):
            negs = rng.choice(ANCE_DOCS, ANCE_NEGS, replace=False)
            f.write(f"{rng.integers(ANCE_QUERIES)}\t{rng.integers(ANCE_DOCS)}"
                    f"\t{','.join(map(str, negs))}\t"
                    f"{rng.uniform(0.5, 1.5):.4f}\t{rng.integers(50)}\n")
    return paths[0], paths[1], ann


def ance_state(args, dev, stage, bert):
    from cocodr_tpu_torch.losses.dro import idro_init
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.utils.train_state import TrainState

    model = build_dual_encoder(stage.model_type, bert, device=dev,
                               generator=torch.Generator().manual_seed(
                                   args.seed + 7))
    return TrainState(model, stage.optimizer.build(model.parameters()),
                      extra=idro_init(stage.dro, device=dev))


def ance_step_config(stage, kind):
    from cocodr_tpu_torch.pipelines.train_step import TrainStepConfig

    return TrainStepConfig(loss_kind=kind, dro=stage.dro,
                           max_grad_norm=stage.optimizer.max_grad_norm,
                           idro_last_k_layers=stage.idro_last_k_layers)


def ance_run(args, state, stage, kind, data, steps, seed, dropout):
    """train_on_ann_file for `steps` steps of `kind` -> its StepRecorder."""
    from cocodr_tpu_torch.data.records import TokenCache
    from cocodr_tpu_torch.data.streams import TripletBatcher
    from cocodr_tpu_torch.pipelines.ance import train_on_ann_file
    from cocodr_tpu_torch.pipelines.train_step import build_train_step

    q_path, p_path, ann = data
    rec = StepRecorder(build_train_step(ance_step_config(stage, kind)))
    _, taken = train_on_ann_file(
        state, rec, TripletBatcher(TokenCache(q_path), TokenCache(p_path)),
        ann, stage.per_device_batch, max_steps=steps, seed=seed,
        dropout_seed=args.seed if dropout else None)
    if taken != steps:
        raise AssertionError(f"ance {kind}: {taken} steps, not {steps}")
    return rec


def ance_batch(data, batch_size, dev, groups):
    """The ann file's first batch_size triplets on dev, their groups set to
    0..groups-1 in turn: an ann batch holds the few queries of its lines
    (a line is one query, one group and its 30 negatives), so the group
    pass of a training step runs few products; this batch runs one per
    group."""
    from cocodr_tpu_torch.data.records import TokenCache
    from cocodr_tpu_torch.data.streams import (
        TripletBatcher,
        triplets_from_ann_lines,
    )
    from cocodr_tpu_torch.pipelines.ance import batch_arrays

    q_path, p_path, ann = data
    with open(ann) as f:
        lines = f.readlines()
    tb = next(TripletBatcher(TokenCache(q_path), TokenCache(p_path)).batches(
        triplets_from_ann_lines(lines), batch_size))
    arrays = dict(batch_arrays(tb), groups=np.arange(batch_size) % groups)
    del arrays["weights"]  # the iDRO step ignores them
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def idro_phases(state, stage, batch, seed, dev, runs=2):
    """An iDRO dropout step's forward (three towers and the losses), group
    pass (a product per group present), training backward and optimizer
    (clip + LAMB): card ms (CUDA events), medians of `runs` steps."""
    from cocodr_tpu_torch.pipelines.train_step import (
        apply_gradients,
        dropout_generators,
        idro_backward,
        idro_group_pass,
        triplet_losses,
    )

    cfg = ance_step_config(stage, "idro")
    card = []
    for _ in range(runs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        gens = dropout_generators(seed, state.step, dev)
        state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        ev[0].record()
        losses, _ = triplet_losses(state.model, batch, gens)
        ev[1].record()
        _, dstate, (_, gc) = idro_group_pass(state.model, losses,
                                             batch["groups"], state.extra,
                                             cfg)
        ev[2].record()
        idro_backward(losses, batch["groups"], state.extra.h_fun, gc)
        ev[3].record()
        apply_gradients(state, cfg.max_grad_norm)
        state.extra = dstate
        ev[4].record()
        ev[4].synchronize()
        card.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
    return [statistics.median(c[i] for c in card) for i in range(4)]


def idro_compare_step(model, batch, dstate, cfg):
    """One iDRO step, dropout off, up to the clipped gradients -> (robust
    loss, {name: gradient}, the updated h_fun, the group pass's Gram matrix
    normalised: the cosines of the groups' gradients)."""
    from cocodr_tpu_torch.pipelines import train_step as ts

    seen, group_gram = {}, ts.group_gram

    def recorded(*a):
        seen["gram"] = group_gram(*a)
        return seen["gram"]

    ts.group_gram = recorded
    try:
        losses, _ = ts.triplet_losses(model, batch)
        robust, new, (_, gc) = ts.idro_group_pass(
            model, losses, batch["groups"], dstate, cfg)
    finally:
        ts.group_gram = group_gram
    ts.idro_backward(losses, batch["groups"], dstate.h_fun, gc)
    ts.clip_by_global_norm_(model.parameters(), 1.0)
    m = seen["gram"].detach().double().cpu()
    norms = m.diagonal().clamp_min(0.0).sqrt()
    return (robust.item(), {k: p.grad.detach().double().cpu()
                            for k, p in model.named_parameters()},
            new.h_fun.detach().double().cpu(),
            m / (norms[:, None] * norms[None, :]))


def compare_dro_state(cfg, seed):
    """A DroState from the seed (CPU) whose weights differ by up to 10x, so
    that the pre- and post-update weights (h^0.1 flattens them) give
    different training gradients."""
    from cocodr_tpu_torch.losses.dro import DroState

    rng = np.random.default_rng(seed)
    h = rng.uniform(0.1, 1.0, cfg.n_groups)
    return DroState(torch.tensor(h / h.sum(), dtype=torch.float32),
                    torch.tensor(rng.uniform(0.2, 2.0, cfg.n_groups),
                                 dtype=torch.float32),
                    torch.ones(cfg.n_groups))


WRONG_GROUP_PASSES = ("every layer", "other groups' rows")


def wrong_group_pass(fault):
    """Plant a wrong group pass in pipelines/train_step.py: over every
    layer in place of the last K, or with each group's row taken from the
    next group's samples -> a function that removes it."""
    from cocodr_tpu_torch.pipelines import train_step as ts

    if fault == "every layer":
        name, real = "last_k_layers", ts.last_k_layers

        def wrong(model, k):
            return real(model, len(model.encoder.encoder.layer))
    else:
        name, real = "per_group_grads", ts.per_group_grads

        def wrong(losses, params, groups, n, **kw):
            return real(losses, params, (groups + 1) % n, n, **kw)
    setattr(ts, name, wrong)
    return lambda: setattr(ts, name, real)


def h_fun_log_err(h_a, h_b):
    return (h_a.double().log() - h_b.double().log()).abs().max().item()


def idro_compare(args, dev, stage, bert, data):
    """One iDRO step at CMP_BATCH, G = IDRO_CMP_GROUPS, dropout off, on the
    card (K1, K8, bf16) and on the CPU (their plain versions, float32) from
    the same weights and DroState: loss, clipped gradients and h_fun. The
    bounds' calibration holds a bf16 step against a float32 one
    (tests/test_torch_ance.py::test_idro_compare_bounds_*). A bf16 step on
    the CPU is a second rounding: at BERT-base on the H100 the card stood
    closer to the float32 step (worst tensor cosine 0.918, h_fun 1.0e-4)
    than the CPU's bf16 step did (0.918 and 9.7e-4; card against it 0.880,
    8.8e-4)."""
    from cocodr_tpu_torch.losses.dro import DroState
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder

    dro = dataclasses.replace(stage.dro, n_groups=IDRO_CMP_GROUPS)
    cfg = dataclasses.replace(ance_step_config(stage, "idro"), dro=dro)
    model = build_dual_encoder(stage.model_type, bert, device=dev,
                               generator=torch.Generator().manual_seed(
                                   args.seed + 8))
    cpu_model = build_dual_encoder(
        stage.model_type, dataclasses.replace(bert, dtype=torch.float32),
        device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    batch = ance_batch(data, CMP_BATCH, "cpu", IDRO_CMP_GROUPS)
    dstate = compare_dro_state(dro, args.seed)

    def step(m):
        d = next(m.parameters()).device
        return idro_compare_step(
            m, {k: v.to(d) for k, v in batch.items()},
            DroState(*(x.to(d) for x in (dstate.h_fun, dstate.sum_losses,
                                         dstate.count_cat))), cfg)

    out = {}
    zero_counts()
    for name, m in (("card", model), ("cpu", cpu_model)):
        t = time.perf_counter()
        out[name] = step(m)
        phase(f"  ance compare: {name} iDRO step "
              f"{time.perf_counter() - t:.2f} s, loss {out[name][0]:.6f}")
        if name == "card":
            counts = read_counts("ance compare (card)",
                                 ["K1_ffn_block", "K8_attention"])
            check_counts("ance compare (card)", counts, {
                "K1_ffn_block": 3 * bert.num_hidden_layers,
                "K8_attention": 3 * bert.num_hidden_layers})
    (la, ga, ha, ca), (lb, gb, hb, cb) = out["card"], out["cpu"]
    rel, glob, worst, cos = step_agreement(la, ga, lb, gb)
    herr = h_fun_log_err(ha, hb)
    cerr = (ca - cb).abs().max().item()
    # the same card step with each wrong group pass planted: the cosine
    # bound must reject both at this scale
    faults = {}
    for fault in WRONG_GROUP_PASSES:
        model.zero_grad(set_to_none=True)
        remove = wrong_group_pass(fault)
        try:
            faults[fault] = (step(model)[3] - cb).abs().max().item()
        finally:
            remove()
    off_diag = (cb - torch.eye(IDRO_CMP_GROUPS, dtype=cb.dtype)).abs().max()
    phase(f"  ance compare card vs CPU float32 (iDRO, batch {CMP_BATCH}, G "
          f"{IDRO_CMP_GROUPS}, dropout off): loss {la:.6f} vs {lb:.6f} (rel "
          f"{rel:.2e}, bound {CMP_LOSS_RTOL}); clipped-gradient cosine "
          f"{glob:.6f} (bound {CMP_GLOBAL_COSINE}); worst tensor {worst} "
          f"{cos:.6f} (bound {CMP_TENSOR_COSINE}); h_fun max |log diff| "
          f"{herr:.2e} (bound {IDRO_H_LOG_TOL}); group-gradient cosines max "
          f"|diff| {cerr:.2e} (bound {IDRO_COSINE_TOL}; the CPU's largest "
          f"{off_diag.item():.2e}; wrong group passes planted on the card: "
          f"{', '.join(f'{k} {v:.2e}' for k, v in faults.items())}); h_fun "
          f"card {[round(x, 6) for x in ha.tolist()]}")
    if not (steps_agree(rel, glob, cos) and herr <= IDRO_H_LOG_TOL
            and cerr <= IDRO_COSINE_TOL):
        raise AssertionError("card and CPU iDRO steps disagree")
    if not all(v > IDRO_COSINE_TOL for v in faults.values()):
        raise AssertionError(f"the cosine bound lets a wrong group pass "
                             f"through: {faults}")


def ance_train(args, dev):
    """The ance-train phase; each run's launches are checked and printed
    here."""
    from cocodr_tpu_torch.core.configs import AnceStageConfig
    from cocodr_tpu_torch.losses.dro import dro_state_summary

    stage = AnceStageConfig.base()
    bert = dataclasses.replace(stage.bert, dtype=torch.bfloat16)
    layers = bert.num_hidden_layers
    B = stage.per_device_batch
    with tempfile.TemporaryDirectory() as root:
        data = write_ance_data(args, root)
        state = ance_state(args, dev, stage, bert)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        rec = ance_run(args, state, stage, "idro", data, IDRO_STEPS,
                       args.seed, dropout=True)
        counts = read_counts("ance idro (dropout)", ["K5_ffn"])
        check_counts("ance idro (dropout)", counts,
                     {"K5_ffn": 3 * layers * IDRO_STEPS})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = check_steps("ance idro", rec, 1, IDRO_STEPS,
                             {"K5_ffn": 3 * layers})
        ends = [t for _, _, t in rec.records]
        tps = B * (len(ends) - 1) / (ends[-1] - ends[0])
        zero_counts()
        rec2 = ance_run(args, state, stage, "dro-greedy", data, GREEDY_STEPS,
                        args.seed + 1, dropout=True)
        counts2 = read_counts("ance dro-greedy (dropout)", ["K5_ffn"])
        check_counts("ance dro-greedy (dropout)", counts2,
                     {"K5_ffn": 3 * layers * GREEDY_STEPS})
        losses += check_steps("ance dro-greedy", rec2, IDRO_STEPS + 1,
                              IDRO_STEPS + GREEDY_STEPS,
                              {"K5_ffn": 3 * layers})
        ends = [t for _, _, t in rec2.records]
        g_tps = B * (len(ends) - 1) / (ends[-1] - ends[0])
        batch = ance_batch(data, B, dev, stage.dro.n_groups)
        torch.cuda.reset_peak_memory_stats()
        fwd, group, bwd, opt = idro_phases(state, stage, batch, args.seed,
                                           dev)
        all_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        summary = dro_state_summary(state.extra)
        card = nvidia_smi()
        phase(f"  ance idro (G {stage.dro.n_groups}, K "
              f"{stage.idro_last_k_layers}, dropout 0.1, batch {B}, q 64 / "
              f"d 128): {tps:.1f} triplets/s (host clock, steps 2-"
              f"{IDRO_STEPS}); dro-greedy {g_tps:.1f} triplets/s; iDRO card "
              f"ms per step with all {stage.dro.n_groups} groups in the "
              f"batch: forward {fwd:.3f}, group pass {group:.3f}, "
              f"training backward {bwd:.3f}, optimizer {opt:.3f}; peak "
              f"memory {peak:.2f} GiB in the iDRO run, {all_peak:.2f} GiB in "
              f"the steps with all groups; losses "
              f"{', '.join(f'{x:.4f}' for x in losses)} [{card}]")
        phase("  ance dro_state_summary: " + json.dumps(
            {k: v for k, v in summary.items() if not isinstance(v, list)}))
        if not all(math.isfinite(x) for x in summary["dro_h_fun"]):
            raise AssertionError("ance: non-finite h_fun")
        del state
        torch.cuda.empty_cache()

        # no dropout, fused attention: K1 and K8 on every layer
        fused = dataclasses.replace(bert, attention_impl="fused")
        state = ance_state(args, dev, stage, fused)
        zero_counts()
        rec3 = ance_run(args, state, stage, "idro", data, ANCE_NODROP_STEPS,
                        args.seed + 2, dropout=False)
        counts3 = read_counts("ance idro (no dropout, fused attention)",
                              ["K1_ffn_block", "K8_attention"])
        per = {"K1_ffn_block": 3 * layers, "K8_attention": 3 * layers}
        check_counts("ance idro (no dropout, fused attention)", counts3,
                     {k: v * ANCE_NODROP_STEPS for k, v in per.items()})
        nd = check_steps("ance idro (no dropout)", rec3, 1,
                         ANCE_NODROP_STEPS, per)
        phase(f"  ance idro (no dropout, fused attention): losses "
              f"{', '.join(f'{x:.4f}' for x in nd)}")
        del state
        torch.cuda.empty_cache()
        idro_compare(args, dev, stage, fused, data)


# --- ance-mine: ANCE hard-negative mining -------------------------------

# The card's k-means against the plain float32 version on the CPU, step by
# step from the card's own centroids (`kmeans_walk`): over ~8k crowded
# query embeddings of a random tower, two float32 runs from one init part
# within 20 steps (another summation order flips a point near a boundary,
# and the flip grows: 91-100% of labels and inertia 1e-7-6e-4 apart after
# 100 steps, as far apart as a TF32 run or a wrong reseed rule), so each
# step is held instead: the share of labels that differ, the inertia's
# relative difference, and the updated centroids of every cluster whose
# members agree. tests/test_torch_kmeans.py::test_kmeans_walk_bounds_*
# calibrate them on LayerNorm-scaled data shaped like those embeddings
# (2,048 points, 50 clusters, 25 steps, five copies in the init so that
# reseeds run): products and sums of another float32 rounding read label
# share, inertia and centroids up to 4.9e-4 (one point), 6.8e-7 and
# 7.2e-7; TF32-rounded products 5.9e-3-9.8e-3 and 2.5e-4-2.9e-4; a
# reseed from the nearest point, centroids 1.04-1.28. The card's walks
# on the H100 (700 W) read up to 4.9e-4 (4 of 8,192 points), 1.0e-6 and
# 1.8e-7, and with TF32 planted on the card ((b) leg, which fails unless
# it reads above a bound) 1.0e-2 and 4.6e-4; the label bound sits near
# the geometric mean of 4.9e-4 and 5.9e-3.
KMEANS_FLIP_SHARE = 1.5e-3
KMEANS_INERTIA_RTOL = 1e-5
KMEANS_CENTROID_TOL = 1e-3


def kmeans_walk(x, init, n_steps, card_assign, card_step):
    """Step the k-means of x [N, D] from init on x's device with
    card_assign / card_step (ops.kmeans's _assign and _lloyd_step) and, at
    every step, the plain float32 step on the CPU from the same centroids
    -> (final centroids, max label share that differs, max relative
    inertia difference, max |centroid difference| over the clusters whose
    members agree on both sides)."""
    from cocodr_tpu_torch.ops import kmeans as km

    xc = x.cpu()
    c = init
    flips = inertia = cerr = 0.0
    for _ in range(n_steps):
        ids, _ = card_assign(x, c)
        nxt, card_inertia = card_step(x, c)
        c_cpu = c.cpu()
        ids_cpu, _ = km._assign(xc, c_cpu)
        nxt_cpu, cpu_inertia = km._lloyd_step(xc, c_cpu)
        ids = ids.cpu()
        diff = ids != ids_cpu
        flips = max(flips, diff.float().mean().item())
        inertia = max(inertia, abs(card_inertia.item() - cpu_inertia.item())
                      / cpu_inertia.item())
        moved = torch.zeros(c.shape[0], dtype=torch.bool)
        moved[ids[diff]] = True
        moved[ids_cpu[diff]] = True
        err = (nxt.cpu() - nxt_cpu).abs().amax(1)[~moved]
        if len(err):
            cerr = max(cerr, err.max().item())
        c = nxt
    return c, flips, inertia, cerr


# (a) and (b): passages and queries of the ance-train phase's widths
MINE_DOCS = 32_768  # passages of 16-128 tokens
MINE_TRAIN_Q = 8_192  # train queries of 4-23 tokens
MINE_DEV_Q = 1_024
MINE_STEPS = 3  # training steps a round in (a)
ASYNC_STEPS = 2  # train_loop's steps in (b)
# (c): MS MARCO passage's corpus and dev queries; its 502,939 train
# queries cut to 131,072 for the time limit
MARCO_DOCS = 8_841_823
MARCO_DEV_Q = 6_980
MARCO_TRAIN_Q = 131_072
MARCO_CHECK_Q = 1_024  # (c)'s train queries held against the exact search
WALK_STEPS = {"a": 500, "b": 50, "c": 20}  # kmeans_walk's steps a leg
PLACE_SLACK = 64 * 2 ** 20  # the placement's growth against its tensor
PEAK_SLACK = 4 * 2 ** 30  # mine()'s peak against one lone search_topk


def write_mine_data(args, root, name, n_docs, n_pos_docs, n_train, n_dev):
    """Token records from the seed under root/name: n_docs passages of
    16-128 tokens (width 128; none when 0) and n_train train and n_dev dev
    queries of 4-23 tokens (width 64), each with one positive among
    n_pos_docs in offset-space qrels (write_qrels); a query's tokens are
    drawn from its positive's when its passage is written. -> (passage
    cache or None, train query cache, dev query cache, train positives,
    dev qrels)."""
    from cocodr_tpu_torch.data.records import (
        RecordWriter,
        TokenCache,
        load_qrels,
        write_qrels,
    )

    rng = np.random.default_rng([args.seed, len(name)])
    d = os.path.join(root, name)
    os.makedirs(d)
    docs = rng.integers(1000, 30522, (n_docs, 126))
    lens = rng.integers(16, 129, n_docs)
    pc = None
    if n_docs:
        with RecordWriter(os.path.join(d, "passages"), 128) as w:
            for row, n in zip(docs, lens):
                w.write([101] + row[:n - 2].tolist() + [102])
        pc = TokenCache(os.path.join(d, "passages"))
    out = []
    for split, n in (("train", n_train), ("dev", n_dev)):
        pos = rng.integers(0, n_pos_docs, n)
        qlens = rng.integers(4, 24, n)
        path = os.path.join(d, f"{split}-query")
        with RecordWriter(path, 64) as w:
            for p, n_tok in zip(pos, qlens):
                src = docs[p, :lens[p] - 2] if n_docs else rng.integers(
                    1000, 30522, n_tok)
                w.write([101] + rng.choice(src, n_tok - 2).tolist() + [102])
        write_qrels(path + ".qrels.tsv", [(q, int(p), 1)
                                          for q, p in enumerate(pos)])
        out.append((TokenCache(path), load_qrels(path + ".qrels.tsv")))
    (tq, train_qrels), (dq, dev_qrels) = out
    positives = {q: next(iter(rels)) for q, rels in train_qrels.items()}
    return pc, tq, dq, positives, dev_qrels


class MineRecorder:
    """Wraps pipelines/ance.py's place_corpus, search_topk, kmeans and mine
    while in a `with` block: each records what it was given and what it
    returned, and calls through (the placement also the growth of
    torch.cuda.memory_allocated(), a search the query chunk its kernel
    search takes)."""

    NAMES = ("place_corpus", "search_topk", "kmeans", "mine")

    def __init__(self):
        from cocodr_tpu_torch.pipelines import ance

        self.ance = ance
        self.real = {n: getattr(ance, n) for n in self.NAMES}
        self.reset()

    def reset(self):
        self.placed, self.searches, self.clusters, self.mined = [], [], [], []

    def place_corpus(self, *a, **kw):
        before = torch.cuda.memory_allocated()
        out = self.real["place_corpus"](*a, **kw)
        self.placed.append((out, torch.cuda.memory_allocated() - before))
        return out

    def search_topk(self, queries, corpus, k, **kw):
        from cocodr_tpu_torch.ops.mips import clamp_q_chunk

        q_chunk = kw["q_chunk"]
        if corpus.device.type == "cuda":  # the kernel search clamps there
            q_chunk = clamp_q_chunk(q_chunk, corpus.shape[0],
                                    corpus.shape[1], device=corpus.device)
        vals, ids = self.real["search_topk"](queries, corpus, k, **kw)
        self.searches.append(dict(queries=queries, corpus=corpus, k=k,
                                  n_real=kw["n_real"], q_chunk=q_chunk,
                                  vals=vals, ids=ids))
        return vals, ids

    def kmeans(self, x, *a, **kw):
        out = self.real["kmeans"](x, *a, **kw)
        self.clusters.append((x, out))
        return out

    def mine(self, *a, **kw):
        out = self.real["mine"](*a, **kw)
        self.mined.append(out)
        return out

    def __enter__(self):
        for n in self.NAMES:
            setattr(self.ance, n, getattr(self, n))
        return self

    def __exit__(self, *exc):
        for n in self.NAMES:
            setattr(self.ance, n, self.real[n])
        self.reset()


def pallas_k3_launches(n_q, q_chunk, n_rows, d, n_real, k):
    """K3's launches in one 'pallas' search_topk of n_q queries over a
    corpus [n_rows, d] (n_real real), by ops/mips_hier.py's rules: per
    query chunk, two selections when the super level runs (more coarse
    blocks than 8 x k_sel), and one per rescore chunk."""
    n = n_real or n_rows
    k = min(k, n)
    n_coarse = (n_rows + (-n_rows) % 2048) // 64
    extra = 1 if n % 64 else 0
    k_sel = min(k + extra, n_coarse)
    sel = 2 if n_coarse > 8 * k_sel else 0
    kf = min(k + extra, -(-n // 8))
    total = 0
    for s in range(0, n_q, q_chunk):
        q = min(q_chunk, n_q - s)
        chunk = max(128, min(q, (750 * 1024 * 1024) // (kf * 8 * d)))
        total += sel + -(-q // chunk)
    return total


def mine_expected(rec, cfg, layers, encoded):
    """One mine()'s launches from its recorded searches: K1 one per layer
    and encoded batch (encoded: the record counts it encoded), K2 one per
    query chunk, K3 by pallas_k3_launches."""
    k1 = layers * sum(-(-n // cfg.batch_size) for n in encoded)
    k2 = k3 = 0
    for s in rec.searches:
        n_q = len(s["queries"])
        k2 += -(-n_q // s["q_chunk"])
        k3 += pallas_k3_launches(n_q, s["q_chunk"], *s["corpus"].shape,
                                 s["n_real"], s["k"])
    return {"K1_ffn_block": k1, "K2_dual_sweep": k2, "K3_topk": k3}


def check_ann_file(path, n_docs, positives, n_groups, per_line):
    """Every line parses; its negatives are distinct real corpus rows, not
    its positive, per_line of them; its group is in [0, n_groups) ->
    lines."""
    from cocodr_tpu_torch.data.streams import parse_ann_line

    lines = 0
    with open(path) as f:
        for line in f:
            qid, pos, negs, w, g = parse_ann_line(line)
            if (pos != positives[qid] or len(negs) != per_line
                    or len(set(negs)) != len(negs) or pos in negs
                    or not all(0 <= p < n_docs for p in negs)
                    or not 0 <= g < n_groups or w != 1.0):
                raise AssertionError(f"{path}: bad line {line!r}")
            lines += 1
    if not lines:
        raise AssertionError(f"{path}: empty")
    return lines


def check_train_search(name, search, n_docs, dev, rows=None, chunk=256):
    """The train search's ids (its first `rows` queries) against an exact
    plain search of the same embeddings over the placed rows, up to
    near-ties within 1e-4 x max |score| (phase 8's rule) -> (max score
    error, the tolerance, rows whose order differs)."""
    corpus = search["corpus"][:n_docs]
    q = torch.from_numpy(np.asarray(search["queries"][:rows])).to(dev)
    vals, ids = search["vals"][:len(q)], search["ids"][:len(q)]
    err = tol = 0.0
    differ = 0
    for s in range(0, len(q), chunk):
        scores, ref_v, ref_i = exact_search(q[s:s + chunk], corpus,
                                            search["k"])
        t = 1e-4 * scores.abs().max().item()
        err = max(err, check_results(vals[s:s + chunk], ids[s:s + chunk],
                                     scores, ref_v, t))
        tol = max(tol, t)
        differ += int((ref_i.cpu().numpy() != ids[s:s + chunk]).any(1).sum())
        del scores
    phase(f"  ance-mine {name}: train search ids of {len(q)} queries equal "
          f"the exact plain search up to near-ties (max score err "
          f"{err:.3e}, tol {tol:.3e}; {differ} rows order near-ties "
          f"otherwise)")


def check_kmeans(name, rec, cfg, steps, dev, plant_tf32=False):
    """kmeans_walk over the recorded train embeddings from restart 0's
    initial centroids, the card against the plain float32 CPU step; the
    walk is the card's _kmeans_single (bit-equal centroids). plant_tf32:
    walk again with TF32 on for the card's products, which the label or
    inertia bound must reject."""
    from cocodr_tpu_torch.ops import kmeans as km

    x = torch.as_tensor(rec.clusters[-1][0]).to(dev, torch.float32)
    init = x[torch.from_numpy(km.init_indices(
        len(x), cfg.cluster_centroids, cfg.seed)).to(dev)]
    t = time.perf_counter()
    c, flips, inertia, cerr = kmeans_walk(x, init, steps, km._assign,
                                          km._lloyd_step)
    walk_s = time.perf_counter() - t
    ref = km._kmeans_single(x, init, cfg.cluster_centroids, steps)[0]
    phase(f"  ance-mine {name}: k-means of {len(x)} queries, {steps} steps "
          f"card against the CPU from the card's centroids ({walk_s:.1f} "
          f"s): label share that differs {flips:.3e} (bound "
          f"{KMEANS_FLIP_SHARE}), inertia {inertia:.3e} (bound "
          f"{KMEANS_INERTIA_RTOL}), centroids {cerr:.3e} (bound "
          f"{KMEANS_CENTROID_TOL}); the walk equals _kmeans_single: "
          f"{torch.equal(c, ref)}")
    if not (flips <= KMEANS_FLIP_SHARE and inertia <= KMEANS_INERTIA_RTOL
            and cerr <= KMEANS_CENTROID_TOL and torch.equal(c, ref)):
        raise AssertionError(f"ance-mine {name}: card k-means disagrees")
    if plant_tf32 and x.device.type == "cuda":  # TF32 exists on the card
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            _, flips, inertia, _ = kmeans_walk(x, init, steps, km._assign,
                                               km._lloyd_step)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        phase(f"  ance-mine {name}: the same walk with TF32 on for the "
              f"card's products: label share {flips:.3e}, inertia "
              f"{inertia:.3e}")
        if flips <= KMEANS_FLIP_SHARE and inertia <= KMEANS_INERTIA_RTOL:
            raise AssertionError(f"ance-mine {name}: the bounds let a TF32 "
                                 f"walk through")


def timing_line(m):
    return ", ".join(f"{k[5:]} {v:.3f}" for k, v in m.items()
                     if k.startswith("time_"))


def counted(name, run, expect_fn, needed):
    """run() with the counts zeroed before and read after, each equal to
    expect_fn() (kernels in `needed` launched) -> run()'s value."""
    zero_counts()
    out = run()
    counts = read_counts(f"ance-mine {name}", needed)
    check_counts(f"ance-mine {name}", counts, expect_fn())
    return out


def ance_mine(args, dev):
    """The ance-mine phase: (a) two ance_rounds, (b) the async pair, (c)
    mine() at MS MARCO's corpus size. Each path's launches are checked and
    printed here."""
    from cocodr_tpu_torch.core.configs import AnceStageConfig
    from cocodr_tpu_torch.data.streams import TripletBatcher
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.pipelines import ance
    from cocodr_tpu_torch.pipelines.train_step import build_train_step
    from cocodr_tpu_torch.utils.train_state import TrainState, save_checkpoint

    stage = AnceStageConfig.base()
    bert = dataclasses.replace(stage.bert, dtype=torch.bfloat16)
    layers = bert.num_hidden_layers
    per_line = stage.negative_sample // 5
    cfg = ance.MineConfig(
        topk_training=stage.topk_training,
        negative_sample=stage.negative_sample, n_splits=5,
        cluster_query=True, cluster_centroids=stage.dro.n_groups,
        kmeans_iters=500, kmeans_redo=5, batch_size=stage.eval_batch,
        seed=args.seed)
    card = nvidia_smi()
    needed = ["K1_ffn_block", "K2_dual_sweep", "K3_topk"]
    with tempfile.TemporaryDirectory() as root, MineRecorder() as rec:
        pc, tq, dq, positives, dev_qrels = write_mine_data(
            args, root, "small", MINE_DOCS, MINE_DOCS, MINE_TRAIN_Q,
            MINE_DEV_Q)
        encoded = (MINE_DOCS, MINE_DEV_Q, MINE_TRAIN_Q)

        # (a) the time-multiplexed loop: mine, then 3 iDRO steps, twice
        state = ance_state(args, dev, stage, bert)
        step = build_train_step(ance_step_config(stage, "idro"))
        batcher = TripletBatcher(tq, pc)
        work = os.path.join(root, "a")
        for rnd in range(2):
            rec.reset()

            def expect():
                e = mine_expected(rec, cfg, layers, encoded)
                e["K5_ffn"] = 3 * layers * MINE_STEPS
                return e

            state, m, steps = counted(
                f"(a) round {rnd}",
                lambda: ance.ance_round(
                    state, step, batcher, pc, tq, positives, dq, dev_qrels,
                    work, rnd, cfg, stage.per_device_batch, MINE_STEPS,
                    dropout_seed=args.seed, device=dev),
                expect, needed + ["K5_ffn"])
            if steps != MINE_STEPS:
                raise AssertionError(f"(a) round {rnd}: {steps} steps")
            lines = check_ann_file(ance.ann_data_path(work, rnd), MINE_DOCS,
                                   positives, cfg.cluster_centroids,
                                   per_line)
            phase(f"  ance-mine (a) round {rnd}: time (s) {timing_line(m)}; "
                  f"corpus encode {MINE_DOCS / m['time_corpus_encode']:.1f} "
                  f"docs/s; {lines} ann lines; ndcg@10 "
                  f"{m['ndcg_cut_10']:.4f} [{card}]")
            check_train_search(f"(a) round {rnd}", rec.searches[1],
                               MINE_DOCS, dev)
            if rnd == 0:
                check_kmeans("(a)", rec, cfg, WALK_STEPS["a"], dev)
        meta = json.load(open(ance.ann_ndcg_path(work, 1)))
        if meta["checkpoint"] != f"step-{MINE_STEPS}":
            raise AssertionError(f"(a): round 1 mined {meta['checkpoint']}")
        phase(f"  ance-mine (a): round 1 mined {meta['checkpoint']}, the "
              f"weights after round 0's steps")
        del state, step
        torch.cuda.empty_cache()

        # (b) the async pair over the same records, nll with dropout
        model = build_dual_encoder(stage.model_type, bert, device=dev,
                                   generator=torch.Generator().manual_seed(
                                       args.seed + 10))
        state = TrainState(model, stage.optimizer.build(model.parameters()))
        ckpt, ann_b = os.path.join(root, "ckpt"), os.path.join(root, "b")
        save_checkpoint(ckpt, state)
        loader = ance.checkpoint_params_loader(ckpt, state)
        kw = dict(passage_cache=pc, train_query_cache=tq,
                  train_positives=positives, dev_query_cache=dq,
                  dev_qrels=dev_qrels, cfg=cfg, device=dev)
        for rnd in range(2):
            rec.reset()
            counted(f"(b) mine_loop {rnd}",
                    lambda: ance.mine_loop(state.model, loader, ann_b,
                                           poll_secs=0.01, max_rounds=1,
                                           **kw),
                    lambda: mine_expected(rec, cfg, layers, encoded), needed)
            m = rec.mined[0]
            check_ann_file(ance.ann_data_path(ann_b, rnd), MINE_DOCS,
                           positives, cfg.cluster_centroids, per_line)
            phase(f"  ance-mine (b) mine_loop {rnd}: time (s) "
                  f"{timing_line(m)}; corpus encode "
                  f"{MINE_DOCS / m['time_corpus_encode']:.1f} docs/s")
            check_train_search(f"(b) round {rnd}", rec.searches[1],
                               MINE_DOCS, dev)
            if rnd == 0:
                check_kmeans("(b)", rec, cfg, WALK_STEPS["b"], dev,
                             plant_tf32=True)
                t = time.perf_counter()
                counted(
                    "(b) train_loop",
                    lambda: ance.train_loop(
                        state, build_train_step(), batcher, ann_b, ckpt,
                        stage.per_device_batch, poll_secs=0.01,
                        max_ann_files=1, steps_per_file=ASYNC_STEPS,
                        dropout_seed=args.seed),
                    lambda: {"K5_ffn": 3 * layers * ASYNC_STEPS}, ["K5_ffn"])
                name, weights = loader()
                same = all(torch.equal(weights[k].to(dev), v)
                           for k, v in state.model.state_dict().items())
                phase(f"  ance-mine (b) train_loop: {ASYNC_STEPS} nll steps "
                      f"and a checkpoint in {time.perf_counter() - t:.2f} s; "
                      f"the loader returns {name}, equal to the state's "
                      f"weights: {same}")
                if name != f"checkpoint-{ASYNC_STEPS}" or not same:
                    raise AssertionError("(b): the loader's weights")
        n, _, meta = ance.get_latest_ann_data(ann_b)
        if (n, meta["checkpoint"]) != (1, f"checkpoint-{ASYNC_STEPS}"):
            raise AssertionError(f"(b): ann file {n} from {meta}")
        phase(f"  ance-mine (b): the second round mined {meta['checkpoint']}")
        del state, model, loader
        shutil.rmtree(ckpt)
        torch.cuda.empty_cache()

        # (c) mine() at MS MARCO's corpus size
        with open("/proc/meminfo") as f:
            avail = next(line for line in f if line.startswith("MemAvailable"))
        phase(f"  ance-mine (c): host {' '.join(avail.split()[1:])} "
              f"available")
        _, tq, dq, positives, dev_qrels = write_mine_data(
            args, root, "marco", 0, MARCO_DOCS, MARCO_TRAIN_Q, MARCO_DEV_Q)
        t = time.perf_counter()
        corpus = marco_corpus(args, dev)
        phase(f"  ance-mine (c): {MARCO_DOCS} x {DIM} float32 host corpus "
              f"from the seed in {time.perf_counter() - t:.1f} s")
        model = build_dual_encoder(stage.model_type, bert, device=dev,
                                   generator=torch.Generator().manual_seed(
                                       args.seed + 11))
        rec.reset()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        m = counted(
            "(c)",
            lambda: ance.mine(model, None, None, tq, positives, dq, dev_qrels,
                              os.path.join(root, "c"), 0, cfg,
                              checkpoint_name="marco", corpus_emb=corpus,
                              device=dev),
            lambda: mine_expected(rec, cfg, layers,
                                  (MARCO_DEV_Q, MARCO_TRAIN_Q)), needed)
        peak = torch.cuda.max_memory_allocated() - base
        del corpus
        (placed, n_real), growth = rec.placed[0]
        want = (MARCO_DOCS + (-MARCO_DOCS) % 2048) * DIM * 2
        dev_s, train_s = rec.searches
        shared = (dev_s["corpus"] is placed and train_s["corpus"] is placed
                  and dev_s["n_real"] == train_s["n_real"] == MARCO_DOCS)
        # one lone search of the train search's first chunk, over the
        # placed tensor
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rec.real["search_topk"](
            train_s["queries"][:train_s["q_chunk"]], placed, train_s["k"],
            q_chunk=cfg.q_chunk, tile=cfg.mips_tile, method=cfg.search_method,
            n_real=n_real, device=dev)
        lone = torch.cuda.max_memory_allocated() - base
        lines = check_ann_file(ance.ann_data_path(os.path.join(root, "c"),
                                                  0),
                               MARCO_DOCS, positives, cfg.cluster_centroids,
                               per_line)
        gib = 2 ** 30
        phase(f"  ance-mine (c) ({MARCO_DOCS} docs, {MARCO_DEV_Q} dev and "
              f"{MARCO_TRAIN_Q} train queries): time (s) {timing_line(m)}; "
              f"train search {MARCO_TRAIN_Q / m['time_train_search']:.1f} "
              f"q/s; k-means {m['time_cluster']:.3f} s; placement "
              f"{tuple(placed.shape)} {placed.dtype}, memory_allocated grew "
              f"{growth} bytes (tensor {want}); peak over mine() "
              f"{peak / gib:.2f} GiB, {(peak - want) / gib:.2f} less the "
              f"corpus, one lone search_topk of {train_s['q_chunk']} "
              f"queries {lone / gib:.2f} GiB; both searches on one tensor "
              f"with n_real {n_real}: {shared}; {lines} ann lines [{card}]")
        if not abs(growth - want) <= PLACE_SLACK:
            raise AssertionError(f"(c): placement grew {growth}, not {want}")
        if not peak - want <= lone + PEAK_SLACK:
            raise AssertionError(f"(c): mine() peak {peak} against a lone "
                                 f"search's {lone}")
        if not shared:
            raise AssertionError("(c): the searches did not share the "
                                 "placed corpus")
        check_train_search("(c)", train_s, MARCO_DOCS, dev,
                           rows=MARCO_CHECK_Q)
        check_kmeans("(c)", rec, cfg, WALK_STEPS["c"], dev)
        del placed, dev_s, train_s
    torch.cuda.empty_cache()


def marco_corpus(args, dev):
    """MARCO_DOCS row-normalised DIM-d float32 rows from the seed, drawn on
    the card in chunks into host memory (what encode_cache hands mine())."""
    gen = torch.Generator(device=dev).manual_seed(args.seed + 12)
    out = np.empty((MARCO_DOCS, DIM), np.float32)
    host = torch.from_numpy(out)
    step = 262_144
    for s in range(0, MARCO_DOCS, step):
        x = torch.randn(min(step, MARCO_DOCS - s), DIM, generator=gen,
                        device=dev)
        host[s:s + len(x)].copy_(x / x.norm(dim=1, keepdim=True))
    return out


# --- coco: COCO pretraining at CocoStageConfig.base() ----------------------

COCO_BATCHES = 20  # batches of docs in the span corpus
COCO_STEPS, COCO_SAVE = 10, 5  # leg (a): steps, checkpoint interval
COCO_CACHE_STEPS = 3  # leg (b)
COCO_FUSED_STEPS = 2  # leg (d)
COCO_CMP_DOCS = 8  # leg (e): 16 spans
COCO_TOP_KERNELS = 12  # kernels listed from leg (a)'s profiled step
# leg (a): the resumed run must equal the uninterrupted one bit for bit.
# With the token-type rows taken by nn.Embedding, the resumed parameters on
# the H100 differed in that tensor alone (1 of 234; 0-1.9e-9 in four runs):
# the card's embedding backward sums the 51,200 lookups of one row in an
# order that changes from run to run. models/bert.py takes those rows by a
# one-hot product, whose backward is a GEMM.
# leg (e): the card against the float32 CPU step. compare_step's loss and
# global bounds; the worst tensor held closer than its 0.8, since COCO's
# gradient is the MLM's and not a difference of near-equal terms: on the
# H100 the sound step read 0.9933 and the c_head fed from the layer below
# (planted) 0.7883, in c_head.0's key projection
COCO_CMP_TENSOR_COSINE = 0.95
# leg (c): the grad cache against the direct step on the card, both bf16
# from one set of weights, dropout off: the chunks run their GEMMs at
# another M and gather another budget, so the two round apart. On the H100
# the loss read equal, the gradients' cosine 0.999975 and the worst
# tensor's 0.999811; with each chunk given the next chunk's cotangents
# (planted) 0.040 and -0.36: at random weights the contrastive term holds
# most of the gradient
COCO_CACHE_LOSS_RTOL = 1e-3
COCO_CACHE_GLOBAL_COSINE = 0.999
COCO_CACHE_TENSOR_COSINE = 0.99


class PieceTokenizer:
    """WordPiece-style stand-in tokenizer for the smoke (the card has no
    transformers): 30,522 ids, BERT's special ids ([PAD] 0, [UNK] 100,
    [CLS] 101, [SEP] 102, [MASK] 103), each word hashed into one
    word-initial piece (ids 1000..19999) and 0-2 `##` continuation pieces
    (ids 20000..30521), so that the whole-word mask groups a word's
    pieces."""

    vocab_size = 30522
    pad_token_id, cls_token_id, sep_token_id, mask_token_id = 0, 101, 102, 103
    SPECIAL = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]",
               103: "[MASK]"}
    all_special_tokens = list(SPECIAL.values())

    def encode(self, text, add_special_tokens=True):
        ids = []
        for w in text.lower().split():
            h = zlib.crc32(w.encode())
            ids.append(1000 + h % 19000)
            ids.extend(20000 + zlib.crc32(f"{w}#{k}".encode()) % 10522
                       for k in range(h % 3))
        return [101] + ids + [102] if add_special_tokens else ids

    def convert_ids_to_tokens(self, ids):
        return [self.SPECIAL.get(i) or (f"##p{i}" if i >= 20000 else f"p{i}")
                for i in ids]

    def num_special_tokens_to_add(self, pair=False):
        return 3 if pair else 2


def write_coco_corpus(args, root, n_docs):
    """A BEIR-style corpus.jsonl of n_docs random-word documents from the
    seed (a title of 2-5 words, 3-9 sentences of 5-17 words), then its span
    corpus by preprocess_corpus_to_spans at the JAX CLI's defaults (target
    length 30, break probability 0.1) -> (spans path, tokenizer)."""
    from cocodr_tpu_torch.data.coco_spans import preprocess_corpus_to_spans

    rng = np.random.default_rng(args.seed + 10)

    def words(lo, hi):
        return " ".join(f"w{x}" for x in rng.integers(0, 50000,
                                                       rng.integers(lo, hi)))

    corpus = os.path.join(root, "corpus.jsonl")
    with open(corpus, "w", encoding="utf8") as f:
        for i in range(n_docs):
            text = " ".join(words(5, 18) + "." for _ in range(
                rng.integers(3, 10)))
            f.write(json.dumps({"_id": str(i), "title": words(2, 6),
                                "text": text}) + "\n")
    tok = PieceTokenizer()
    spans = os.path.join(root, "spans.jsonl")
    t = time.perf_counter()
    n = preprocess_corpus_to_spans(corpus, spans, tok, target_len=30,
                                   break_prob=0.1, seed=args.seed)
    phase(f"  coco corpus: {n} docs -> {spans} in "
          f"{time.perf_counter() - t:.2f} s (host)")
    if n != n_docs:
        raise AssertionError(f"coco corpus: {n} of {n_docs} docs kept")
    return spans, tok


class BatchRecorder(StepRecorder):
    """StepRecorder that also keeps a host copy of each batch."""

    def __init__(self, step):
        super().__init__(step)
        self.batches = []

    def __call__(self, state, batch, seed):
        self.batches.append({k: v.cpu().numpy() for k, v in batch.items()})
        return super().__call__(state, batch, seed)


class NoUpdate(torch.optim.Optimizer):
    """Leaves the parameters and their .grad as a step made them (the
    compares read the step's gradients)."""

    def __init__(self, params):
        super().__init__(params, {})

    def step(self, closure=None):
        pass


def coco_model(args, dev, stage, bert, offset):
    """The stage's coCondenser on dev, its weights from seed + offset."""
    from cocodr_tpu_torch.models.condenser import build_condenser

    return build_condenser(
        bert, dev, torch.Generator().manual_seed(args.seed + offset),
        n_head_layers=stage.n_head_layers, skip_from=stage.skip_from,
        late_mlm=stage.late_mlm, mlm_budget_frac=stage.mlm_budget_frac)


def coco_state(args, dev, stage, bert, total_steps):
    """CocoStageConfig.base()'s model and LAMB (1e-4, linear, warmup
    warmup_ratio x total_steps) from the seed."""
    from cocodr_tpu_torch.utils.train_state import TrainState

    model = coco_model(args, dev, stage, bert, 11)
    opt = dataclasses.replace(stage.optimizer, total_steps=total_steps,
                              warmup_steps=stage.warmup_steps_for(total_steps))
    return TrainState(model, opt.build(model.parameters()))


def coco_config(stage, chunk=0):
    from cocodr_tpu_torch.pipelines.coco import CocoConfig

    return CocoConfig(cache_chunk_size=chunk,
                      max_grad_norm=stage.optimizer.max_grad_norm)


def coco_stream(args, stage, spans, tok, docs, start=0):
    from cocodr_tpu_torch.data.coco_collator import CoCondenserCollator
    from cocodr_tpu_torch.data.coco_spans import span_batches

    coll = CoCondenserCollator(tok, stage.mlm_probability,
                               stage.max_seq_length, seed=args.seed)
    return span_batches([spans], coll, docs, seed=args.seed, num_epochs=1,
                        start_batch=start)


def coco_run(args, state, stage, spans, tok, chunk, steps, dropout,
             start=0, ckpt=None, saver=None):
    """run_coco_pretrain from span_batches(start_batch=start) until state's
    step is `steps` -> its BatchRecorder."""
    from cocodr_tpu_torch.pipelines.coco import (
        build_coco_train_step,
        run_coco_pretrain,
    )

    docs = stage.per_device_batch_docs
    rec = BatchRecorder(build_coco_train_step(coco_config(stage, chunk)))
    run_coco_pretrain(state, rec, coco_stream(args, stage, spans, tok, docs,
                                              start),
                      args.seed if dropout else None, steps, ckpt_dir=ckpt,
                      save_steps=COCO_SAVE if ckpt else 0, saver=saver,
                      keep_checkpoints=2)
    return rec


def spans_per_s(rec, spans, skip=()):
    """Spans/s on the host clock over the step intervals after the first
    two steps (or the first, for a run of 3), leaving out intervals that
    end at a step in `skip` (one that holds a save)."""
    ends = [t for _, _, t in rec.records]
    first = 2 if len(ends) > 3 else 1
    gaps = [ends[i] - ends[i - 1] for i in range(first, len(ends))
            if rec.records[i][0] not in skip]
    return spans * len(gaps) / sum(gaps), len(gaps)


def coco_step_flops(bert, n_head, spans, seq, rows, padded_rows):
    """Operations of one direct COCO step, counted from the function -> (the
    step's own, K5's recompute, the budget's padding). The step's own: per
    token and layer (the backbone's and the c_head's) the forward's
    projections (8 H^2), scores and PV (4 S H) and FFN (4 H F), the
    backward twice the forward; the MLM head's transform (2 H^2) and tied
    decoder (2 H V) over the `rows` that carry a label (the head's and the
    late loss's), forward and backward; the [B, B] contrastive product.
    Apart, as this code does them: K5's recompute of the FFN in the
    backward (4 H F a token and layer) and the head over the
    `padded_rows - rows` rows of the budget that carry none."""
    H, F, V = bert.hidden_size, bert.intermediate_size, bert.vocab_size
    fwd = 8 * H * H + 4 * seq * H + 4 * H * F
    tokens = spans * seq * (bert.num_hidden_layers + n_head)
    head = 3 * (2 * H * H + 2 * H * V)
    return (tokens * 3 * fwd + rows * head + 6 * spans * spans * H,
            tokens * 4 * H * F, (padded_rows - rows) * head)


def coco_grads(model, batch, cfg, seed=None):
    """One step of build_coco_train_step(cfg) with the parameters left as
    they were -> (metrics as floats, {name: gradient as float64 on the
    host}); cfg.max_grad_norm > 0 gives the clipped gradients."""
    from cocodr_tpu_torch.pipelines.coco import build_coco_train_step
    from cocodr_tpu_torch.utils.train_state import TrainState

    state = TrainState(model, NoUpdate(model.parameters()))
    m = build_coco_train_step(cfg)(state, batch, seed)
    grads = {k: p.grad.detach().double().cpu()
             for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return {k: v.item() for k, v in m.items()}, grads


def wrong_cache_cotangents():
    """Plant a wrong grad cache: pass 2 takes each chunk's contrastive
    cotangents from the next chunk (the cotangents rolled by one chunk) ->
    a function that removes the plant."""
    from cocodr_tpu_torch.pipelines import coco as coco_mod

    real = coco_mod.contrastive_cotangents

    def rolled(cls):
        co_loss, grads = real(cls)
        return co_loss, torch.roll(grads, COCO_CHUNK, dims=0)

    coco_mod.contrastive_cotangents = rolled
    return lambda: setattr(coco_mod, "contrastive_cotangents", real)


def coco_agreement(name, a, b, bounds):
    """Two steps' (metrics, gradients) held by the loss and the gradients'
    cosines -> (readings, whether they pass `bounds` (loss rtol, global
    cosine, worst-tensor cosine))."""
    rel, glob, worst, cos = step_agreement(a[0]["loss"], a[1], b[0]["loss"],
                                           b[1])
    ok = rel <= bounds[0] and glob >= bounds[1] and cos >= bounds[2]
    return (f"{name}: loss {a[0]['loss']:.6f} vs {b[0]['loss']:.6f} (rel "
            f"{rel:.2e}, bound {bounds[0]}); gradient cosine {glob:.6f} "
            f"(bound {bounds[1]}); worst tensor {worst} {cos:.6f} (bound "
            f"{bounds[2]})"), ok


def coco_cache_compare(args, dev, stage, bert, batch):
    """Leg (c): the cache step (K1 104) against the direct step (K1 14)
    from the same weights on one batch, dropout off, raw gradients; then
    the cache step with the wrong chunk's cotangents planted must fail."""
    from cocodr_tpu_torch.pipelines.coco import CocoConfig

    layers, heads = bert.num_hidden_layers, stage.n_head_layers
    model = coco_model(args, dev, stage, bert, 12)
    spans = batch["input_ids"].shape[0]
    bounds = (COCO_CACHE_LOSS_RTOL, COCO_CACHE_GLOBAL_COSINE,
              COCO_CACHE_TENSOR_COSINE)
    out = {}
    for name, chunk, k1 in (("direct", 0, layers + heads),
                            ("cache", COCO_CHUNK,
                             (spans // COCO_CHUNK) * (2 * layers + heads))):
        cfg = CocoConfig(cache_chunk_size=chunk, max_grad_norm=0)
        zero_counts()
        out[name] = coco_grads(model, batch, cfg)
        counts = read_counts(f"coco (c) {name}", ["K1_ffn_block"])
        check_counts(f"coco (c) {name}", counts, {"K1_ffn_block": k1})
    what, ok = coco_agreement("coco (c) cache vs direct (dropout off)",
                              out["cache"], out["direct"], bounds)
    remove = wrong_cache_cotangents()
    try:
        planted = coco_grads(model, batch, CocoConfig(
            cache_chunk_size=COCO_CHUNK, max_grad_norm=0))
    finally:
        remove()
    what_p, ok_p = coco_agreement("the next chunk's cotangents planted",
                                  planted, out["direct"], bounds)
    phase(f"  {what}; {what_p}")
    if not ok:
        raise AssertionError("coco: the grad cache and the direct step "
                             "disagree")
    if ok_p:
        raise AssertionError("coco: a cache step with the wrong chunk's "
                             "cotangents passes the bounds")


def coco_cpu_compare(args, dev, stage, bert, batch):
    """Leg (e): one direct step at 2 x COCO_CMP_DOCS spans, dropout off, on
    the card (K1, K8: fused attention, bf16) and on the CPU through the
    plain versions in float32 from the same weights: the loss and the
    clipped gradients (compare_step's bounds, the worst tensor's at
    COCO_CMP_TENSOR_COSINE); then the card's step with the c_head fed from
    hidden_states[skip_from - 1] must fail them."""
    fused = dataclasses.replace(bert, attention_impl="fused")
    n = bert.num_hidden_layers + stage.n_head_layers
    model = coco_model(args, dev, stage, fused, 13)
    cpu_model = coco_model(args, "cpu", stage, dataclasses.replace(
        bert, dtype=torch.float32), 13)
    cpu_model.load_state_dict(model.state_dict())
    cfg = coco_config(stage)
    bounds = (CMP_LOSS_RTOL, CMP_GLOBAL_COSINE, COCO_CMP_TENSOR_COSINE)
    out = {}
    zero_counts()
    for name, m in (("card", model), ("cpu", cpu_model)):
        d = next(m.parameters()).device
        t = time.perf_counter()
        out[name] = coco_grads(m, {k: v.to(d) for k, v in batch.items()},
                               cfg)
        phase(f"  coco compare: {name} step {time.perf_counter() - t:.2f} s,"
              f" loss {out[name][0]['loss']:.6f}")
        if name == "card":
            counts = read_counts("coco (e) card", ["K1_ffn_block",
                                                   "K8_attention"])
            check_counts("coco (e) card", counts, {"K1_ffn_block": n,
                                                   "K8_attention": n})
    what, ok = coco_agreement(
        f"coco (e) card vs CPU float32 ({2 * COCO_CMP_DOCS} spans, dropout "
        f"off)", out["card"], out["cpu"], bounds)
    model.skip_from = stage.skip_from - 1
    planted = coco_grads(model, batch, cfg)
    what_p, ok_p = coco_agreement(
        f"c_head fed from hidden_states[{model.skip_from}] planted", planted,
        out["cpu"], bounds)
    phase(f"  {what}; {what_p}")
    if not ok:
        raise AssertionError("coco: card and CPU steps disagree")
    if ok_p:
        raise AssertionError("coco: a step with the c_head fed from the "
                             "wrong layer passes the bounds")


def check_resume(losses, resumed_losses, final, model, n_batches):
    """The resumed run's losses and final parameters must equal the
    uninterrupted run's bit for bit."""
    differ = [k for k, v in model.state_dict().items()
              if not torch.equal(v, final[k])]
    worst = max(((v.float() - final[k].float()).abs().max().item(), k)
                for k, v in model.state_dict().items() if k in differ) \
        if differ else (0.0, "none")
    phase(f"  coco (a) resume from checkpoint-{COCO_SAVE}: the {n_batches} "
          f"batches equal the uninterrupted run's bit for bit; losses "
          f"{'equal' if resumed_losses == losses else 'differ'}; "
          f"{len(differ)} of {len(final)} parameter tensors differ (max "
          f"|diff| {worst[0]:.3e} in {worst[1]})")
    if differ or resumed_losses != losses:
        raise AssertionError("coco: the resumed run left the uninterrupted "
                             "one")


def coco(args, dev):
    """The coco phase: COCO pretraining at CocoStageConfig.base(); each
    leg's launches are checked and printed here."""
    from cocodr_tpu_torch.core.configs import CocoStageConfig
    from cocodr_tpu_torch.data.coco_spans import count_span_batches
    from cocodr_tpu_torch.pipelines.coco import coco_generator
    from cocodr_tpu_torch.utils.train_state import (
        AsyncSaver,
        list_checkpoints,
        load_checkpoint,
    )

    stage = CocoStageConfig.base()
    bert = dataclasses.replace(stage.bert, dtype=torch.bfloat16)
    layers, heads = bert.num_hidden_layers, stage.n_head_layers
    docs = stage.per_device_batch_docs
    spans_a_step = 2 * docs
    seq = stage.max_seq_length
    card = nvidia_smi()
    with tempfile.TemporaryDirectory() as root:
        spans, tok = write_coco_corpus(args, root, docs * COCO_BATCHES)
        total = count_span_batches([spans], docs)
        # the collator's host time a batch (first batches of the stream)
        t = time.perf_counter()
        first = list(itertools.islice(coco_stream(args, stage, spans, tok,
                                                  docs), 3))
        coll_ms = (time.perf_counter() - t) * 1e3 / len(first)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in first[0].items()}
        if batch["input_ids"].shape != (COCO_SPANS, COCO_LEN):
            raise AssertionError(f"coco batch {batch['input_ids'].shape}")
        masked = int((batch["labels"] != -100).sum())

        # (a) the direct step with dropout: 10 steps saving at 5 and 10
        ckpt = os.path.join(root, "ckpt")
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        state = coco_state(args, dev, stage, bert, total)
        rec = coco_run(args, state, stage, spans, tok, 0, COCO_STEPS, True,
                       ckpt=ckpt)
        counts = read_counts("coco (a) direct", ["K5_ffn"])
        check_counts("coco (a) direct", counts,
                     {"K5_ffn": (layers + heads) * COCO_STEPS})
        peak_a = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = check_steps("coco (a)", rec, 1, COCO_STEPS,
                                  {"K5_ffn": layers + heads})
        sps, n_gaps = spans_per_s(rec, spans_a_step, skip=(COCO_SAVE + 1,))
        sps_save, _ = spans_per_s(rec, spans_a_step)
        saved = [os.path.basename(p) for p in list_checkpoints(ckpt)]
        if saved != [f"checkpoint-{COCO_SAVE}", f"checkpoint-{COCO_STEPS}"]:
            raise AssertionError(f"coco checkpoints {saved}")
        final = {k: v.clone() for k, v in state.model.state_dict().items()}
        del state
        torch.cuda.empty_cache()

        # resume: a fresh state loads checkpoint-5 and goes on to step 10
        # through span_batches(start_batch=5), saving through AsyncSaver
        state = coco_state(args, dev, stage, bert, total)
        load_checkpoint(os.path.join(ckpt, f"checkpoint-{COCO_SAVE}"), state)
        ckpt2 = os.path.join(root, "ckpt_resume")
        saver = AsyncSaver()
        zero_counts()
        rec2 = coco_run(args, state, stage, spans, tok, 0, COCO_STEPS, True,
                        start=state.step, ckpt=ckpt2, saver=saver)
        saver.close()
        counts2 = read_counts("coco (a) resume", ["K5_ffn"])
        check_counts("coco (a) resume", counts2, {
            "K5_ffn": (layers + heads) * (COCO_STEPS - COCO_SAVE)})
        losses2 = check_steps("coco (a) resume", rec2, COCO_SAVE + 1,
                                   COCO_STEPS, {"K5_ffn": layers + heads})
        for i, (a, b) in enumerate(zip(rec.batches[COCO_SAVE:],
                                       rec2.batches)):
            for k in a:
                if not np.array_equal(a[k], b[k]):
                    raise AssertionError(f"coco resume: batch {COCO_SAVE + i}"
                                         f" {k} differs")
        check_resume(losses[COCO_SAVE:], losses2, final, state.model,
                     len(rec2.batches))
        check = coco_state(args, dev, stage, bert, total)
        load_checkpoint(list_checkpoints(ckpt2)[-1], check)
        if check.step != COCO_STEPS:
            raise AssertionError(f"coco async checkpoint step {check.step}")
        for (k, v), w in zip(check.model.state_dict().items(),
                             state.model.state_dict().values()):
            if not torch.equal(v, w):
                raise AssertionError(f"coco async checkpoint lost {k}")
        for p, q in zip(check.model.parameters(), state.model.parameters()):
            for key in ("exp_avg", "exp_avg_sq"):
                if not torch.equal(check.optimizer.state[p][key],
                                   state.optimizer.state[q][key]):
                    raise AssertionError(f"coco async checkpoint lost {key}")
        del check, final
        phase(f"  coco (a) losses: {', '.join(f'{x:.4f}' for x in losses)};"
              f" the async checkpoint-{COCO_STEPS} loads back equal to the "
              f"state")
        def coco_loss(st):
            gen = coco_generator(args.seed, st.step, dev)
            return lambda: st.model.loss_with_contrastive(
                batch["input_ids"], batch["attention_mask"], batch["labels"],
                generator=gen)[0]

        state.model.train()
        (fwd, bwd, opt), host = step_phases(state, coco_loss)
        busy, top = step_busy(state, coco_loss, top=COCO_TOP_KERNELS)
        # the MLM decoder alone: transform + tied decoder over the
        # [2 x budget, H] rows of one step
        model = state.model
        budget = model._mlm_budget(batch["labels"])[0].numel()
        rows = torch.randn(2 * budget, bert.hidden_size, device=dev,
                           dtype=torch.bfloat16)
        with torch.no_grad():
            dec_ms = device_ms(lambda: model.mlm_logits(rows), 5)
        flops, recompute, padding = coco_step_flops(
            bert, heads, spans_a_step, seq, 2 * masked, 2 * budget)
        b_ms = flops / BF16_FLOP_PER_S * 1e3
        phase(f"  coco (a) direct step, dropout 0.1, {spans_a_step} spans x "
              f"{seq} ({masked} masked of T = {spans_a_step * seq}, budget "
              f"{budget} rows): {sps:.1f} spans/s (host clock, {n_gaps} "
              f"steps after 2 untimed, without the step that holds the "
              f"checkpoint-{COCO_SAVE} save; {sps_save:.1f} with it); card "
              f"ms per step: forward "
              f"{fwd:.3f}, backward {bwd:.3f}, optimizer {opt:.3f} (total "
              f"{fwd + bwd + opt:.3f}); host ms to issue them {host[0]:.3f},"
              f" {host[1]:.3f}, {host[2]:.3f}; MLM decoder forward "
              f"{dec_ms:.3f} ms ([{2 * budget}, {bert.hidden_size}] x "
              f"[{bert.hidden_size}, {bert.vocab_size}]); collator "
              f"{coll_ms:.1f} ms a batch (host); peak memory {peak_a:.2f} "
              f"GiB; step bound {b_ms:.3f} ms ({flops / 1e12:.2f} TFLOP at "
              f"989 TFLOP/s, operations; beyond the function, K5's FFN "
              f"recompute {recompute / 1e12:.2f} TFLOP and the budget's "
              f"{2 * (budget - masked)} unlabelled rows "
              f"{padding / 1e12:.2f} TFLOP) [{card}]")
        span = fwd + bwd + opt
        phase(f"  coco (a) one profiled step: card kernels busy {busy:.3f} ms"
              f" against an unprofiled step's {span:.3f} ms card span: busy "
              f"share " + (f"{busy / span:.3f}; kernels by device ms: "
                           + "; ".join(f"{name[:70]} {ms:.3f}"
                                       for name, ms in top)
                           if busy > 0 else
                           "not measured (the trace holds no device time)"))
        del state, model, rows
        torch.cuda.empty_cache()

        # (b) the grad cache with dropout: 4 chunks a step
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        state = coco_state(args, dev, stage, bert, total)
        model = state.model
        seen = {"pass 1": [], "pass 2": []}
        cls_emb, forward = model.cls_emb, model.forward

        def rec_cls(*a, **k):
            out = cls_emb(*a, **k)
            seen["pass 1"].append(out.clone())
            return out

        def rec_forward(*a, **k):
            loss, aux = forward(*a, **k)
            seen["pass 2"].append(aux["cls"].detach().clone())
            return loss, aux

        model.cls_emb, model.forward = rec_cls, rec_forward
        n_chunks = spans_a_step // COCO_CHUNK
        per_step = n_chunks * (2 * layers + heads)
        rec3 = coco_run(args, state, stage, spans, tok, COCO_CHUNK,
                        COCO_CACHE_STEPS, True)
        counts3 = read_counts("coco (b) grad cache", ["K5_ffn"])
        check_counts("coco (b) grad cache", counts3,
                     {"K5_ffn": per_step * COCO_CACHE_STEPS})
        peak_b = torch.cuda.max_memory_allocated() / 2 ** 30
        cache_losses = check_steps("coco (b)", rec3, 1, COCO_CACHE_STEPS,
                                        {"K5_ffn": per_step})
        del model.cls_emb, model.forward  # the recorders' references
        if not (len(seen["pass 1"]) == len(seen["pass 2"])
                == n_chunks * COCO_CACHE_STEPS):
            raise AssertionError(f"coco (b): {len(seen['pass 1'])} pass-1 "
                                 f"and {len(seen['pass 2'])} pass-2 chunks")
        for i, (a, b) in enumerate(zip(seen["pass 1"], seen["pass 2"])):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"coco (b): chunk {i}'s pass-2 CLS is not its pass-1 CLS"
                    f" (max |diff| {(a.float() - b.float()).abs().max():.3e})")
        sps_b, n_b = spans_per_s(rec3, spans_a_step)
        phase(f"  coco (b) grad cache, {n_chunks} chunks of {COCO_CHUNK}, "
              f"dropout 0.1: every chunk's pass-2 CLS equals its pass-1 CLS "
              f"bit for bit ({len(seen['pass 1'])} chunks); {sps_b:.1f} "
              f"spans/s over {n_b} steps (direct: {sps:.1f}); peak memory "
              f"{peak_b:.2f} GiB (direct: {peak_a:.2f}); losses "
              f"{', '.join(f'{x:.4f}' for x in cache_losses)}")
        del state, model, seen
        torch.cuda.empty_cache()

        # (c) the grad cache against the direct step, dropout off
        coco_cache_compare(args, dev, stage, bert, batch)
        torch.cuda.empty_cache()

        # (d) fused attention, no dropout: K1 and K8 on every layer
        zero_counts()
        state = coco_state(args, dev, stage, dataclasses.replace(
            bert, attention_impl="fused"), total)
        rec4 = coco_run(args, state, stage, spans, tok, 0, COCO_FUSED_STEPS,
                        False)
        counts4 = read_counts("coco (d) fused attention",
                              ["K1_ffn_block", "K8_attention"])
        check_counts("coco (d) fused attention", counts4, {
            "K1_ffn_block": (layers + heads) * COCO_FUSED_STEPS,
            "K8_attention": (layers + heads) * COCO_FUSED_STEPS})
        fused_losses = check_steps(
            "coco (d)", rec4, 1, COCO_FUSED_STEPS,
            {"K1_ffn_block": layers + heads, "K8_attention": layers + heads})
        phase(f"  coco (d) no dropout, fused attention: losses "
              f"{', '.join(f'{x:.4f}' for x in fused_losses)}")
        del state
        torch.cuda.empty_cache()

        # (e) the card against the CPU's plain versions in float32
        small = next(coco_stream(args, stage, spans, tok, COCO_CMP_DOCS))
        coco_cpu_compare(args, dev, stage, bert,
                         {k: torch.from_numpy(v).to(dev)
                          for k, v in small.items()})
    return counts


# --- variants: RoBERTa, multi-chunk documents and DPR ----------------------

# (a)-(d): VAR_DOCS random-word documents of 128-2,048 tokens (a BEIR task
# tokenized by prepare_beir_task), 512 eval queries of 64 tokens
VAR_SHAPE = dict(docs=VAR_DOCS, queries=512, words=(126, VAR_DOC_LEN - 2),
                 title=False, rel=(1, 2))
VAR_EVAL_K = 1000
VAR_EINSUM_DOCS = 1024  # (a) with einsum attention: the first documents
VAR_TRAIN_Q, VAR_DEV_Q, VAR_MINE_K = 2048, 256, 200
LARGE_RECORDS = 2048  # (b): RoBERTa-large records of up to 128 tokens
MC_TRAIN_STEPS = 5  # (e), at MC_TRAIN_BATCH triplets of 64 / 2,048 tokens
# (e)'s card-against-CPU steps: 2 triplets whose documents are cut to 2
# chunks (a float32 CPU step at full depth over documents of 4 chunks
# would take minutes), each its own group in the iDRO step
MC_CMP_BATCH, MC_CMP_CHUNKS = 2, 2
DPR_STEPS = 5  # (f): run_warmup at TRAIN_BATCH x TRAIN_LEN
DPR_CMP_BATCH = 4  # (f)'s nll compare; its iDRO compare takes CMP_BATCH


def variant_model(args, dev, model_type, bert, offset, **kw):
    """A dual encoder of model_type with weights from the seed."""
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder

    return build_dual_encoder(model_type, bert, device=dev,
                              generator=torch.Generator().manual_seed(
                                  args.seed + offset), **kw)


def float32_twin(model):
    """The model's weights in a float32 model on the CPU, where the
    kernels' wrappers take their plain versions."""
    from cocodr_tpu_torch.models.dual_encoder import DualEncoder

    cfg = dataclasses.replace(model.cfg, bert=dataclasses.replace(
        model.cfg.bert, dtype=torch.float32))
    twin = DualEncoder(cfg)
    twin.load_state_dict(model.state_dict())
    return twin.train(model.training)


def var_eval_cfg():
    from cocodr_tpu_torch.pipelines.eval_beir import BeirEvalConfig

    return BeirEvalConfig(task="variants", query_len=QUERY_LEN,
                          doc_len=VAR_DOC_LEN, top_k=VAR_EVAL_K,
                          batch_size=VAR_BATCH)


def write_subset(cache, path, n):
    """The first n records of a cache as a record file of their own."""
    from cocodr_tpu_torch.data.records import RecordWriter, TokenCache

    lengths, tokens = cache.batch(np.arange(n))
    with RecordWriter(path, cache.max_len) as w:
        for length, row in zip(lengths, tokens):
            w.write(row[:length])
    return TokenCache(path)


def chunk_rows(lengths):
    """row2doc of documents of these lengths: one row a chunk of VAR_CHUNK
    tokens that holds a real token."""
    return np.repeat(np.arange(len(lengths)), -(-lengths // VAR_CHUNK))


def mc_encode(cache, model, name):
    """(a): encode_cache_multivector of the corpus, VAR_BATCH documents a
    batch, its launches predicted -> (rows, row2doc)."""
    from cocodr_tpu_torch.pipelines.encode import (
        EncodeConfig,
        Encoder,
        encode_cache_multivector,
    )

    bert = model.cfg.bert
    enc = Encoder(model, is_query=False, device=next(model.parameters())
                  .device)
    tokens, mask = cache.batch_with_mask(np.arange(VAR_BATCH))
    enc.collect(enc.dispatch(tokens, mask))  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    batches = -(-len(cache) // VAR_BATCH)
    expect = {"K1_ffn_block": bert.num_hidden_layers * batches}
    if bert.attention_impl == "fused":
        expect["K8_attention"] = expect["K1_ffn_block"]
    path = f"variants (a) {name}"
    zero_counts()
    t = time.perf_counter()
    emb, row2doc = encode_cache_multivector(
        enc, cache, EncodeConfig(batch_size=VAR_BATCH), chunk_len=VAR_CHUNK)
    wall = time.perf_counter() - t
    check_counts(path, read_counts(path, list(expect)), expect)
    want = chunk_rows(cache.lengths())
    if (not np.array_equal(row2doc, want) or not np.isfinite(emb).all()
            or emb.shape != (len(want), model.cfg.head_dim)):
        raise AssertionError(f"{path}: rows {emb.shape}, row2doc against "
                             f"the documents' real chunks")
    batch_ms = time_ms(lambda: enc(tokens, mask), runs=3, warmup=1)
    phase(f"  {path}: {len(cache) / wall:.1f} docs/s, {len(want) / wall:.1f}"
          f" rows/s ({len(cache)} docs -> {len(want)} rows, "
          f"{VAR_DOC_LEN // VAR_CHUNK * len(cache) - len(want)} all-pad "
          f"chunks dropped; {batches} batches of {VAR_BATCH} docs, "
          f"{wall:.3f} s host clock); card {batch_ms:.3f} ms a batch (T = "
          f"{VAR_T}); row2doc equal to the documents' real chunks "
          f"[{nvidia_smi()}]")
    return emb, row2doc


def mc_sample(cache, row2doc):
    """Chunks of three documents, as (doc, chunk) and as row indices: the
    shortest (one partly padded chunk), one of three chunks whose last is
    partly padded, and the longest one's first and last."""
    lengths = cache.lengths()
    short, full = int(np.argmin(lengths)), int(np.argmax(lengths))
    part = int(np.nonzero((lengths > 2 * VAR_CHUNK) & (lengths % VAR_CHUNK > 0)
                          & (lengths < 3 * VAR_CHUNK))[0][0])
    pairs = [(short, 0), (part, 0), (part, 1), (part, 2), (full, 0),
             (full, (int(lengths[full]) - 1) // VAR_CHUNK)]
    first = np.searchsorted(row2doc, np.arange(len(lengths)))
    return pairs, np.array([first[d] + c for d, c in pairs])


def chunk_inputs(cache, pairs):
    """[n, VAR_CHUNK] ids and mask of the (doc, chunk) pairs."""
    tokens, mask = cache.batch_with_mask([d for d, _ in pairs])
    span = [slice(c * VAR_CHUNK, (c + 1) * VAR_CHUNK) for _, c in pairs]
    return (np.stack([a[i, s] for i, s in enumerate(span)])
            for a in (tokens, mask))


def mc_cpu_check(model, cache, rows, row2doc, dev):
    """(a)'s sampled chunks re-encoded on the CPU in float32 through the
    plain versions, one chunk a row (the same function as the folded
    batch), against each card encode's rows: cosine >= CPU_COSINE. The card
    model with BERT's positions (arange) in place of RoBERTa's, planted,
    must fail the bound."""
    from cocodr_tpu_torch.models.dual_encoder import DualEncoder
    from cocodr_tpu_torch.pipelines.encode import Encoder

    pairs, idx = mc_sample(cache, row2doc)
    ids, mask = chunk_inputs(cache, pairs)
    t = time.perf_counter()
    ref = Encoder(float32_twin(model), device="cpu")(ids, mask).numpy()
    cpu_s = time.perf_counter() - t
    cos = {name: cosines(emb[idx], ref) for name, emb in rows.items()}
    bert = dataclasses.replace(model.cfg.bert, position_style="bert")
    wrong = DualEncoder(dataclasses.replace(model.cfg, bert=bert))
    wrong.load_state_dict(model.state_dict())
    planted = cosines(Encoder(wrong.to(dev), device=dev)(ids, mask)
                      .float().cpu().numpy(), ref)
    del wrong
    phase(f"  variants (a): {len(pairs)} chunks (docs, chunk) {pairs} "
          f"re-encoded on the CPU in float32 in {cpu_s:.1f} s: min cosine "
          + ", ".join(f"{k} {v.min():.6f}" for k, v in cos.items())
          + f" (bound {CPU_COSINE}); positions from arange planted on the "
          f"card: min cosine {planted.min():.6f}")
    if not all(v.min() >= CPU_COSINE for v in cos.values()):
        raise AssertionError("variants (a): card and CPU rows disagree")
    if planted.min() >= CPU_COSINE:
        raise AssertionError("variants (a): the cosine bound lets positions "
                             "from arange through")


def roberta_large_encode(args, dev, root):
    """(b): LARGE_RECORDS records of up to 128 tokens through encode_cache
    by an rdot_nll RoBERTa-large tower (K4 = K1 at H 1024, F 4096, eps
    1e-5, 24 launches a batch of 256); its first records against the CPU's
    float32 rows."""
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.pipelines.encode import (
        EncodeConfig,
        Encoder,
        encode_cache,
    )

    cache = write_records(args, os.path.join(root, "large"), LARGE_RECORDS)
    model = variant_model(args, dev, "rdot_nll", BertConfig.roberta_large(
        dtype=torch.bfloat16), 15)
    layers = model.cfg.bert.num_hidden_layers
    enc = Encoder(model, is_query=False, device=dev)
    tokens, mask = cache.batch_with_mask(np.arange(ENC_BATCH))
    enc.collect(enc.dispatch(tokens, mask))
    torch.cuda.synchronize()
    batches = -(-LARGE_RECORDS // ENC_BATCH)
    expect = {"K1_ffn_block": layers * batches}
    zero_counts()
    t = time.perf_counter()
    out = encode_cache(enc, cache, EncodeConfig(batch_size=ENC_BATCH))
    wall = time.perf_counter() - t
    check_counts("variants (b)", read_counts("variants (b)", list(expect)),
                 expect)
    if out.shape != (LARGE_RECORDS, model.cfg.head_dim) or not np.isfinite(
            out).all():
        raise AssertionError(f"variants (b): bad output {out.shape}")
    batch_ms = time_ms(lambda: enc(tokens, mask), runs=3, warmup=1)
    m = CPU_DOCS["e_bert_large"]
    ref = encode_cache(Encoder(float32_twin(model), device="cpu"), cache,
                       EncodeConfig(batch_size=m), indices=np.arange(m),
                       prefetch_depth=0)
    cos = cosines(out[:m], ref)
    phase(f"  variants (b) RoBERTa-large rdot_nll: {LARGE_RECORDS / wall:.1f}"
          f" docs/s ({batches} batches of {ENC_BATCH}, {wall:.3f} s host "
          f"clock), card {batch_ms:.3f} ms a batch; {m} records on the CPU "
          f"in float32: min cosine {cos.min():.6f} (bound {CPU_COSINE}) "
          f"[{nvidia_smi()}]")
    if not cos.min() >= CPU_COSINE:
        raise AssertionError("variants (b): card and CPU disagree")


def dedupe_docs(ids, row2doc, scores=None):
    """[n_q, k] row ids (-1 pads) -> their documents in first-occurrence
    order, [n_q, k] padded with -1; with scores [n_q, k] also the
    documents' scores, padded with each row's k-th score."""
    n_q, k = ids.shape
    docs = np.full((n_q, k), -1, np.int64)
    vals = None if scores is None else np.repeat(scores[:, -1:], k, 1)
    for r in range(n_q):
        seen = set()
        for c, i in enumerate(ids[r].tolist()):
            d = int(row2doc[i]) if i >= 0 else -1
            if d < 0 or d in seen:
                continue
            if vals is not None:
                vals[r, len(seen)] = scores[r, c]
            docs[r, len(seen)] = d
            seen.add(d)
    return docs, vals


def mc_eval(dev, model, paths, tok_s, rows_a):
    """(c): evaluate_beir_task of the multi-chunk corpus with (a)'s fused
    model at top 1000 (rows searched, mapped to documents, deduped), its
    launches predicted; the card's row ids against an exact plain search
    of the same rows up to near-ties, its documents' relevant ranks moved
    only by near-ties (near_tie_moves), its metrics equal to the plain
    run's with the rows whose document list differs taken from the card."""
    from cocodr_tpu_torch.evals.metrics import evaluate_run, run_from_topk
    from cocodr_tpu_torch.ops.mips import clamp_q_chunk
    from cocodr_tpu_torch.pipelines import eval_beir as eb

    corpus_path, query_path, d2o, q2o, qrels = paths
    cfg = var_eval_cfg()
    emb_a, row2doc = rows_a
    R, n_q = len(row2doc), len(q2o)
    layers = model.cfg.bert.num_hidden_layers
    qc = clamp_q_chunk(cfg.q_chunk, R, DIM, device=dev)
    k = min(cfg.top_k, R)
    batches = -(-len(d2o) // cfg.batch_size) + -(-n_q // cfg.batch_size)
    expect = {"K1_ffn_block": layers * batches,
              "K8_attention": layers * batches,
              "K2_dual_sweep": -(-n_q // qc),
              "K3_topk": pallas_k3_launches(n_q, qc, R, DIM, 0, k)}
    zero_counts()
    metrics, rec = recorded_eval(eb, model, paths, cfg, dev)
    check_counts("variants (c)", read_counts("variants (c)", list(expect)),
                 expect)
    emb, rows = rec["mv"]
    if not np.array_equal(rows, row2doc):
        raise AssertionError("variants (c): row2doc differs from (a)'s")
    row_cos = cosines(emb, emb_a).min()
    score_s = (rec["total_s"] - rec["mv_s"] - sum(rec["encode_s"])
               - rec["search_s"])
    phase(f"  variants (c) eval ({len(d2o)} docs -> {R} rows, {n_q} queries "
          f"at {cfg.query_len}, top {k}, dedupe): tokenize {tok_s:.3f} s, "
          f"encode docs {rec['mv_s']:.3f} s, queries "
          f"{sum(rec['encode_s']):.3f} s, search {rec['search_s']:.3f} s, "
          f"score {score_s:.3f} s (host clock); rows against (a)'s fused "
          f"rows: min cosine {row_cos:.6f} [{nvidia_smi()}]")
    if not row_cos >= CPU_COSINE:
        raise AssertionError("variants (c): the eval's rows differ from (a)'s")

    corpus = torch.from_numpy(emb).to(dev).to(torch.bfloat16)
    scores, ref_v, ref_i = exact_search(
        torch.from_numpy(rec["emb"][0]).to(dev), corpus, k)
    tol = 1e-4 * scores.abs().max().item()
    err = check_results(rec["vals"], rec["ids"], scores, ref_v, tol)
    sc = scores.cpu().numpy()
    del scores, corpus
    first = np.searchsorted(row2doc, np.arange(len(d2o) + 1))
    off2doc = {v: d for d, v in d2o.items()}
    qids = [q for q, _ in sorted(q2o.items(), key=lambda kv: kv[1])]
    rel = [[d2o[d] for d in qrels[q]] for q in qids]
    rel_scores = [[float(sc[r, first[d]:first[d + 1]].max()) for d in rel[r]]
                  for r in range(n_q)]
    plain, plain_v = dedupe_docs(ref_i.cpu().numpy(), row2doc,
                                 ref_v.cpu().numpy())
    card, _ = dedupe_docs(np.asarray(rec["ids"]), row2doc)
    moved = near_tie_moves(plain, card, plain_v, rel, rel_scores, tol)
    differ = [r for r in range(n_q) if not np.array_equal(plain[r], card[r])]
    patched = plain.copy()
    patched[differ] = card[differ]

    def score(ids):
        return evaluate_run(run_from_topk(qids, ids, id_map=off2doc,
                                          dedupe=True), qrels,
                            ndcg_k=cfg.ndcg_k, recall_ks=cfg.recall_ks)

    want = score(patched)
    if metrics != want:
        raise AssertionError(f"variants (c): metrics {metrics} != {want}")
    pure = score(plain)
    delta = max(abs(metrics[m] - pure[m]) for m in metrics)
    phase(f"  variants (c): row ids equal the exact plain search up to "
          f"near-ties (max score err {err:.3e}, tol {tol:.3e}); {len(differ)}"
          f" of {n_q} document lists differ from the plain search's, "
          f"{len(moved)} by a relevant document moved by a near-tie; "
          f"metrics equal the plain run's with those rows from the card "
          f"(without them: max |diff| {delta:.2e}); ndcg@10 "
          f"{metrics['ndcg_cut_10']:.4f}, recall@1000 "
          f"{metrics['recall_1000']:.4f}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"variants (c): non-finite metrics {metrics}")


def write_variant_queries(args, root, cache):
    """VAR_TRAIN_Q train and VAR_DEV_Q dev query records (width 64) of
    4-23 tokens drawn from the first chunk of their positive document, the
    positives uniform over the documents -> (train cache, dev cache, train
    positives, dev qrels)."""
    from cocodr_tpu_torch.data.records import RecordWriter, TokenCache

    rng = np.random.default_rng([args.seed, 13])
    lengths, tokens = cache.batch(np.arange(len(cache)))
    out = []
    for split, n in (("train", VAR_TRAIN_Q), ("dev", VAR_DEV_Q)):
        pos = rng.integers(0, len(cache), n)
        path = os.path.join(root, f"mc-{split}-query")
        with RecordWriter(path, QUERY_LEN) as w:
            for p, n_tok in zip(pos, rng.integers(4, 24, n)):
                src = tokens[p, 1:min(int(lengths[p]), VAR_CHUNK) - 1]
                w.write([101] + rng.choice(src, n_tok - 2).tolist() + [102])
        out.append((TokenCache(path), pos))
    (tq, tpos), (dq, dpos) = out
    return (tq, dq, {q: int(p) for q, p in enumerate(tpos)},
            {q: {int(p): 1} for q, p in enumerate(dpos)})


def mc_mine(args, dev, model, cache, queries, root, rows_a):
    """(d): one mine() round with (a)'s fused model over the multi-chunk
    corpus, top VAR_MINE_K, its launches predicted: the rows placed once
    (n_real the row count) and both searches on them, the train search
    against an exact plain search of the rows, negatives document ids
    other than the positive, the `_mv` emb cache and its `.rows.npy` map
    equal to (a)'s rows -> the ann file."""
    from cocodr_tpu_torch.data.streams import parse_ann_line
    from cocodr_tpu_torch.ops.mips import clamp_q_chunk
    from cocodr_tpu_torch.pipelines import ance

    tq, dq, positives, dev_qrels = queries
    emb_a, row2doc = rows_a
    R = len(row2doc)
    rows = R + (-R) % ance.CORPUS_ROW_MULTIPLE
    layers = model.cfg.bert.num_hidden_layers
    cfg = ance.MineConfig(topk_training=VAR_MINE_K, negative_sample=30,
                          n_splits=5, batch_size=VAR_BATCH,
                          emb_cache_dir=os.path.join(root, "emb"),
                          seed=args.seed)
    qc = clamp_q_chunk(cfg.q_chunk, rows, DIM, device=dev)
    encoded = sum(-(-n // VAR_BATCH) for n in (len(cache), VAR_DEV_Q,
                                                VAR_TRAIN_Q))
    expect = {"K1_ffn_block": layers * encoded,
              "K8_attention": layers * encoded,
              "K2_dual_sweep": -(-VAR_DEV_Q // qc) + -(-VAR_TRAIN_Q // qc),
              "K3_topk": (pallas_k3_launches(VAR_DEV_Q, qc, rows, DIM, R,
                                             min(cfg.dev_topk, R))
                          + pallas_k3_launches(VAR_TRAIN_Q, qc, rows, DIM, R,
                                               min(VAR_MINE_K, R)))}
    work = os.path.join(root, "mine")
    with MineRecorder() as rec:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counts()
        m = ance.mine(model, None, cache, tq, positives, dq, dev_qrels, work,
                      0, cfg, checkpoint_name="variants", device=dev)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        check_counts("variants (d)", read_counts("variants (d)",
                                                  list(expect)), expect)
        [((placed, n_real), growth)] = rec.placed
        shared = (len(rec.searches) == 2
                  and all(s["corpus"] is placed and s["n_real"] == R
                          for s in rec.searches))
        if tuple(placed.shape) != (rows, DIM) or n_real != R or not shared:
            raise AssertionError(f"variants (d): placed {tuple(placed.shape)}"
                                 f" n_real {n_real}, shared {shared}")
        check_train_search("variants (d)", rec.searches[1], R, dev)
    ann = ance.ann_data_path(work, 0)
    lines = negs = 0
    with open(ann) as f:
        for line in f:
            qid, pos, ns, _, _ = parse_ann_line(line)
            if (pos != positives[qid] or not ns or pos in ns
                    or len(set(ns)) != len(ns)
                    or not all(0 <= p < VAR_DOCS for p in ns)):
                raise AssertionError(f"variants (d): bad line {line!r}")
            lines, negs = lines + 1, negs + len(ns)
    emb_file = os.path.join(cfg.emb_cache_dir, "corpus_variants_mv.npy")
    cached = np.load(emb_file)
    cached_rows = np.load(emb_file.replace(".npy", ".rows.npy"))
    cos = cosines(cached, emb_a).min()
    phase(f"  variants (d) mine ({VAR_DOCS} docs -> {R} rows placed as "
          f"{tuple(placed.shape)} {placed.dtype} with n_real {n_real}, "
          f"{placed.nbytes} bytes, memory_allocated grew {growth}; "
          f"{VAR_TRAIN_Q} train and {VAR_DEV_Q} dev queries, top "
          f"{VAR_MINE_K}): time (s) {timing_line(m)}; {lines} ann lines, "
          f"{negs / lines:.1f} negatives a line, all document ids; the _mv "
          f"emb cache against (a)'s rows: min cosine {cos:.6f}; peak memory "
          f"{peak:.2f} GiB [{nvidia_smi()}]")
    if not (np.array_equal(cached_rows, row2doc) and cos >= CPU_COSINE):
        raise AssertionError("variants (d): the emb cache differs from (a)")
    return ann


def random_first_token(args, arrays):
    """The triplet arrays with each sequence's first token ([CLS]) drawn at
    random from the seed. With random weights a shared first token makes
    every CLS embedding alike (two documents' at cosine 0.9986, scores 745
    +- 1 under the rdot_nll head), and the loss's gradient a difference of
    near-equal terms that bf16 rounding swamps: on the card the
    multi-chunk step's worst tensor read 0.53 (the CPU's bf16 step 0.65),
    with the tokens drawn 0.9985 (CPU)."""
    rng = np.random.default_rng([args.seed, 14])
    out = dict(arrays)
    for key in ("q_ids", "pos_ids", "neg_ids"):
        if key not in arrays:
            continue
        ids = np.array(arrays[key])
        ids[:, 0] = rng.integers(1000, 30522, len(ids))
        out[key] = ids
    return out


def mc_compare_arrays(args, cache):
    """MC_CMP_BATCH triplets whose documents are cut to MC_CMP_CHUNKS
    chunks, each document of one real chunk (partly padded) and the rest
    all padding, first tokens drawn (random_first_token); each query is
    its negative's first 16 tokens, a hard negative that outscores the
    positive, so the loss stays far from 0, where bf16 rounding moves a
    small loss by a large share (the rdot_nll head's LayerNorm puts
    logits tens apart: at a mean loss near 0 the CPU's bf16 step read 14%
    off its float32 loss, 0.2% with these queries); each triplet its own
    group. With two real chunks the card and the CPU could take the max at
    different chunks wherever two chunks of one document score within
    bf16 rounding of each other."""
    width = MC_CMP_CHUNKS * VAR_CHUNK
    short = np.nonzero(cache.lengths() < VAR_CHUNK)[0]
    out = {}
    for key, idx in (("pos", short[:MC_CMP_BATCH]),
                     ("neg", short[MC_CMP_BATCH:2 * MC_CMP_BATCH])):
        ids, mask = cache.batch_with_mask(idx)
        out[f"{key}_ids"] = np.ascontiguousarray(ids[:, :width])
        out[f"{key}_mask"] = np.ascontiguousarray(mask[:, :width])
    out = random_first_token(args, out)
    q_ids = np.zeros((MC_CMP_BATCH, QUERY_LEN), out["neg_ids"].dtype)
    q_ids[:, :16] = out["neg_ids"][:, :16]
    out["q_ids"], out["q_mask"] = q_ids, (q_ids > 0).astype(np.int32)
    out["groups"] = np.arange(MC_CMP_BATCH)
    return out


def variant_compare(name, model, arrays, expect):
    """One nll step (the model's loss kind: multi-chunk documents score
    by their best chunk), dropout off, on the card and on the model's
    float32 twin on the CPU from the same weights: the loss and the
    clipped gradients by compare_step's bounds."""
    from cocodr_tpu_torch.pipelines.train_step import (
        clip_by_global_norm_,
        nll_loss,
    )

    out = {}
    zero_counts()
    for where, m in (("card", model), ("cpu", float32_twin(model))):
        d = next(m.parameters()).device
        m.zero_grad(set_to_none=True)
        t = time.perf_counter()
        loss, _ = nll_loss(m, {k: torch.from_numpy(np.asarray(v)).to(d)
                               for k, v in arrays.items() if k != "groups"})
        loss.backward()
        clip_by_global_norm_(m.parameters(), 1.0)
        out[where] = (loss.item(), {k: p.grad.detach().double().cpu()
                                    for k, p in m.named_parameters()})
        phase(f"  {name}: {where} step {time.perf_counter() - t:.2f} s, "
              f"loss {out[where][0]:.6f}")
        if where == "card":
            check_counts(name, read_counts(name, list(expect)), expect)
    rel, glob, worst, cos = step_agreement(*out["card"], *out["cpu"])
    phase(f"  {name} card vs CPU float32 (dropout off): loss rel {rel:.2e} "
          f"(bound {CMP_LOSS_RTOL}); clipped-gradient cosine {glob:.6f} "
          f"(bound {CMP_GLOBAL_COSINE}); worst tensor {worst} {cos:.6f} "
          f"(bound {CMP_TENSOR_COSINE})")
    if not steps_agree(rel, glob, cos):
        raise AssertionError(f"{name}: card and CPU steps disagree")


def lane_idro_step(model, batch, dstate, cfg):
    """One iDRO step, dropout off, of a model that takes the lane group
    pass (rows in idro_lane_grad_dtype), up to the clipped gradients ->
    (robust loss, {name: gradient}, the updated h_fun, the cosines of the
    groups' gradients that the group pass forms)."""
    from cocodr_tpu_torch.losses.dro import gram
    from cocodr_tpu_torch.pipelines import train_step as ts

    seen, real = {}, ts.per_group_grads

    def recorded(*a, **kw):
        seen["rows"] = real(*a, **kw)
        return seen["rows"]

    model.zero_grad(set_to_none=True)
    ts.per_group_grads = recorded
    try:
        losses, _ = ts.triplet_losses(model, batch)
        robust, new, (_, gc) = ts.idro_group_pass(
            model, losses, batch["groups"], dstate, cfg)
    finally:
        ts.per_group_grads = real
    ts.idro_backward(losses, batch["groups"], dstate.h_fun, gc)
    ts.clip_by_global_norm_(model.parameters(), 1.0)
    m = gram(seen.pop("rows")).double().cpu()
    norms = m.diagonal().clamp_min(0.0).sqrt()
    return (robust.item(), {k: p.grad.detach().double().cpu()
                            for k, p in model.named_parameters()},
            new.h_fun.detach().double().cpu(),
            m / (norms[:, None] * norms[None, :]))


def query_tower_group_pass():
    """Plant a two-tower group pass over the query tower's last K layers
    alone (doc_encoder's left out) -> a function that removes it."""
    from cocodr_tpu_torch.pipelines import train_step as ts

    real = ts.last_k_layers
    ts.last_k_layers = lambda model, k: [
        p for layer in model.encoder.encoder.layer[-k:]
        for p in layer.parameters()]
    return lambda: setattr(ts, "last_k_layers", real)


def variant_idro_compare(args, name, model, arrays, cfg, expect, plants=()):
    """One lane iDRO step on the card and on the float32 twin on the CPU
    from the same weights and DroState, by the iDRO compare's bounds (the
    loss, clipped gradients, h_fun, the group-gradient cosines); each
    planted wrong group pass must fail the cosine bound on the card."""
    from cocodr_tpu_torch.losses.dro import DroState
    from cocodr_tpu_torch.pipelines.train_step import lane_group_pass

    if not lane_group_pass(model, cfg):
        raise AssertionError(f"{name}: the model should take the lane pass")
    dstate = compare_dro_state(cfg.dro, args.seed)

    def step(m):
        d = next(m.parameters()).device
        return lane_idro_step(
            m, {k: torch.from_numpy(np.asarray(v)).to(d)
                for k, v in arrays.items()},
            DroState(*(x.to(d) for x in (dstate.h_fun, dstate.sum_losses,
                                         dstate.count_cat))), cfg)

    out = {}
    zero_counts()
    for where, m in (("card", model), ("cpu", float32_twin(model))):
        t = time.perf_counter()
        out[where] = step(m)
        phase(f"  {name}: {where} iDRO step {time.perf_counter() - t:.2f} "
              f"s, loss {out[where][0]:.6f}")
        if where == "card":
            check_counts(name, read_counts(name, list(expect)), expect)
    (la, ga, ha, ca), (lb, gb, hb, cb) = out["card"], out["cpu"]
    rel, glob, worst, cos = step_agreement(la, ga, lb, gb)
    herr = h_fun_log_err(ha, hb)
    cerr = (ca - cb).abs().max().item()
    faults = {}
    for label, plant in plants:
        remove = plant()
        try:
            faults[label] = (step(model)[3] - cb).abs().max().item()
        finally:
            remove()
    phase(f"  {name} card vs CPU float32 (G {cfg.dro.n_groups}, K "
          f"{cfg.idro_last_k_layers}, dropout off): loss rel {rel:.2e} "
          f"(bound {CMP_LOSS_RTOL}); clipped-gradient cosine {glob:.6f} "
          f"(bound {CMP_GLOBAL_COSINE}); worst tensor {worst} {cos:.6f} "
          f"(bound {CMP_TENSOR_COSINE}); h_fun max |log diff| {herr:.2e} "
          f"(bound {IDRO_H_LOG_TOL}); group-gradient cosines max |diff| "
          f"{cerr:.2e} (bound {IDRO_COSINE_TOL})"
          + "".join(f"; {k} planted on the card: {v:.2e}"
                    for k, v in faults.items()))
    if not (steps_agree(rel, glob, cos) and herr <= IDRO_H_LOG_TOL
            and cerr <= IDRO_COSINE_TOL):
        raise AssertionError(f"{name}: card and CPU iDRO steps disagree")
    if not all(v > IDRO_COSINE_TOL for v in faults.values()):
        raise AssertionError(f"{name}: the cosine bound lets a wrong group "
                             f"pass through: {faults}")


def mc_train(args, dev, cache, queries, ann):
    """(e): 'nll_multichunk' steps with dropout through train_on_ann_file
    over (d)'s ann file (queries 64, documents 2,048 tokens), K5 3 x 12 a
    step; a step's card ms by phase; then the nll and the iDRO step against
    the CPU (fused attention, dropout off: K1 and K8 36 a step)."""
    from cocodr_tpu_torch.core.configs import AnceStageConfig
    from cocodr_tpu_torch.data.streams import TripletBatcher
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.pipelines.ance import train_on_ann_file
    from cocodr_tpu_torch.pipelines.train_step import (
        TrainStepConfig,
        build_train_step,
        dropout_generators,
        nll_loss,
    )
    from cocodr_tpu_torch.utils.train_state import TrainState

    tq = queries[0]
    stage = AnceStageConfig.base()
    model = variant_model(args, dev, "rdot_nll_multi_chunk",
                          BertConfig.roberta_base(dtype=torch.bfloat16), 16,
                          base_len=VAR_CHUNK)
    layers = model.cfg.bert.num_hidden_layers
    state = TrainState(model, stage.optimizer.build(model.parameters()))
    rec = StepRecorder(build_train_step(TrainStepConfig(
        loss_kind="nll_multichunk",
        max_grad_norm=stage.optimizer.max_grad_norm)))
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    _, taken = train_on_ann_file(state, rec, TripletBatcher(tq, cache), ann,
                                 MC_TRAIN_BATCH, max_steps=MC_TRAIN_STEPS,
                                 seed=args.seed, dropout_seed=args.seed)
    check_counts("variants (e)", read_counts("variants (e)", ["K5_ffn"]),
                 {"K5_ffn": 3 * layers * MC_TRAIN_STEPS})
    if taken != MC_TRAIN_STEPS:
        raise AssertionError(f"variants (e): {taken} steps")
    losses = check_steps("variants (e)", rec, 1, MC_TRAIN_STEPS,
                         {"K5_ffn": 3 * layers})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ends = [t for _, _, t in rec.records]
    tps = MC_TRAIN_BATCH * (len(ends) - 1) / (ends[-1] - ends[0])
    batch = ance_batch((tq.path, cache.path, ann), MC_TRAIN_BATCH, dev, 1)

    def forward(st):
        gens = dropout_generators(args.seed, st.step, dev)
        return lambda: nll_loss(st.model, batch, gens)[0]

    (fwd, bwd, opt), host = step_phases(state, forward)
    phase(f"  variants (e) nll_multichunk (dropout 0.1, batch "
          f"{MC_TRAIN_BATCH}, queries {QUERY_LEN}, docs {VAR_DOC_LEN} = "
          f"{VAR_DOC_LEN // VAR_CHUNK} chunks): {tps:.1f} triplets/s (host "
          f"clock, steps 2-{MC_TRAIN_STEPS}); card ms a step: forward "
          f"{fwd:.3f}, backward {bwd:.3f}, optimizer {opt:.3f}; host ms to "
          f"issue them {host[0]:.3f}, {host[1]:.3f}, {host[2]:.3f}; peak "
          f"memory {peak:.2f} GiB; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} [{nvidia_smi()}]")
    del state, model, batch
    torch.cuda.empty_cache()

    model = variant_model(args, dev, "rdot_nll_multi_chunk",
                          BertConfig.roberta_base(dtype=torch.bfloat16,
                                                  attention_impl="fused"),
                          17, base_len=VAR_CHUNK)
    arrays = mc_compare_arrays(args, cache)
    expect = {"K1_ffn_block": 3 * layers, "K8_attention": 3 * layers}
    variant_compare(f"variants (e) compare (batch {MC_CMP_BATCH}, docs of "
                    f"{MC_CMP_CHUNKS} chunks)", model, arrays, expect)
    cfg = TrainStepConfig(
        loss_kind="idro", dro=dataclasses.replace(stage.dro,
                                                  n_groups=MC_CMP_BATCH),
        idro_last_k_layers=stage.idro_last_k_layers)
    variant_idro_compare(args, "variants (e) iDRO compare", model, arrays,
                         cfg, expect)


def dpr_leg(args, dev, root):
    """(f): the DPR two-tower model on BERT-base through run_warmup (batch
    64 x 128, dropout 0.1: K5 36 a step), every parameter of both towers
    and both poolers given a gradient and LAMB moments, its checkpoint
    loaded back into a fresh state; one nll step against the CPU; one
    iDRO step whose group pass covers both towers' last K layers against
    the CPU, a pass over the query tower alone planted."""
    from cocodr_tpu_torch.core.configs import (
        AnceStageConfig,
        OptimizerConfig,
    )
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.pipelines.train_step import TrainStepConfig
    from cocodr_tpu_torch.pipelines.warmup import (
        TripleTextBatcher,
        stream_triples,
    )
    from cocodr_tpu_torch.utils.train_state import (
        TrainState,
        latest_checkpoint,
        load_checkpoint,
    )

    bert = BertConfig.base(dtype=torch.bfloat16)
    layers = bert.num_hidden_layers
    path = write_triples(args, os.path.join(root, "dpr.tsv"),
                         TRAIN_BATCH * (DPR_STEPS + 2))
    ckpt = os.path.join(root, "dpr_ckpt")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    state, rec, _ = warmup_run(args, dev, path, ckpt, bert, DPR_STEPS,
                               resume=False, dropout=True, model_type="dpr")
    check_counts("variants (f)", read_counts("variants (f)", ["K5_ffn"]),
                 {"K5_ffn": 3 * layers * DPR_STEPS})
    losses = check_steps("variants (f)", rec, 1, DPR_STEPS,
                         {"K5_ffn": 3 * layers})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ends = [t for _, _, t in rec.records]
    tps = TRAIN_BATCH * (len(ends) - 1) / (ends[-1] - ends[0])
    named = list(state.model.named_parameters())
    missing = [n for n, p in named
               if p.grad is None or not state.optimizer.state[p]]
    poolers = [n for n, _ in named if ".pooler." in n]
    towers = {t: sum(p.numel() for n, p in named if n.startswith(t + "."))
              for t in ("encoder", "doc_encoder")}
    if missing or len(poolers) != 4:
        raise AssertionError(f"variants (f): no gradient or moments for "
                             f"{missing}; poolers {poolers}")
    model = variant_model(args, dev, "dpr", bert, 18)
    fresh = TrainState(model, OptimizerConfig(lr=2e-4).build(
        model.parameters()))
    load_checkpoint(latest_checkpoint(ckpt), fresh)
    same = all(torch.equal(v, fresh.model.state_dict()[k])
               for k, v in state.model.state_dict().items())
    phase(f"  variants (f) DPR (two towers of {towers['encoder']} and "
          f"{towers['doc_encoder']} parameters) through run_warmup (dropout "
          f"0.1, batch {TRAIN_BATCH} x {TRAIN_LEN}): {tps:.1f} triplets/s "
          f"(host clock, steps 2-{DPR_STEPS}); peak memory {peak:.2f} GiB; "
          f"losses {', '.join(f'{x:.4f}' for x in losses)}; all {len(named)} "
          f"parameter tensors (the 4 of the poolers included) have a "
          f"gradient and LAMB moments; checkpoint-{fresh.step} loads back "
          f"both towers equal: {same} [{nvidia_smi()}]")
    if not same or fresh.step != DPR_STEPS:
        raise AssertionError("variants (f): the checkpoint's towers")
    del state, fresh, model
    torch.cuda.empty_cache()

    model = variant_model(args, dev, "dpr", dataclasses.replace(
        bert, attention_impl="fused"), 19)
    triples = [t for t, _ in zip(stream_triples(path), range(CMP_BATCH))]
    arrays = random_first_token(args, TripleTextBatcher(
        HashTokenizer(), TRAIN_LEN).collate(triples))
    expect = {"K1_ffn_block": 3 * layers, "K8_attention": 3 * layers}
    variant_compare(f"variants (f) compare (batch {DPR_CMP_BATCH})", model,
                    {k: v[:DPR_CMP_BATCH] for k, v in arrays.items()},
                    expect)
    dro = dataclasses.replace(AnceStageConfig.base().dro,
                              n_groups=IDRO_CMP_GROUPS)
    arrays["groups"] = np.arange(CMP_BATCH) % IDRO_CMP_GROUPS
    variant_idro_compare(
        args, f"variants (f) iDRO compare (batch {CMP_BATCH})", model,
        arrays, TrainStepConfig(loss_kind="idro", dro=dro,
                                idro_last_k_layers=3), expect,
        plants=[("a group pass over the query tower alone",
                 query_tower_group_pass)])


def variants(args, dev):
    """Phase 12: the model variants. Each leg's launches are predicted,
    checked and printed here."""
    from cocodr_tpu_torch.data.records import TokenCache
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.pipelines import eval_beir as eb

    with tempfile.TemporaryDirectory() as root:
        rng = np.random.default_rng([args.seed, 12])
        data = write_beir_task(rng, root, "variants", VAR_SHAPE)
        t = time.perf_counter()
        paths = eb.prepare_beir_task(data, os.path.join(root, "work"),
                                     HashTokenizer(), var_eval_cfg())
        tok_s = time.perf_counter() - t
        cache = TokenCache(paths[0])
        lengths = cache.lengths()
        phase(f"  variants: {len(cache)} documents of {lengths.min()}.."
              f"{lengths.max()} tokens ({len(chunk_rows(lengths))} chunks "
              f"with a real token) and {len(paths[3])} queries tokenized by "
              f"prepare_beir_task in {tok_s:.1f} s")
        first = write_subset(cache, os.path.join(root, "einsum"),
                             VAR_EINSUM_DOCS)
        rows = {}
        for impl, docs in (("einsum", first), ("fused", cache)):
            model = variant_model(
                args, dev, "rdot_nll_multi_chunk", BertConfig.roberta_base(
                    dtype=torch.bfloat16, attention_impl=impl), 13,
                base_len=VAR_CHUNK)
            rows[impl] = mc_encode(docs, model, impl)
        n = len(rows["einsum"][1])  # the einsum rows: a prefix of fused's
        mc_cpu_check(model, first, {"einsum": rows["einsum"][0],
                                    "fused": rows["fused"][0][:n]},
                     rows["einsum"][1], dev)
        torch.cuda.empty_cache()
        roberta_large_encode(args, dev, root)
        torch.cuda.empty_cache()
        mc_eval(dev, model, paths, tok_s, rows["fused"])
        queries = write_variant_queries(args, root, cache)
        ann = mc_mine(args, dev, model, cache, queries, root, rows["fused"])
        del model
        torch.cuda.empty_cache()
        mc_train(args, dev, cache, queries, ann)
        torch.cuda.empty_cache()
        dpr_leg(args, dev, root)
    torch.cuda.empty_cache()


PHASES = ["kernels", "search", "serve", "encode", "train", "eval",
          "ance-train", "ance-mine", "coco", "variants"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="all",
                    help="comma-separated phases to run (kernels first when "
                         "a later phase needs its corpus), for development; "
                         f"default all: {','.join(PHASES)}")
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

    run = PHASES if args.phases == "all" else args.phases.split(",")
    unknown = set(run) - set(PHASES)
    if unknown:
        raise ValueError(f"unknown phases {sorted(unknown)}; known {PHASES}")
    if "kernels" in run:
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
    if "search" in run:
        phase("search")
        search_counts = search(gen, dev, corpus, corpus_i8, dim_scale)
    if "kernels" in run:
        del corpus_i8
    if "serve" in run:
        phase("serve")
        serve_counts = serve(args, dev, corpus)
    if "kernels" in run:
        del corpus
    torch.cuda.empty_cache()
    for name, fn in (("encode", encode), ("train", train),
                     ("eval", evaluate), ("ance-train", ance_train),
                     ("ance-mine", ance_mine), ("coco", coco),
                     ("variants", variants)):
        if name not in run:
            continue
        phase(name)
        out = fn(args, dev, k5["ms"]) if name == "train" else fn(args, dev)
        if name == "encode":
            encode_counts = out
        elif name == "train":
            train_counts = out
        torch.cuda.empty_cache()
    if run != PHASES:
        print(smi, flush=True)
        phase(f"partial run of {run}: no kernel summary, no result line")
        faulthandler.cancel_dump_traceback_later()
        return

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
