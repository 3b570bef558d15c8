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
     the split forms of tensor parallelism at M = 2 (half of F and of
     the heads a model rank; K8 at 6 heads): K1's at the encode path's T
     at bert-base and bert-large
     widths, K5's at the training path's T, each rank's float32 partial
     against its plain version, the finish after the halves' sum against
     the plain finish and against the unsplit kernel's output (K1's and
     K5's bounds), timed beside the unsplit kernel at the same T;
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
  6. encode: 16,384 random records of up to 128 tokens written with the
     port's RecordWriter, encoded by encode_cache (body tower, batch 256)
     in six configurations: (a) bert-base bf16 with the einsum attention
     chain, (b) the same with length buckets (32, 64, 128), (c)
     attention_impl="fused" (K8), (d) matmul_int8 (K7, einsum attention),
     (e) bert-large (24 layers, the default attention: K8) on the first
     4,096 records, (f) the default configuration (attention_impl
     'auto': K8 12 a batch, its dispatch counted by path); docs/s, card
     span and the host's enqueue time of each; the first records of (a),
     (c), (d) and (e) re-encoded on the CPU through the plain versions,
     (b), (c), (d), (f) held against (a) by cosine and (f) against (c)
     bit for bit;
  7. train: BM25-warmup training of BERT-base (rdot_nll_condenser, random
     weights from the seed, bf16 compute, batch 64 of 128-token triples of
     hashed words) through run_warmup: with dropout 0.1, every FFN runs K5
     (36 per step); 10 steps saving at 5 and 10, then a second run_warmup
     that resumes from checkpoint-10 to step 13; triplets/s, the card's
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
     only where a relevant id moved by a near-tie), the first 16 FiQA docs
     and queries re-encoded on the CPU through the plain versions (cosine
     >= 0.999); then combined_mrr over the SciFact records with a
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
     at batch 4, G 4, dropout off, on the card and on the CPU in float32
     from the same weights and DroState, held together by the loss, the
     clipped gradients' cosines, h_fun and the cosines between the groups'
     gradients that the group pass forms;
 10. ance-mine: hard-negative mining with AnceStageConfig.base()'s model
     (bf16 compute, random weights from the seed, eval batch 512, top 200
     candidates, 30 negatives in 5 splits, k-means into 50 groups, 500
     steps x 5 restarts): (a) two ance_rounds over 16,384 passages
     (16-128 tokens) and 4,096 train and 1,024 dev queries (4-23 tokens,
     one positive each in offset-space qrels), each mining then taking 3
     iDRO steps (G 50, K 3, dropout 0.1); round 1 must mine with the
     weights after round 0's steps; (b) the async pair over those records:
     mine_loop from checkpoint-0, train_loop for 2 nll steps (dropout), a
     second mine_loop that must mine from checkpoint-2, whose weights the
     loader must return equal to the state's; (c) mine() over MS MARCO's
     8,841,823 passages (row-normalised random rows from the seed, a host
     float32 array), 6,980 dev and 32,768 train queries: the corpus must
     reach the card once as one bf16 tensor padded to 8,843,264 rows
     (memory_allocated grows by it within 64 MiB), both searches must get
     that tensor with n_real 8,841,823, and the peak over mine() less the
     corpus must stay within 4 GiB of one lone search_topk of a query
     chunk. In every leg: each ann file parses, with 6 distinct negatives a
     line that are real rows and not the positive, groups in [0, 50); the
     train search's ids equal an exact plain search up to near-ties; the
     card's k-means walks step by step against the CPU's plain float32
     step (kmeans_walk: 100, 50 and 5 steps in (a), (b) and (c));
     mine()'s time_* breakdown, docs/s of the corpus
     encode, q/s of the train search at 8.8M docs and the peak memory;
 11. coco: COCO pretraining at CocoStageConfig.base() (BERT-base, bf16
     compute, float32 parameters, random weights from the seed; c_head of 2
     layers from layer 6, late_mlm, MLM budget 0.17, LAMB at 1e-4 with a
     linear warmup of warmup_ratio 0.1) on a span corpus written by
     preprocess_corpus_to_spans (target length 30, break probability 0.1)
     from random-word documents, whole-word masks by a WordPiece-style
     stand-in tokenizer, batches of 200 docs = 400 spans x 128 tokens:
     (a) the direct step with dropout 0.1 through run_coco_pretrain (K5 14
     a step), 6 steps saving at 3 and 6, then a fresh state that loads
     checkpoint-3 and resumes through span_batches(start_batch=3) to step
     6 saving through AsyncSaver: the same batches bit for bit, the
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
     (e) one direct step at 8 spans on the card and on the CPU through
     the plain versions in float32, by compare_step's bounds, a step with
     the c_head fed from hidden_states[5] planted must fail them;
 12. variants: the model variants, random weights from the seed, bf16
     compute. A BEIR-shaped task of 2,048 random-word documents of
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
     an nll step (1 triplet) and a lane iDRO step (2, each its own group;
     fused attention, dropout off, documents of one real chunk and one all
     padding) against the CPU's float32 step; (f) DPR on BERT-base through run_warmup (batch 64 x 128, 5
     steps, dropout: K5 36 a step), every parameter of both towers and
     poolers given a gradient and LAMB moments, the checkpoint loaded back;
     an nll step and a two-tower iDRO step against the CPU, a group pass
     over the query tower alone planted must fail the cosine bound. Every
     leg predicts its launches before it runs.
 13. recipe: the four COCO-DR stages chained at BERT-base width, with
     remat and gradient accumulation (depth cut for time). (a) COCO at
     CocoStageConfig.base() (400 spans x 128, dropout) with remat '': 3
     direct steps (K5 26 a step: the backbone's 12 layers run again in
     the backward), then a grad-cache step (K5 152), each chunk's pass-2
     CLS equal to pass 1's; one direct step of each remat policy from the
     same weights (K5 14, 26, 26, 14): the loss equal, the peak memory
     beside its prediction; (b) the handoff on the card
     (split_state_dict, state_dict_from_hf, a rdot_nll_condenser
     DualEncoder), its backbone equal to COCO's bit for bit; (c) warmup
     at WarmupStageConfig.base()'s model and LAMB, 64 x 128, dropout,
     remat '', 2 micro-batches an update (MultiSteps; K5 72 a
     micro-batch): 6 micro-batches saving at 3, inside the second window,
     and a fresh state resumed from checkpoint-3 equal to the
     uninterrupted run bit for bit (parameters, moments, accumulator);
     then one warmup forward and backward of each policy against no remat
     (K5 36, 72, 72, 36): loss, every gradient and the generators' end
     states bit-equal, a recompute that draws from the caller's generator
     planted must differ, each policy's peak memory; one window of 2 x 4
     triplets (first tokens at random), dropout off, on the card (K1 144)
     and on the CPU in float32: the accumulated gradient by compare_step's
     bounds and its norm; (d) one ance_round of dro-greedy at
     AnceStageConfig.base() (2 micro-batches an update, remat '') over
     16,384 passages, 2,048 train and 256 dev queries (K1, K2 2, K3,
     K5 144); (e) SciFact's shape through prepare_beir_task and
     evaluate_beir_task (K1 144, K2 1, K3 2), ids against the plain exact
     search up to near-ties (near_tie_moves).
 14. http (after recipe, over a corpus made as the kernels phase makes
     its own: 1,048,576 row-normalised random bf16 docs): BERT-base in
     the default mode behind pipelines/http_serve.py's server, 16 client
     threads: (a) 128 single-query requests, which must coalesce into
     fewer batches than requests, their answers against search() of the
     same texts; (b) 64 requests of 64 queries, one batch each, answers
     equal to search() of each request's texts up to near-ties, queries/s
     beside search_stream of the same batches; K1 12, K2 1, K3 3 a batch.
 15. ivf (after http): a planted-cluster corpus of 1,048,576 x 768 bf16 (1,024 centres,
     rows and queries a centre plus noise) made from the seed; the IVF
     index's build seconds; 1,024 queries at k = 100 by the exact pallas
     search and by IVF at nprobe 8, 32 and full, queries/s and recall@100
     against an exact plain search; the IVF searches launch no kernel;
     full probe equals the exact search up to near-ties; recall at nprobe
     32 meets IVF_RECALL_32; then RetrievalService in ivf mode (K1 12 a
     call and nothing else: a flat sweep there fails the counts), its
     results equal to ivf_topk of the same embeddings, full probe through
     its index equal to the exact search, ms a batch.
 16. cli (after ivf): python -m cocodr_tpu_torch.cli as subprocesses (each writing its
     launch counts at exit) over a BERT-base checkpoint directory (random
     weights from the seed, pytorch_model.bin, config.json, a vocab.txt of
     30,522 entries) and a BEIR task of SciFact's published size (5,183
     docs, 300 queries): preprocess-beir (the port's WordPiece tokenizer),
     encode (K1 12 a batch of 512; its .npy equal to encode_cache in this
     process bit for bit; docs/s), serve --queries (a TREC run equal to
     the same service's search_stream here), serve --search-method ivf
     through the stdin REPL (these two started together after encode,
     beside this process's checks), and serve --http (answers equal to
     search() here), each one's launches checked; then in this process
     evaluate_beir_task and mine() by search_method 'ivf' at full probe
     over those records (metrics within 1e-2 of 'pallas''s, the ann
     file's lines valid, K1 only). Its RoBERTa leg, beside the BERT one:
     a RoBERTa-base checkpoint directory (roberta.* and lm_head.*
     weights from the seed, config.json, a 50,265-entry byte-level BPE
     in vocab.json + merges.txt) and a second directory holding the same
     tokenizer as a tokenizer.json alone; preprocess-beir with each
     (records byte-equal, and equal to the port's BPE in this process),
     encode (K1 12 a batch of 512, LayerNorm eps 1e-5; .npy equal to
     encode_cache here) and serve --records --queries (its corpus encoded
     at startup; a TREC run equal to search_stream here over encode's
     .npy) started together; the native record reader (data/native.py)
     byte-equal to TokenCache on its passages, both readers' gathers
     timed in rows/s.
 17. cli-recipe (after cli): the four COCO-DR stages as a user types them
     (docs/commands.md) through cocodr_tpu_torch.cli, each subcommand in
     this process through cli.main (the async pair as two processes), at
     BERT-base width from the cli phase's checkpoint directory (written
     again from the seed, with its MLM head) and SciFact-sized task:
     preprocess-coco; coco --preset coco-base to step 6 (K5 14 a step)
     and a second call resumed from a copy of its checkpoint-4 with
     --async-checkpoint, whose losses and checkpoint-6 equal the
     uninterrupted run's bit for bit; export-hf --from-orbax, its
     tensors equal the state's; preprocess-msmarco of an MS MARCO-shaped
     TSV collection from the seed (16,384 passages, 4,096 train and 512
     dev queries); warmup from the COCO export (batch 64, 6 steps, the
     dev eval every 3 through combined_mrr, --async-checkpoint: K5 36 a
     step, K1, K2 1 and K3 an eval), its losses, evals and checkpoint
     equal run_warmup's in this process bit for bit; export-hf of the
     warmup checkpoint; ance --loss-kind idro, 2 rounds of 3 steps (K1
     a mining encode batch, K2 and K3 by the recorded searches, K5 36 a
     step), round 1 mined from step-3, then ance --int8-encode resuming
     to round 2 (K7 for its encodes); ance-mine and ance-train as two
     concurrent processes on a fresh --ckpt-dir, the second ann file from
     checkpoint-2 (started after the warmup export, they run beside this
     process's ance calls and the steps after them); export-hf of the
     ANCE checkpoint, eval-beir (K1 12 a batch, K2 1, K3) equal to
     eval_beir in this process, parity PASS at that nDCG and exit code 1
     at a planted one; convert-hf and presets.
     Each stage's seconds, and the CLI's own spans/s, triplets/s and
     docs/s.
 18. mesh (after cli-recipe): the data-parallel paths (core/mesh.py,
     parallel/) on a world of one nccl process that create_mesh makes
     (the machine has one card, and NCCL refuses two ranks on one
     device), each forced through its sharded code at W = 1 and held
     against the plain path, its launches equal to the plain path's: (a)
     mips_topk_sharded at 1,024 queries x 1,048,576 docs, k 100, by
     'pallas' and 'fast' (ids and scores equal search_topk's; q/s, the
     all-gather and merge's ms); (b) the sharded RetrievalService
     (batches of 64, top 10; K1 12 a batch) equal to the plain one; (c)
     run_warmup through shard_train_init and put_batch, 5 steps of 64 x
     128 with dropout (K5 36 a step), losses and parameters bit-equal to
     the plain run; (d) a direct and a grad-cache COCO step at 400 x 128
     with the span contrastive over the world, bit-equal; (e) mine(mesh=)
     over 16,384 passages and 4,096 train queries, its ann file equal to
     mine()'s; (f) eval-beir --mesh auto in a subprocess on the cli
     phase's SciFact-sized task, its metrics equal to eval_beir's here;
     (g) a world of two processes on the one card over gloo (whose CUDA
     tensors take every collective the port runs: gloo_cuda_probe.py),
     beside (c)-(f): the (a) searches with each rank holding half the
     corpus, ids equal to (a)'s, launches as (a)'s; 3 data-parallel
     warmup steps without dropout (K1 36 a step), the ranks' parameters
     bit-equal, the first step's averaged gradients and every loss held
     to a world of one's by the card-against-CPU bounds; (h) tensor
     parallelism, a world of two gloo processes on the card as mesh
     1 x 2, beside (c)-(g): a BERT-base warmup step of 16 triplets with
     dropout (the split K5, 36 a rank) and one without, fused attention
     (the split K1 and K8 at 6 heads, 36 each a rank), each held to a
     world of one's unsplit step from the same weights, batch and masks
     by the averaged, clipped gradients gathered
     whole (cosine 0.998, worst tensor 0.98; the loss by CMP_LOSS_RTOL,
     as (g)'s every loss); the checkpoint the split
     state wrote loaded at a world of one bit-equal to the parameters
     and LAMB moments it gathered; split encode forwards of bert-base and
     of bert-large's widths at 4 layers (the split K1 at K4's widths)
     against the unsplit forwards, every row's cosine >= 0.999.
     W = 4 and a model axis of 2 over data 2 are the CPU tests' (gloo).
 19. moe (after mesh): E1, the routed experts of a DeepSeek-V2 MoE layer
     (csrc/moe_experts.cu via ops/moe.py::expert_ffn), at
     DeepSeek-V2-Lite's widths (64 experts of 1,408, hidden 2,048, top 6)
     on rows routed by moe.route from random gate weights: 16 and 1,000
     tokens (empty experts, partial tiles), the moe_encode cell's batch of
     128 x 288 tokens (221,184 rows) without and with a fifth of the
     tokens padding (their rows routed past offsets[E], written by
     neither), and 128 x 512 (393,216 rows), each against the plain loop
     by every routed row's error over its largest output, two launches a
     call; a row given to the neighbouring expert and an expert missing
     one F tile, planted, must fail that bound; from 36,864 tokens up, ms
     beside the bound of portbench/work_moe.py::expert_work, the plain
     loop, torch._grouped_mm and one cuBLAS product an expert. Then the
     tower's attention through SDPA (q/k 192, v 128, causal) in turns with
     v padded to 192, the two outputs held together.
Each phase's seconds print on a line of their own as it ends
(`phase seconds NAME: S`), and all of them together before the kernel
summary.
Every path (the search phase, each serve mode, each encode configuration,
each training run, each eval task, combined_mrr, each mining round, each
COCO leg, each variants leg, each recipe leg, each HTTP leg, each IVF
search, each CLI subcommand, each cli-recipe call, each mesh leg) runs
with every kernel's launch count set to 0 just
before it and read just after, and fails if a kernel of the path never
launched or a count differs from the path's own. Every forward on the
card under torch.inference_mode that runs no attention dropout (serving,
encoding, evals, mining) launches K8 on each layer beside the K1 or K7
the phases below name: models/bert.py's default attention_impl, 'auto'
(`with_k8`); COCO's grad-cache pass 1 (torch.no_grad) keeps the einsum
chain of its training pass. Then one JSON line of per-kernel numbers,
the card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Any failure raises and the process exits
non-zero; a hang ends at the watchdog with a traceback.
"""
from __future__ import annotations

import faulthandler

faulthandler.dump_traceback_later(1100, exit=True)

import argparse  # noqa: E402
import contextlib  # noqa: E402
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
ENC_DOCS = 16384  # records of the encode phase
ENC_LEN = 128  # their max_len
ENC_BATCH = 256  # the JAX bench's encode batch
ENC_TOKENS = ENC_BATCH * ENC_LEN  # T of the FFN kernels on the encode path
LARGE_DOCS = 4096  # bert-large encodes the first records only
# Limits on the share of outputs where a kernel and its plain version differ
# at all (check_ffn and check_k8 give the readings they separate).
K1_MAX_SHARE = 0.05
K5_MAX_SHARE = 0.05
K7_MAX_SHARE = 0.01
K8_MAX_SHARE = 0.01
TRAIN_BATCH = 64  # triples per step (the warmup preset's large batch)
TRAIN_LEN = 128  # max_seq_len of every tower
TRAIN_T = TRAIN_BATCH * TRAIN_LEN  # T of K5 (one tower's FFN)
TRAIN_STEPS, TRAIN_SAVE, TRAIN_RESUME = 10, 5, 13
NODROP_STEPS = 5
# COCO (CocoStageConfig.base()): 200 docs = 400 spans of 128 tokens a step,
# the grad cache's chunks of 100 spans
COCO_SPANS, COCO_LEN, COCO_CHUNK = 400, 128, 100
COCO_T = COCO_SPANS * COCO_LEN  # T of K1 and K5 in a direct COCO step
CMP_BATCH = 8  # the card-against-CPU step, at full depth
# the model variants (phase 12): documents of up to 4 chunks of 512 tokens
# (rdot_nll_multi_chunk on RoBERTa-base, LayerNorm eps 1e-5), encoded 64
# documents a batch; multi-chunk training at 8 triplets a step
VAR_DOCS, VAR_DOC_LEN, VAR_CHUNK, VAR_BATCH = 2048, 2048, 512, 64
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


class PhaseClock:
    """Each phase's seconds on the host clock, printed on a line of its own
    when the phase ends (`phase seconds NAME: S`) and all together by
    summary()."""

    def __init__(self):
        self.seconds = {}
        self._name, self._t = None, None

    def start(self, name, msg=None):
        self.stop()
        phase(msg or name)
        self._name, self._t = name, time.perf_counter()

    def stop(self):
        if self._name is not None:
            secs = time.perf_counter() - self._t
            self.seconds[self._name] = secs
            phase(f"phase seconds {self._name}: {secs:.2f}")
            self._name = None

    def summary(self):
        self.stop()
        return ", ".join(f"{k} {v:.2f}" for k, v in self.seconds.items())


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


# the split forms (tensor parallelism): the model axis of the checks and of
# mesh leg (h)
TP_M = 2


def split_weights(w1, b1, w2, m, M=TP_M):
    """Model rank m's slices of an FFN's weights (nn.Linear layout): rows
    of w1 and b1, columns of w2, contiguous."""
    k = w1.shape[0] // M
    return (w1[m * k:(m + 1) * k].contiguous(),
            b1[m * k:(m + 1) * k].contiguous(),
            w2[:, m * k:(m + 1) * k].contiguous())


def check_partials(name, kern, plain, args_of, what):
    """Each model rank's float32 partial from the kernel against its plain
    version (two bf16 ulps of the largest partial: h rounds to bf16 after
    float32 sums in another order; the partial itself is never rounded)
    -> (the partials' sum from the kernel, from the plain version, max
    abs err)."""
    ys, yps, err = 0, 0, 0.0
    for m in range(TP_M):
        y, yp = kern(*args_of(m)), plain(*args_of(m))
        y, yp = (y[0], yp[0]) if isinstance(y, tuple) else (y, yp)
        torch.cuda.synchronize()
        e = (y - yp).abs().max().item()
        tol = 2.0 ** -6 * yp.abs().max().item()
        phase(f"  {name} partial of model rank {m} {what}: max_abs_err="
              f"{e:.3e} tol={tol:.3e}")
        if not e <= tol or not torch.isfinite(y).all():
            raise AssertionError(f"{name}: a partial disagrees with its "
                                 f"plain version: max abs err {e}")
        ys, yps, err = ys + y, yps + yp, max(err, e)
    return ys, yps, err


def check_split_k1(ffn, gen, dev, T, H, F, name, replaces, loops):
    """The split K1 at M = TP_M: each rank's partial (LN1, up GEMM, partial
    down GEMM) against its plain version; the finish (residual + LN2)
    on the kernels' sum against the plain finish on the plain sum, and on
    one y against the plain finish of the same y; the split result against
    the unsplit K1 kernel's output: each by check_ffn's bounds (K1's share
    limit). Timed by loops: one rank's partial, the finish, and the
    unsplit K1 at the same T -> the summary entry."""
    args = ffn_inputs(gen, dev, T, H, F)
    r, s1, c1, w1, b1, w2, b2, s2, c2 = args
    what = f"T={T} H={H} F/{TP_M}={F // TP_M}"

    def part_args(m):
        return (r, s1, c1, *split_weights(w1, b1, w2, m))

    y, yp, err = check_partials(name, ffn.fused_ffn_block_partial,
                                ffn.ffn_block_partial_reference, part_args,
                                what)
    _, stats = ffn.fused_ffn_block_partial(*part_args(0))
    _, stats_p = ffn.ffn_block_partial_reference(*part_args(0))
    fin = (r, stats, s1, c1, y, b2, s2, c2)
    got = ffn.fused_ffn_block_finish(*fin)
    errs = [err, check_ffn(
        name, lambda *a: got, lambda *a: ffn.ffn_block_finish_reference(
            r, stats_p, s1, c1, yp, b2, s2, c2), (), what + ", finished",
        K1_MAX_SHARE)]
    errs.append(check_ffn(name + " finish", ffn.fused_ffn_block_finish,
                          ffn.ffn_block_finish_reference, fin,
                          what + ", the same y", K1_MAX_SHARE))
    errs.append(check_ffn(name + " against the unsplit K1",
                          lambda *a: got, ffn.fused_ffn_block, args, what,
                          K1_MAX_SHARE))
    ms_p = device_ms(lambda: ffn.fused_ffn_block_partial(*part_args(0)),
                     loops)
    ms_f = device_ms(lambda: ffn.fused_ffn_block_finish(*fin), loops)
    ms_1 = device_ms(lambda: ffn.fused_ffn_block(*args), loops)
    def plain_split():  # one rank's partial and the finish
        yy, st = ffn.ffn_block_partial_reference(*part_args(0))
        return ffn.ffn_block_finish_reference(r, st, s1, c1, yy, b2, s2, c2)

    plain = time_ms(plain_split)
    k = F // TP_M
    # partial: r in, this rank's weights and b1, y out (float32), stats;
    # finish: r, y and stats in, out, b2 and four LayerNorm vectors
    nbytes = (2 * T * H + 2 * 2 * H * k + 2 * k + 4 * T * H + 8 * T
              + 2 * T * H + 4 * T * H + 8 * T + 2 * T * H + 2 * H + 16 * H)
    b_ms, b_by = bound(nbytes, 4 * T * H * k, BF16_FLOP_PER_S)
    phase(f"  {name} {what}: one rank's partial {ms_p:.4f} ms + finish "
          f"{ms_f:.4f} ms = {ms_p + ms_f:.4f} ms (loops of {loops}); the "
          f"unsplit K1 at this T {ms_1:.4f} ms; plain split {plain:.4f} ms; "
          f"bound {b_ms:.4f} ms ({b_by})")
    return dict(name=name, route="cuda",
                source="cocodr_tpu_torch/csrc/ffn_block.cu",
                replaces=replaces, max_abs_err=max(errs), ms=ms_p + ms_f,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def check_split_k5(ffn, gen, dev, T):
    """The split K5 at M = TP_M, bert-base widths: each rank's partial
    against its plain version; the finish (y + b2, rounded once) on the
    kernels' sum against the plain finish on the plain sum, and the split
    result against the unsplit K5 kernel's, by check_ffn's bounds (K5's
    share limit); timed as check_split_k1 -> the summary entry."""
    H, F = 768, 3072
    x, _, _, w1, b1, w2, b2, _, _ = ffn_inputs(gen, dev, T, H, F)
    what = f"T={T} H={H} F/{TP_M}={F // TP_M}"

    def part_args(m):
        return (x, *split_weights(w1, b1, w2, m))

    y, yp, err = check_partials("K5 split", ffn.fused_ffn_partial,
                                ffn.ffn_partial_reference, part_args, what)
    got = ffn.fused_ffn_finish(y, b2)
    errs = [err, check_ffn("K5 split", lambda *a: got,
                           lambda *a: ffn.ffn_finish_reference(yp, b2), (),
                           what + ", finished", K5_MAX_SHARE)]
    errs.append(check_ffn("K5 split against the unsplit K5",
                          lambda *a: got, ffn.fused_ffn,
                          (x, w1, b1, w2, b2), what, K5_MAX_SHARE))
    ms_p = device_ms(lambda: ffn.fused_ffn_partial(*part_args(0)), 50)
    ms_f = device_ms(lambda: ffn.fused_ffn_finish(y, b2), 50)
    ms_1 = device_ms(lambda: ffn.fused_ffn(x, w1, b1, w2, b2), 50)
    plain = time_ms(lambda: ffn.ffn_finish_reference(
        ffn.ffn_partial_reference(*part_args(0)), b2))
    k = F // TP_M
    nbytes = (2 * T * H + 2 * 2 * H * k + 2 * k + 4 * T * H
              + 4 * T * H + 2 * H + 2 * T * H)
    b_ms, b_by = bound(nbytes, 4 * T * H * k, BF16_FLOP_PER_S)
    phase(f"  K5 split {what}: one rank's partial {ms_p:.4f} ms + finish "
          f"{ms_f:.4f} ms = {ms_p + ms_f:.4f} ms; the unsplit K5 at this T "
          f"{ms_1:.4f} ms; plain split {plain:.4f} ms; bound {b_ms:.4f} ms "
          f"({b_by})")
    return dict(name="K5_ffn_split", route="cuda",
                source="cocodr_tpu_torch/csrc/ffn_block.cu",
                replaces="cocodr_tpu/ops/pallas_ffn.py:62",
                max_abs_err=max(errs), ms=ms_p + ms_f, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_splits(ffn, gen, dev):
    """The split forms of K1 (bert-base, and K4's bert-large widths) at the
    encode path's T and of K5 at the training path's T -> their summary
    entries."""
    return [check_split_k1(ffn, gen, dev, ENC_TOKENS, 768, 3072,
                           "K1_ffn_block_split",
                           "cocodr_tpu/ops/pallas_ffn.py:130", 20),
            check_split_k1(ffn, gen, dev, ENC_TOKENS, 1024, 4096,
                           "K4_ffn_block_chunked_split",
                           "cocodr_tpu/ops/pallas_ffn.py:156", 20),
            check_split_k5(ffn, gen, dev, TRAIN_T)]


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
    padding bias (lengths 16..128), at N = 6 (one model rank's heads of
    bert-base split over TP_M = 2, as mesh (h) runs it), and at a COCO
    step's B = 400, timed
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
                    (ENC_BATCH, ENC_LEN, 12 // TP_M), (ENC_BATCH, 32, 12),
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
        if N == 12:  # the summary's shape: a whole layer's heads
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


# --- cli-recipe: the four COCO-DR stages through the port's CLI ------------

# an MS MARCO-shaped collection written from the seed: passages of 20-80
# words, train queries (one positive each) and dev queries of 3-9 of their
# positive's words
CLI_MARCO = dict(passages=16_384, train=4_096, dev=512)
CLI_COCO_STOP = 4  # the resumed coco call starts from this checkpoint
CLI_COCO_STEPS = 6
CLI_WARMUP_STEPS, CLI_WARMUP_EVAL = 6, 3
CLI_ANCE_STEPS, CLI_PAIR_STEPS = 3, 2


class CocoSteps:
    """While in a `with` block, every COCO step the CLI builds records its
    (step, loss) in `losses`."""

    def __init__(self):
        from cocodr_tpu_torch.pipelines import coco

        self.coco, self.build = coco, coco.build_coco_train_step
        self.losses = []

    def __enter__(self):
        def build(cfg):
            step = self.build(cfg)

            def recorded(state, batch, seed=None):
                out = step(state, batch, seed)
                self.losses.append((state.step, out["loss"].item()))
                return out

            return recorded

        self.coco.build_coco_train_step = build
        return self

    def __exit__(self, *exc):
        self.coco.build_coco_train_step = self.build


class InProcessCli:
    """cli.main(argv) in this process, its stdout captured and its launch
    counts zeroed just before and read just after."""

    def __init__(self, on_card, card):
        from cocodr_tpu_torch import cli as tcli

        self.main, self.on_card, self.card = tcli.main, on_card, card
        self.seconds = {}

    def run(self, name, argv, expect=None, exit_code=0):
        """-> (stdout, counts); expect(counts) -> the path's counts (None:
        no kernel); a SystemExit other than exit_code raises."""
        import contextlib
        import io

        buf = io.StringIO()
        zero_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            try:
                self.main(argv)
                code = 0
            except SystemExit as e:
                code = e.code
        secs = time.perf_counter() - t
        self.seconds[name] = self.seconds.get(name, 0.0) + secs
        if code != exit_code:
            raise AssertionError(f"cli-recipe {name}: exit {code}\n"
                                 f"{buf.getvalue()[-4000:]}")
        counts = self.counts(name, expect)
        phase(f"  cli-recipe {name}: {secs:.2f} s in this process")
        return buf.getvalue(), counts

    def counts(self, name, expect):
        counts = read_counts(f"cli-recipe {name}", [])
        if self.on_card:
            want = expect(counts) if expect else {}
            missing = [k for k, v in want.items() if not v]
            if missing:
                raise AssertionError(f"{name}: {missing} never launched")
            check_counts(f"cli-recipe {name}", counts, want)
        return counts


def json_out(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def payload_model(ckpt_dir):
    from cocodr_tpu_torch.utils.train_state import PAYLOAD, latest_checkpoint

    path = latest_checkpoint(ckpt_dir)
    return path, torch.load(os.path.join(path, PAYLOAD), map_location="cpu",
                            weights_only=True, mmap=True)["model"]


def same_tensors(name, got, want, rename=lambda k: k):
    """Every tensor of `want` equal in `got` under rename(key)."""
    differ = [k for k, v in want.items()
              if not torch.equal(got[rename(k)].cpu(), v.cpu())]
    if differ:
        raise AssertionError(f"cli-recipe {name}: {differ[:5]} differ")
    return len(want)


def write_cli_marco(args, root):
    """CLI_MARCO's collection.tsv, queries.{train,dev}.tsv, qrels.{train,
    dev}.tsv (TREC) and triples.tsv (a train query, its positive passage
    and a random other passage a line) from the seed -> the directory."""
    rng = np.random.default_rng([args.seed, 18])
    d = os.path.join(root, "marco_tsv")
    os.makedirs(d)
    n = CLI_MARCO["passages"]
    vocab = np.array([f"w{i}" for i in range(EVAL_VOCAB)])
    lens = rng.integers(20, 81, n)
    words = rng.integers(0, EVAL_VOCAB, int(lens.sum()))
    starts = np.concatenate([[0], np.cumsum(lens)])
    texts = [" ".join(vocab[words[starts[i]:starts[i + 1]]])
             for i in range(n)]
    pids = rng.permutation(10 * n)[:n] + 1
    with open(os.path.join(d, "collection.tsv"), "w") as f:
        f.writelines(f"{p}\t{t}\n" for p, t in zip(pids, texts))
    triples = []
    for split, base in (("train", 1_000_000), ("dev", 2_000_000)):
        pos = rng.integers(0, n, CLI_MARCO[split])
        with open(os.path.join(d, f"queries.{split}.tsv"), "w") as fq, \
                open(os.path.join(d, f"qrels.{split}.tsv"), "w") as fr:
            for j, p in enumerate(pos):
                src = words[starts[p]:starts[p + 1]]
                q = " ".join(vocab[rng.choice(src, rng.integers(3, 10),
                                              replace=False)])
                fq.write(f"{base + j}\t{q}\n")
                fr.write(f"{base + j}\t0\t{pids[p]}\t1\n")
                if split == "train":
                    neg = (p + rng.integers(1, n)) % n
                    triples.append(f"{q}\t{texts[p]}\t{texts[neg]}\n")
    with open(os.path.join(d, "triples.tsv"), "w") as f:
        f.writelines(triples)
    return d


def cli_recipe(args, dev):
    """Phase 17: the four COCO-DR stages as a user types them
    (docs/commands.md) through `cocodr_tpu_torch.cli`, at BERT-base width
    from the cli phase's checkpoint directory, each subcommand in this
    process through cli.main (the async pair as two processes), with the
    launch counts read around each call."""
    from cocodr_tpu_torch.core.configs import WarmupStageConfig
    from cocodr_tpu_torch.data.records import TokenCache, load_qrels
    from cocodr_tpu_torch.data.tokenizer import load_tokenizer
    from cocodr_tpu_torch.evals.mrr_eval import combined_mrr
    from cocodr_tpu_torch.pipelines.eval_beir import eval_beir
    from cocodr_tpu_torch.pipelines.train_step import (
        TrainStepConfig,
        build_train_step,
    )
    from cocodr_tpu_torch.pipelines.warmup import WarmupConfig, run_warmup
    from cocodr_tpu_torch.utils.train_state import TrainState

    card = nvidia_smi()
    on_card = dev.type == "cuda"
    common = [] if on_card else ["--cpu-devices", "1"]
    cli = InProcessCli(on_card, card)
    stage_s = {}
    # the stack ends the async pair's processes before the directory goes
    with tempfile.TemporaryDirectory() as root, \
            contextlib.ExitStack() as stack:
        t = time.perf_counter()
        ckpt = write_cli_checkpoint(args, root)
        data = write_beir_task(np.random.default_rng([args.seed, 16]), root,
                               "scifact")
        marco_tsv = write_cli_marco(args, root)
        with open(os.path.join(ckpt, "config.json")) as f:
            layers = json.load(f)["num_hidden_layers"]
        stage_s["data"] = time.perf_counter() - t

        # 1. preprocess-coco; coco to step 6, and a second call resumed
        # from (a copy of) its checkpoint-4
        t = time.perf_counter()
        spans = os.path.join(root, "spans")
        out, _ = cli.run("preprocess-coco", [
            "preprocess-coco", "--data-dirs", data, "--out", spans,
            "--tokenizer", ckpt])
        coco_line = out.strip().splitlines()[-1]
        heads = 2  # coco-base's c_head

        def coco_counts(steps):
            return lambda c: {"K5_ffn": (layers + heads) * steps}

        coco = ["coco", "--train-dir", spans, "--checkpoint", ckpt,
                "--preset", "coco-base", "--max-steps", str(CLI_COCO_STEPS),
                "--save-steps", str(CLI_COCO_STOP), "--seed",
                str(args.seed), "--log-every", "1"] + common
        ck_whole = os.path.join(root, "coco_ck_whole")
        ck_a = os.path.join(root, "coco_ck")
        with CocoSteps() as rec:
            cli.run("coco", coco + ["--ckpt-dir", ck_whole],
                    coco_counts(CLI_COCO_STEPS))
            whole = rec.losses
            rec.losses = []
            shutil.copytree(os.path.join(ck_whole,
                                         f"checkpoint-{CLI_COCO_STOP}"),
                            os.path.join(ck_a, f"checkpoint-{CLI_COCO_STOP}"))
            out, _ = cli.run("coco (resumed)", coco + [
                "--ckpt-dir", ck_a, "--async-checkpoint"],
                coco_counts(CLI_COCO_STEPS - CLI_COCO_STOP))
            resumed = rec.losses
        if "resumed from" not in out or resumed != whole[CLI_COCO_STOP:]:
            raise AssertionError(f"cli-recipe coco: resumed losses "
                                 f"{resumed} != {whole}")
        path_a, sd_a = payload_model(ck_a)
        _, sd_b = payload_model(ck_whole)
        n = same_tensors("coco resume", sd_a, sd_b)
        phase(f"  cli-recipe coco: {coco_line}; {CLI_COCO_STEPS} steps "
              f"(losses {', '.join(f'{x:.4f}' for _, x in whole)}), then "
              f"a call resumed from checkpoint-{CLI_COCO_STOP} with "
              f"--async-checkpoint: its losses and the {n} tensors of its "
              f"checkpoint-{CLI_COCO_STEPS} equal the uninterrupted run's "
              f"bit for bit [{card}]")
        coco_log = [r for r in json_out(out) if "spans_per_s" in r]
        stage_s["coco"] = time.perf_counter() - t

        # 2. export-hf --from-orbax: the backbone and MLM head
        t = time.perf_counter()
        coco_export = os.path.join(root, "coco_export")
        cli.run("export-hf --from-orbax", [
            "export-hf", "--from-orbax", "--checkpoint", ck_a, "--config",
            ckpt, "--out", coco_export])
        exported = torch.load(os.path.join(coco_export, "pytorch_model.bin"),
                              weights_only=True)
        n = same_tensors("export-hf --from-orbax", exported,
                         {k: v for k, v in sd_a.items()
                          if not k.startswith("c_head.")},
                         lambda k: k[len("bert."):] if k.startswith(
                             "bert.") else k)
        n_head = same_tensors("export-hf model.pt", torch.load(
            os.path.join(coco_export, "model.pt"), weights_only=True),
            {k: v for k, v in sd_a.items() if k.startswith("c_head.")})
        phase(f"  cli-recipe export-hf --from-orbax {path_a}: {n} backbone "
              f"and MLM tensors and {n_head} c_head tensors equal the "
              f"state's bit for bit")
        del exported, sd_a, sd_b
        stage_s["export coco"] = time.perf_counter() - t

        # 3. preprocess-msmarco
        t = time.perf_counter()
        marco = os.path.join(root, "marco")
        cli.run("preprocess-msmarco", [
            "preprocess-msmarco", "--collection",
            os.path.join(marco_tsv, "collection.tsv"),
            "--train-queries", os.path.join(marco_tsv, "queries.train.tsv"),
            "--train-qrels", os.path.join(marco_tsv, "qrels.train.tsv"),
            "--dev-queries", os.path.join(marco_tsv, "queries.dev.tsv"),
            "--dev-qrels", os.path.join(marco_tsv, "qrels.dev.tsv"),
            "--out", marco, "--tokenizer", ckpt, "--n-workers", "8"])
        sizes = {n: len(TokenCache(os.path.join(marco, n)))
                 for n in ("passages", "train-query", "dev-query")}
        if list(sizes.values()) != list(CLI_MARCO.values()):
            raise AssertionError(f"cli-recipe preprocess-msmarco: {sizes}")
        stage_s["preprocess-msmarco"] = time.perf_counter() - t
        phase(f"  cli-recipe preprocess-msmarco: {sizes} in "
              f"{stage_s['preprocess-msmarco']:.2f} s")

        # 4. warmup from the COCO export, against run_warmup here
        t = time.perf_counter()
        n_p, n_dq = CLI_MARCO["passages"], CLI_MARCO["dev"]
        evals = CLI_WARMUP_STEPS // CLI_WARMUP_EVAL

        def warmup_counts(c):
            k1 = evals * layers * (math.ceil(n_p / 512)
                                   + math.ceil(n_dq / 512))
            return {"K5_ffn": 3 * layers * CLI_WARMUP_STEPS,
                    "K1_ffn_block": k1, "K8_attention": k1,
                    "K2_dual_sweep": evals, "K3_topk": c["K3_topk"]}

        triples = os.path.join(marco_tsv, "triples.tsv")
        wck = os.path.join(root, "warmup_ck")
        out, _ = cli.run("warmup", [
            "warmup", "--triples", triples, "--checkpoint", coco_export,
            "--tokenizer", ckpt, "--ckpt-dir", wck, "--batch-size", "64",
            "--max-steps", str(CLI_WARMUP_STEPS), "--eval-data-dir", marco,
            "--eval-every", str(CLI_WARMUP_EVAL), "--async-checkpoint",
            "--log-every", "1", "--seed", str(args.seed)] + common,
            warmup_counts)
        got = json_out(out)
        stage = WarmupStageConfig.base()
        model = tcli_load(coco_export, stage.model_type, dev)
        state = TrainState(model, stage.optimizer.build(model.parameters()))
        qc = TokenCache(os.path.join(marco, "dev-query"))
        pc = TokenCache(os.path.join(marco, "passages"))
        qrels = {q: list(r) for q, r in load_qrels(
            os.path.join(marco, "dev-qrel.tsv")).items()}
        want = []
        zero_counts()
        run_warmup(
            state, build_train_step(TrainStepConfig(loss_kind="nll")),
            triples, load_tokenizer(ckpt),
            WarmupConfig(max_seq_len=stage.max_seq_len, batch_size=64,
                         num_epochs=stage.num_epochs,
                         save_steps=stage.save_steps,
                         max_steps=CLI_WARMUP_STEPS,
                         eval_every_steps=CLI_WARMUP_EVAL, log_every=1),
            os.path.join(root, "warmup_direct"),
            eval_fn=lambda s: want.append({"step": s.step, **combined_mrr(
                s.model, qc, pc, qrels, device=dev)}),
            log_fn=lambda s, m: want.append({"step": s, **m}),
            dropout_seed=args.seed)
        cli.counts("run_warmup in this process", warmup_counts)
        rates = [r.pop("triplets_per_s") for r in got if "loss" in r]
        if got != want:
            raise AssertionError(f"cli-recipe warmup: {got} != {want}")
        path_w, sd_w = payload_model(wck)
        n = same_tensors("warmup", sd_w, state.model.state_dict())
        phase(f"  cli-recipe warmup: {CLI_WARMUP_STEPS} steps of 64 "
              f"triplets (dropout, LAMB of warmup-base), "
              f"{statistics.median(rates[1:]):.1f} triplets/s (the CLI's "
              f"log, median), dev MRR@10 "
              f"{[r['MRR @10'] for r in got if 'MRR @10' in r]}; losses, "
              f"evals and the {n} tensors of {os.path.basename(path_w)} "
              f"equal run_warmup in this process bit for bit [{card}]")
        del model, state, sd_w
        torch.cuda.empty_cache()
        stage_s["warmup"] = time.perf_counter() - t

        # 5. export-hf of the warmup checkpoint, ance (idro), ance --int8
        t = time.perf_counter()
        warmup_export = os.path.join(root, "warmup_export")
        cli.run("export-hf (warmup)", [
            "export-hf", "--checkpoint", wck, "--config", ckpt, "--out",
            warmup_export])

        # 6. the async pair, two processes on a fresh --ckpt-dir, started
        # here to run beside 5, 7 and 8 of this process; read after 8
        pair_t = time.perf_counter()
        pair_ck = os.path.join(root, "pair_ck")
        runner = CliRunner(root)
        pair = ["--data-dir", marco, "--checkpoint", warmup_export,
                "--ckpt-dir", pair_ck, "--rounds", "2", "--poll-secs", "1",
                "--batch-size", "64", "--seed", str(args.seed)] + common
        procs = []
        for name, extra in (("ance-mine", []), ("ance-train", [
                "--steps-per-round", str(CLI_PAIR_STEPS)])):
            cmd, counts_path = runner.command([name] + pair + extra)
            log = stack.enter_context(open(os.path.join(
                root, f"{name}.log"), "w+"))
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                    text=True, env=runner.env, cwd=ROOT)
            stack.callback(proc.kill)
            procs.append((name, counts_path, log, proc))

        ack = os.path.join(root, "ance_ck")
        ance_argv = ["ance", "--data-dir", marco, "--checkpoint",
                     warmup_export, "--ckpt-dir", ack, "--loss-kind",
                     "idro", "--steps-per-round", str(CLI_ANCE_STEPS),
                     "--batch-size", "64", "--seed", str(args.seed)] + common
        encoded = tuple(CLI_MARCO.values())
        eval_batch = argparse.Namespace(batch_size=512)  # ance-base's
        round_counts = []
        with MineRecorder() as mrec:
            def ance_counts(int8, rounds):
                def expect(c):
                    # K1 (K7) one a layer and encoded batch a round; K2
                    # and K3 by the recorded searches of every round
                    e = mine_expected(mrec, eval_batch, layers, encoded)
                    e["K1_ffn_block"] *= rounds
                    e["K8_attention"] *= rounds
                    if int8:
                        e["K7_ffn_block_int8"] = e.pop("K1_ffn_block")
                    e["K5_ffn"] = 3 * layers * CLI_ANCE_STEPS * rounds
                    round_counts.append(e)
                    return e
                return expect

            out, _ = cli.run("ance (idro, 2 rounds)", ance_argv + [
                "--rounds", "2"], ance_counts(False, 2))
            recs = [r for r in json_out(out) if "round" in r]
            names = ann_checkpoints(ack)
            if names != ["step-0", f"step-{CLI_ANCE_STEPS}"]:
                raise AssertionError(f"cli-recipe ance mined from {names}")
            mrec.reset()
            out, _ = cli.run("ance --int8-encode (round 2)", ance_argv + [
                "--rounds", "3", "--int8-encode"], ance_counts(True, 1))
            recs += [r for r in json_out(out) if "round" in r]
        if [r["round"] for r in recs] != [0, 1, 2] or not all(
                r["steps"] == CLI_ANCE_STEPS for r in recs):
            raise AssertionError(f"cli-recipe ance rounds {recs}")
        phase(f"  cli-recipe ance: rounds 0-1 idro, round 1 mined "
              f"{names[1]} (round 0's weights after its steps); round 2 "
              f"resumed with --int8-encode (K7 on its encodes); seconds a "
              f"round {[round(r['seconds'], 2) for r in recs]}; dev "
              f"nDCG@10 {[round(r['ndcg_cut_10'], 4) for r in recs]} "
              f"[{card}]")
        stage_s["ance"] = time.perf_counter() - t

        # 7. export-hf of the ANCE checkpoint, eval-beir, parity
        t = time.perf_counter()
        ance_export = os.path.join(root, "ance_export")
        cli.run("export-hf (ance)", [
            "export-hf", "--checkpoint", ack, "--config", ckpt, "--out",
            ance_export])
        n_docs = BEIR_SHAPES["scifact"]["docs"]
        n_q = BEIR_SHAPES["scifact"]["queries"]

        def eval_counts(c):
            return with_k8({"K1_ffn_block": layers * (
                math.ceil(n_docs / 512) + math.ceil(n_q / 512)),
                "K2_dual_sweep": 1, "K3_topk": c["K3_topk"]})

        work = os.path.join(root, "eval", "scifact")
        out, _ = cli.run("eval-beir", [
            "eval-beir", "--data-dir", data, "--work-dir", work,
            "--checkpoint", ance_export, "--tokenizer", ckpt,
            "--task", "scifact"] + common, eval_counts)
        metrics = json.loads(out[out.index("{"):])
        model = tcli_load(ance_export, "rdot_nll_condenser", dev)
        zero_counts()
        direct = eval_beir(model, data, work, load_tokenizer(ckpt),
                           task="scifact", device=dev)
        cli.counts("eval_beir in this process", eval_counts)
        del model
        if metrics != direct:
            raise AssertionError(f"cli-recipe eval-beir: {metrics} != "
                                 f"{direct}")
        ndcg = metrics["ndcg_cut_10"]
        parity = ["parity", "--checkpoint", ance_export, "--beir-dir", data,
                  "--work-dir", os.path.dirname(work), "--tokenizer",
                  ckpt] + common
        out, _ = cli.run("parity", parity + ["--expect-ndcg", str(ndcg)],
                         eval_counts)
        if json_out(out)[-1]["parity"] != "PASS":
            raise AssertionError(f"cli-recipe parity: {out[-2000:]}")
        out, _ = cli.run("parity (planted)", parity + [
            "--expect-ndcg", str(ndcg + 0.5)], eval_counts, exit_code=1)
        if json_out(out)[-1]["parity"] != "FAIL":
            raise AssertionError(f"cli-recipe parity planted: {out[-2000:]}")
        phase(f"  cli-recipe eval-beir: nDCG@10 {ndcg:.4f}, recall@1000 "
              f"{metrics['recall_1000']:.4f}, equal to eval_beir in this "
              f"process; parity PASS at it, exit 1 at {ndcg + 0.5:.4f} "
              f"[{card}]")
        stage_s["eval"] = time.perf_counter() - t

        # 8. convert-hf and presets
        t = time.perf_counter()
        out, _ = cli.run("convert-hf", ["convert-hf", "--hf-dir",
                                        ance_export])
        n = sum(v.numel() for v in torch.load(os.path.join(
            ance_export, "pytorch_model.bin"), weights_only=True).values())
        with open(os.path.join(ance_export, "config.json")) as f:
            hidden = json.load(f)["hidden_size"]
        want_line = (f"converted {ance_export}: {n / 1e6:.1f}M params, "
                     f"{layers} layers, hidden {hidden}")
        if out.strip() != want_line:
            raise AssertionError(f"cli-recipe convert-hf: {out!r} != "
                                 f"{want_line!r}")
        out, _ = cli.run("presets", ["presets"])
        names = [x[3:-3] for x in out.splitlines() if x.startswith("== ")]
        if names != ["coco-base", "coco-large", "warmup-base",
                     "warmup-large", "ance-base", "ance-large"]:
            raise AssertionError(f"cli-recipe presets: {names}")
        stage_s["convert-hf + presets"] = time.perf_counter() - t

        # 6, read: the async pair
        pair_counts = {}
        for name, counts_path, log, proc in procs:
            proc.wait(timeout=600)
            if proc.returncode != 0:
                log.seek(0)
                raise AssertionError(
                    f"cli-recipe {name}: exit {proc.returncode}\n"
                    f"{log.read()[-4000:]}")
            with open(counts_path) as f:
                pair_counts[name] = json.load(f)
            phase(f"  cli-recipe {name} (a process) launches "
                  f"{pair_counts[name]}")
        if on_card:  # the miner's two rounds mine as the idro call's two
            check_counts("cli-recipe ance-mine", pair_counts["ance-mine"],
                         {k: v for k, v in round_counts[0].items()
                          if k != "K5_ffn"})
            check_counts("cli-recipe ance-train", pair_counts["ance-train"],
                         {"K5_ffn": 3 * layers * CLI_PAIR_STEPS * 2})
        names = ann_checkpoints(pair_ck)
        if names != ["initial", f"checkpoint-{CLI_PAIR_STEPS}"]:
            raise AssertionError(f"cli-recipe async pair mined {names}")
        stage_s["ance-mine + ance-train"] = time.perf_counter() - pair_t
        phase(f"  cli-recipe async pair: ann files from {names}, "
              f"{stage_s['ance-mine + ance-train']:.2f} s for both "
              f"processes, beside 5, 7 and 8 of this process")
    phase(f"  cli-recipe coco: {coco_log[-1]['spans_per_s']:.1f} spans/s "
          f"(the CLI's log, the resumed run's last step) [{card}]")
    phase("  cli-recipe seconds by stage: " + ", ".join(
        f"{k} {v:.2f}" for k, v in stage_s.items()) + f" [{card}]")
    torch.cuda.empty_cache()


def ann_checkpoints(ckpt_dir):
    """The checkpoint names the ann_ndcg_{n} files of ckpt_dir record."""
    from cocodr_tpu_torch.pipelines import ance

    out = []
    for n in range(ance.get_latest_ann_data(os.path.join(
            ckpt_dir, "ann_data"))[0] + 1):
        with open(ance.ann_ndcg_path(os.path.join(ckpt_dir, "ann_data"),
                                     n)) as f:
            out.append(json.load(f)["checkpoint"])
    return out


def tcli_load(path, model_type, dev):
    from cocodr_tpu_torch import cli as tcli

    return tcli._load_model(path, model_type, dev)


def kernel_counters():
    """name -> (wrapper, attribute) of every kernel's launch count."""
    from cocodr_tpu_torch.ops import (
        attention,
        ffn,
        mips_blockmax,
        mips_exact2,
        mips_hier,
        mips_int8,
        moe,
    )

    return {"K1_ffn_block": (ffn.fused_ffn_block, "launches"),
            "K5_ffn": (ffn.fused_ffn, "launches"),
            "K1_split_partial": (ffn.fused_ffn_block_partial, "launches"),
            "K1_split_finish": (ffn.fused_ffn_block_finish, "launches"),
            "K5_split_partial": (ffn.fused_ffn_partial, "launches"),
            "K5_split_finish": (ffn.fused_ffn_finish, "launches"),
            "K2_dual_sweep": (mips_hier.dual_sweep, "launches"),
            "K2_dual_sweep_packed": (mips_hier.dual_sweep, "pack_launches"),
            "K3_topk": (mips_hier.topk, "launches"),
            "K6_int8_sweep": (mips_int8.int8_sweep, "launches"),
            "K7_ffn_block_int8": (ffn.fused_ffn_block_int8, "launches"),
            "K8_attention": (attention.fused_attention_seq_major,
                             "launches"),
            "K9_top2_sweep": (mips_exact2.top2_sweep, "launches"),
            "K10_block32_sweep": (mips_blockmax.block_sweep, "launches"),
            "E1_moe_experts": (moe.expert_ffn, "launches")}


def check_counts(path, counts, expect):
    """Every count equal to the path's own: expect names the kernels the
    path launches, every other count must be 0."""
    want = {name: 0 for name in counts}
    want.update(expect)
    if counts != want:
        raise AssertionError(f"{path}: launch counts {counts} != {want}")


def with_k8(expect, forwards=None):
    """expect with K8's launches added: one for each inference layer
    forward under the default attention_impl ('auto'), which on the card
    takes K8 at every width this script encodes (bf16, head dim 64,
    multiples of 8 up to 512). forwards: their count; None: every K1 and
    K7 launch in expect is an inference layer's."""
    if forwards is None:
        forwards = (expect.get("K1_ffn_block", 0)
                    + expect.get("K7_ffn_block_int8", 0))
    out = dict(expect)
    if forwards:
        out["K8_attention"] = out.get("K8_attention", 0) + forwards
    return out


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
    expect = with_k8(expect)
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


# configuration -> (BertConfig changes, length buckets, records); (a),
# (b) and (d) name the einsum attention chain, so that (c) against (a)
# compares the two formulations and (b), (d) change one thing each; (e)
# and (f) take the default attention_impl ('auto': K8 on the card)
ENCODE_CONFIGS = {
    "a_default": ({"attention_impl": "einsum"}, (), ENC_DOCS),
    "b_buckets": ({"attention_impl": "einsum"}, (32, 64, 128), ENC_DOCS),
    "c_fused_attention": ({"attention_impl": "fused"}, (), ENC_DOCS),
    "d_matmul_int8": ({"matmul_int8": True, "attention_impl": "einsum"}, (),
                      ENC_DOCS),
    "e_bert_large": ({"large": True}, (), LARGE_DOCS),
    "f_default": ({}, (), ENC_DOCS),
}
CPU_DOCS = {"a_default": 4, "c_fused_attention": 4, "d_matmul_int8": 4,
            "e_bert_large": 2}
# min per-row cosine, card against the plain versions on the CPU: bf16
# activations rounded at other points after float32 sums in other orders
CPU_COSINE = 0.999
# min per-row cosine against (a): bucketing changes only the padding the
# attention masks, fused attention (c, and (f)'s default path on the card)
# rounds the probabilities before PV; the int8 bound is
# tests/test_int8_encode.py's
VS_DEFAULT_COSINE = {"b_buckets": 0.999, "c_fused_attention": 0.999,
                     "d_matmul_int8": 0.99, "f_default": 0.999}
# (f) runs K8 on every layer as (c) does: its embeddings equal (c)'s
SAME_AS = {"f_default": "c_fused_attention"}


def cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def takes_k8(bert, width, dev):
    """Whether an inference forward of bert's layers at this width takes
    K8 on dev (models/bert.py's rule: 'fused' at a width divisible by 8,
    'auto' on the card where the kernel takes the shape)."""
    if bert.attention_impl == "fused":
        return width % 8 == 0
    return (bert.attention_impl == "auto"
            and torch.device(dev).type == "cuda"
            and bert.dtype == torch.bfloat16 and bert.head_dim == 64
            and width % 8 == 0 and width <= 512)


def expected_encode_counts(name, bert, cache, buckets, n, dev):
    """The launches of one encode configuration: one FFN kernel (K1, or K7
    with matmul_int8) per layer and batch, and K8 per layer and batch
    where the attention takes it (takes_k8; every bucket width is a
    multiple of 8) -> (launches, batches, layer forwards on K8)."""
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
    k8 = per_batch if takes_k8(bert, cache.max_len, dev) else 0
    return with_k8(expect, k8), batches, k8


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
    from cocodr_tpu_torch.models.bert import BertConfig, BertSelfAttention
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
    paths = dict(BertSelfAttention.forwards)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    out = encode_cache(enc, cache, cfg, indices=idx)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t
    span = start.elapsed_time(end)
    paths = {k: v - paths[k] for k, v in BertSelfAttention.forwards.items()}
    expect, batches, k8 = expected_encode_counts(name, bert, cache, buckets,
                                                 n, dev)
    counts = read_counts(f"encode {name}", list(expect))
    check_counts(f"encode {name}", counts, expect)
    forwards = bert.num_hidden_layers * batches
    phase(f"  encode {name} attention forwards by path: {paths} "
          f"({paths['k8'] / batches:g} K8 and {paths['einsum'] / batches:g} "
          f"einsum a batch)")
    if paths != {"k8": k8, "einsum": forwards - k8}:
        raise AssertionError(f"encode {name}: attention paths {paths}, "
                             f"expected {k8} on K8 of {forwards}")
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
    for name, other in SAME_AS.items():
        same = np.array_equal(outs[name], outs[other])
        phase(f"  encode {name} equals {other} bit for bit: {same}")
        if not same and torch.device(dev).type == "cuda":
            raise AssertionError(f"encode {name} differs from {other}")
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

        # resume: a fresh model takes checkpoint-TRAIN_STEPS and skips its
        # batches before tokenizing them
        zero_counts()
        state, rec2, tok = warmup_run(args, dev, path, ckpt, bert,
                                      TRAIN_RESUME, resume=True, dropout=True)
        counts2 = read_counts("train (resume)", ["K5_ffn"])
        check_counts("train (resume)", counts2, {
            "K5_ffn": 3 * layers * (TRAIN_RESUME - TRAIN_STEPS)})
        losses += check_steps("train (resume)", rec2, TRAIN_STEPS + 1,
                              TRAIN_RESUME, {"K5_ffn": 3 * layers})
        # the tokenizer ran only for the batches after TRAIN_STEPS (3 calls a
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
# FiQA docs and queries re-encoded on the CPU (item 16's rule: 32 read
# 9.2 s of the phase on a slow host; H100 80GB HBM3, 700 W)
EVAL_CPU_ROWS = 16
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
    check_counts(f"eval {name}", counts, with_k8({
        "K1_ffn_block": L * batches, "K2_dual_sweep": 1,
        "K3_topk": counts["K3_topk"]}))
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
    """combined_mrr over the SciFact-shaped records, with a top1000.dev-style
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
    check_counts("eval combined_mrr", counts, with_k8({
        "K1_ffn_block": L * (math.ceil(n_docs / 512)
                             + math.ceil(len(q2o) / 512)),
        "K2_dual_sweep": 1, "K3_topk": counts["K3_topk"]}))
    phase(f"  eval combined_mrr (SciFact records, {len(cands)} queries x "
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
        _, caches = eval_task(args, dev, model, root, "fiqa")
        paths, _ = eval_task(args, dev, model, root, "scifact")
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
# the card-against-CPU iDRO step: batch IDRO_CMP_BATCH, one triplet a
# group (item 16's rule: at 8 its CPU steps read 9.3 s of ance-train and
# 12.6 s of variants on a slow host; H100 80GB HBM3, 700 W)
IDRO_CMP_BATCH, IDRO_CMP_GROUPS = 4, 4
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
    """One iDRO step at IDRO_CMP_BATCH, G = IDRO_CMP_GROUPS, dropout off, on
    the card (K1, K8, bf16) and on the CPU (their plain versions, float32)
    from the same weights and DroState: loss, clipped gradients and h_fun.
    The bounds' calibration holds a bf16 step against a float32 one
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
    batch = ance_batch(data, IDRO_CMP_BATCH, "cpu", IDRO_CMP_GROUPS)
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
    phase(f"  ance compare card vs CPU float32 (iDRO, batch "
          f"{IDRO_CMP_BATCH}, G {IDRO_CMP_GROUPS}, dropout off): loss "
          f"{la:.6f} vs {lb:.6f} (rel {rel:.2e}, bound {CMP_LOSS_RTOL}); "
          f"clipped-gradient cosine "
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
MINE_DOCS = 16_384  # passages of 16-128 tokens
MINE_TRAIN_Q = 4_096  # train queries of 4-23 tokens
MINE_DEV_Q = 1_024
MINE_STEPS = 3  # training steps a round in (a)
ASYNC_STEPS = 2  # train_loop's steps in (b)
# (c): MS MARCO passage's corpus and dev queries; its 502,939 train
# queries cut to 32,768 for the time limit
MARCO_DOCS = 8_841_823
MARCO_DEV_Q = 6_980
MARCO_TRAIN_Q = 32_768
MARCO_CHECK_Q = 1_024  # (c)'s train queries held against the exact search
WALK_STEPS = {"a": 100, "b": 50, "c": 5}  # kmeans_walk's steps a leg
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
    """One mine()'s launches from its recorded searches: K1 and K8 one per
    layer and encoded batch (encoded: the record counts it encoded), K2 one
    per query chunk, K3 by pallas_k3_launches."""
    k1 = layers * sum(-(-n // cfg.batch_size) for n in encoded)
    k2 = k3 = 0
    for s in rec.searches:
        n_q = len(s["queries"])
        k2 += -(-n_q // s["q_chunk"])
        k3 += pallas_k3_launches(n_q, s["q_chunk"], *s["corpus"].shape,
                                 s["n_real"], s["k"])
    return {"K1_ffn_block": k1, "K8_attention": k1, "K2_dual_sweep": k2,
            "K3_topk": k3}


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
    the card in chunks into host memory (what encode_cache hands mine()).
    Each chunk reaches the host through one of two pinned staging buffers,
    and 8 threads copy it into the array while the next chunk is drawn:
    the writes to fresh pageable memory, not the draws, take the time."""
    from concurrent.futures import ThreadPoolExecutor

    gen = torch.Generator(device=dev).manual_seed(args.seed + 12)
    out = np.empty((MARCO_DOCS, DIM), np.float32)
    step, n_threads = 262_144, 8
    stages = [torch.empty(step, DIM, pin_memory=dev.type == "cuda")
              for _ in range(2)]
    pending = [[], []]
    with ThreadPoolExecutor(n_threads) as pool:
        for i, s in enumerate(range(0, MARCO_DOCS, step)):
            for f in pending[i % 2]:
                f.result()
            n = min(step, MARCO_DOCS - s)
            x = torch.randn(n, DIM, generator=gen, device=dev)
            stages[i % 2][:n].copy_(x / x.norm(dim=1, keepdim=True))
            src = stages[i % 2][:n].numpy()
            cuts = np.linspace(0, n, n_threads + 1).astype(int)
            pending[i % 2] = [pool.submit(np.copyto, out[s + a:s + b],
                                          src[a:b])
                              for a, b in zip(cuts[:-1], cuts[1:])]
        for f in pending[0] + pending[1]:
            f.result()
    return out


# --- coco: COCO pretraining at CocoStageConfig.base() ----------------------

COCO_BATCHES = 20  # batches of docs in the span corpus
COCO_STEPS, COCO_SAVE = 6, 3  # leg (a): steps, checkpoint interval
COCO_CACHE_STEPS = 3  # leg (b)
COCO_FUSED_STEPS = 2  # leg (d)
# leg (e): 8 spans (item 16's rule: at 16 its CPU step read 7.0 s)
COCO_CMP_DOCS = 4
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
    the cache step with the wrong chunk's cotangents planted must fail.
    Both of the cache's passes and the direct step take the einsum
    attention chain: pass 1 runs under torch.no_grad, not inference_mode,
    so that its CLS are pass 2's (no K8 launch)."""
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


def record_cls(model):
    """Wrap a Condenser's cls_emb (the grad cache's pass 1) and forward
    (pass 2) to keep each chunk's CLS -> {"pass 1": [...], "pass 2":
    [...]}; `del model.cls_emb, model.forward` removes the wrappers."""
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
    return seen


def check_cls_replay(name, seen, n_chunks):
    """Every chunk's pass-2 CLS equals its pass-1 CLS bit for bit."""
    if not len(seen["pass 1"]) == len(seen["pass 2"]) == n_chunks:
        raise AssertionError(f"{name}: {len(seen['pass 1'])} pass-1 and "
                             f"{len(seen['pass 2'])} pass-2 chunks")
    for i, (a, b) in enumerate(zip(seen["pass 1"], seen["pass 2"])):
        if not torch.equal(a, b):
            raise AssertionError(
                f"{name}: chunk {i}'s pass-2 CLS is not its pass-1 CLS (max "
                f"|diff| {(a.float() - b.float()).abs().max():.3e})")


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

        # (a) the direct step with dropout: 6 steps saving at 3 and 6
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

        # resume: a fresh state loads checkpoint-COCO_SAVE and goes on to
        # COCO_STEPS through span_batches(start_batch=COCO_SAVE), saving
        # through AsyncSaver
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
        seen = record_cls(model)
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
        check_cls_replay("coco (b)", seen, n_chunks * COCO_CACHE_STEPS)
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
VAR_EINSUM_DOCS = 256  # (a) with einsum attention: the first documents
VAR_TRAIN_Q, VAR_DEV_Q, VAR_MINE_K = 2048, 256, 200
LARGE_RECORDS = 2048  # (b): RoBERTa-large records of up to 128 tokens
MC_TRAIN_STEPS = 3  # (e), at MC_TRAIN_BATCH triplets of 64 / 2,048 tokens
# (e)'s card-against-CPU steps: 2 triplets whose documents are cut to 2
# chunks (a float32 CPU step at full depth over documents of 4 chunks
# would take minutes), each its own group in the iDRO step; the nll step
# takes the first triplet alone (item 16's rule: at two its CPU step
# read 42 s of the phase's 166 on a slow host; H100 80GB HBM3, 700 W)
MC_CMP_BATCH, MC_CMP_CHUNKS, MC_NLL_CMP_BATCH = 2, 2, 1
DPR_STEPS = 3  # (f): run_warmup at TRAIN_BATCH x TRAIN_LEN
# (f)'s nll compare (item 16's rule: at 4 its CPU step read 4.8 s); its
# iDRO compare takes IDRO_CMP_BATCH
DPR_CMP_BATCH = 2


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
    expect = with_k8({"K1_ffn_block": layers * batches})
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
    variant_compare(f"variants (e) compare (batch {MC_NLL_CMP_BATCH}, docs "
                    f"of {MC_CMP_CHUNKS} chunks)", model,
                    {k: v[:MC_NLL_CMP_BATCH] for k, v in arrays.items()},
                    expect)
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
    arrays = {k: v[:IDRO_CMP_BATCH] for k, v in arrays.items()}
    arrays["groups"] = np.arange(IDRO_CMP_BATCH) % IDRO_CMP_GROUPS
    variant_idro_compare(
        args, f"variants (f) iDRO compare (batch {IDRO_CMP_BATCH})", model,
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


# --- recipe: the four stages chained, with remat and accumulation ---------

RECIPE_COCO_BATCHES = 4  # batches of 200 docs in (a)'s span corpus
RECIPE_COCO_STEPS = 3  # (a): direct steps with remat, then one cache step
RECIPE_POLICIES = (None, "", "dots_saveable",
                   "no_save:attn_scores,attn_probs")  # None: remat off
RECIPE_ACCUM = 2  # micro-batches an update in (c), (d) and the compare
RECIPE_WARMUP_STEPS, RECIPE_WARMUP_SAVE = 6, 3  # (c): 3 windows
RECIPE_DOCS, RECIPE_TRAIN_Q, RECIPE_DEV_Q = 16_384, 2_048, 256  # (d)
RECIPE_ANCE_STEPS = 2  # (d): one window of dro-greedy
RECIPE_KMEANS_ITERS = 100  # (d): 100 Lloyd steps x 1 restart
# peak memory above the parameters, GiB, predicted from the tensors each
# policy keeps before the first run (PERF.md): a warmup step (64 x
# 128, three towers) and a COCO direct step; printed beside the readings,
# which must also fall in the order no remat > no_save > dots_saveable > ''
RECIPE_PEAK_PREDICTED = {
    "warmup": {None: 14.0, "": 1.5, "dots_saveable": 5.5,
               "no_save:attn_scores,attn_probs": 9.0},
    "coco": {None: 36.0, "": 12.0, "dots_saveable": 19.0,
             "no_save:attn_scores,attn_probs": 26.0}}


def policy_name(policy):
    return "no remat" if policy is None else f"remat {policy!r}"


def with_policy(bert, policy):
    return dataclasses.replace(bert, remat=policy is not None,
                               remat_policy=policy or "")


def check_peaks(name, peaks):
    """peaks {policy: GiB}: printed beside the prediction; the order of
    the policies' memory must hold (remat that keeps everything reads as
    no remat)."""
    want = RECIPE_PEAK_PREDICTED[name]
    phase(f"  recipe {name} step peak memory above the parameters, by "
          f"policy: " + "; ".join(f"{policy_name(p)} {g:.2f} GiB "
                                  f"(predicted ~{want[p]})"
                                  for p, g in peaks.items()))
    order = [peaks[p] for p in (None, RECIPE_POLICIES[3], RECIPE_POLICIES[2],
                                RECIPE_POLICIES[1])]
    if not all(a > b for a, b in zip(order, order[1:])):
        raise AssertionError(f"recipe {name}: the policies' peaks are out of "
                             f"order: {peaks}")


def predicted_launches(policy, forward):
    """A kernel's launches in a forward that launches it `forward` times
    and in its backward: '' and 'dots_saveable' run every remat layer's
    forward again (the kernels are outside what the policy sees); no_save
    recomputes the attention core alone."""
    return forward * (2 if policy in ("", "dots_saveable") else 1)


def recipe_coco(args, dev, root, stage, bert, card):
    """(a) COCO at CocoStageConfig.base() with remat '': direct steps with
    dropout, then a grad-cache step; then one direct step of each policy
    from the same weights for the peak memory -> the state."""
    from cocodr_tpu_torch.data.coco_spans import count_span_batches
    from cocodr_tpu_torch.pipelines.coco import build_coco_train_step
    from cocodr_tpu_torch.utils.train_state import TrainState

    layers, heads = bert.num_hidden_layers, stage.n_head_layers
    docs = stage.per_device_batch_docs
    spans, tok = write_coco_corpus(args, root, docs * RECIPE_COCO_BATCHES)
    total = count_span_batches([spans], docs)
    remat = with_policy(bert, "")
    direct = {"K5_ffn": predicted_launches("", layers) + heads}
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    state = coco_state(args, dev, stage, remat, total)
    rec = coco_run(args, state, stage, spans, tok, 0, RECIPE_COCO_STEPS, True)
    counts = read_counts("recipe (a) COCO direct, remat ''", ["K5_ffn"])
    check_counts("recipe (a) COCO direct, remat ''", counts,
                 {"K5_ffn": direct["K5_ffn"] * RECIPE_COCO_STEPS})
    losses = check_steps("recipe (a) COCO", rec, 1, RECIPE_COCO_STEPS, direct)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sps, n_gaps = spans_per_s(rec, 2 * docs)
    # the grad cache with remat: pass 1 runs without gradients (no remat),
    # pass 2 recomputes each chunk's backbone layers
    n_chunks = 2 * docs // COCO_CHUNK
    cache = {"K5_ffn": n_chunks * (layers + predicted_launches("", layers)
                                   + heads)}
    seen = record_cls(state.model)
    zero_counts()
    rec2 = coco_run(args, state, stage, spans, tok, COCO_CHUNK,
                    RECIPE_COCO_STEPS + 1, True, start=RECIPE_COCO_STEPS)
    del state.model.cls_emb, state.model.forward
    counts2 = read_counts("recipe (a) COCO grad cache, remat ''", ["K5_ffn"])
    check_counts("recipe (a) COCO grad cache, remat ''", counts2, cache)
    losses += check_steps("recipe (a) COCO cache", rec2,
                          RECIPE_COCO_STEPS + 1, RECIPE_COCO_STEPS + 1, cache)
    check_cls_replay("recipe (a) grad cache under remat", seen, n_chunks)
    phase(f"  recipe (a) COCO, remat '', dropout 0.1, {2 * docs} spans x "
          f"{stage.max_seq_length}: {sps:.1f} spans/s (host clock, {n_gaps} "
          f"steps); peak memory {peak:.2f} GiB over the run; then a grad-"
          f"cache step ({n_chunks} chunks) whose pass-2 CLS equal pass 1's "
          f"bit for bit; losses {', '.join(f'{x:.4f}' for x in losses)} "
          f"[{card}]")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(coco_stream(
        args, stage, spans, tok, docs)).items()}
    readings = []
    for policy in RECIPE_POLICIES:
        model = coco_model(args, dev, stage, with_policy(bert, policy), 11)
        model.load_state_dict(state.model.state_dict())
        name = f"recipe (a) COCO direct step, {policy_name(policy)}"
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t = time.perf_counter()
        metrics = build_coco_train_step(coco_config(stage))(
            TrainState(model, NoUpdate(model.parameters())), batch,
            args.seed)
        loss = metrics["loss"].item()
        secs = time.perf_counter() - t
        gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        counts = read_counts(name, ["K5_ffn"])
        check_counts(name, counts, {"K5_ffn": predicted_launches(policy, layers)
                                    + heads})
        readings.append((policy, gib, loss, secs))
        del model
        torch.cuda.empty_cache()
    if len({loss for _, _, loss, _ in readings}) != 1:
        raise AssertionError(f"recipe (a): the policies' COCO losses differ: "
                             f"{readings}")
    phase("  recipe (a) COCO direct step with dropout, by policy: the loss "
          "equal in all; " + "; ".join(
              f"{policy_name(p)} {s:.3f} s (host clock, one step)"
              for p, _, _, s in readings) + f" [{card}]")
    check_peaks("coco", {p: g for p, g, _, _ in readings})
    return state


def recipe_handoff(args, dev, coco, bert):
    """(b) split_state_dict -> state_dict_from_hf -> DualEncoder on the
    card: its backbone must equal the COCO backbone bit for bit."""
    from cocodr_tpu_torch.models.condenser import split_state_dict
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.models.hf import state_dict_from_hf

    backbone, c_head = split_state_dict(coco.model.state_dict())
    model = build_dual_encoder("rdot_nll_condenser", bert, device=dev,
                               generator=torch.Generator().manual_seed(
                                   args.seed + 16))
    model.load_state_dict(state_dict_from_hf(backbone, model.cfg))
    sd = model.encoder.state_dict()
    differ = [k for k, v in coco.model.bert.state_dict().items()
              if not torch.equal(sd[k], v)]
    phase(f"  recipe (b) handoff: {len(backbone)} backbone and "
          f"{len(c_head)} c_head tensors split; the DualEncoder's "
          f"{len(sd)} backbone tensors equal the COCO backbone's bit for bit:"
          f" {not differ}")
    if differ or set(sd) != set(coco.model.bert.state_dict()):
        raise AssertionError(f"recipe (b): handoff lost {differ}")
    return model


def recipe_optimizer(opt):
    """The stage's optimizer cut for a run of a few windows: warmup of 2
    updates in 100, RECIPE_ACCUM micro-batches an update."""
    return dataclasses.replace(opt, warmup_steps=2, total_steps=100,
                               grad_accum_steps=RECIPE_ACCUM)


def recipe_warmup(args, dev, root, model, stage, card):
    """(c) run_warmup at WarmupStageConfig.base()'s model and LAMB (64 x
    128, dropout 0.1, remat '', 2 micro-batches an update): 3 windows
    saving at micro-batch 3, inside the second window; a fresh state
    resumed from checkpoint-3 must end equal to the uninterrupted run bit
    for bit -> (state, triples path)."""
    from cocodr_tpu_torch.pipelines.train_step import build_train_step
    from cocodr_tpu_torch.pipelines.warmup import WarmupConfig, run_warmup
    from cocodr_tpu_torch.utils.train_state import TrainState

    layers = model.cfg.bert.num_hidden_layers
    path = write_triples(args, os.path.join(root, "triples.tsv"),
                         TRAIN_BATCH * (RECIPE_WARMUP_STEPS + 2))
    ckpt = os.path.join(root, "warmup_ckpt")
    opt = recipe_optimizer(stage.optimizer)
    start = copy.deepcopy(model.state_dict())
    per_step = {"K5_ffn": predicted_launches("", 3 * layers)}

    def run(state, steps, resume):
        rec = StepRecorder(build_train_step())
        cfg = WarmupConfig(max_seq_len=TRAIN_LEN, batch_size=TRAIN_BATCH,
                           num_epochs=1, save_steps=RECIPE_WARMUP_SAVE,
                           max_steps=steps, log_every=10 ** 9,
                           keep_checkpoints=2)
        run_warmup(state, rec, path, CountingTokenizer(), cfg, ckpt,
                   resume=resume, dropout_seed=args.seed)
        return rec

    state = TrainState(model, opt.build(model.parameters()))
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    rec = run(state, RECIPE_WARMUP_STEPS, False)
    counts = read_counts("recipe (c) warmup", ["K5_ffn"])
    check_counts("recipe (c) warmup", counts, {
        "K5_ffn": per_step["K5_ffn"] * RECIPE_WARMUP_STEPS})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = check_steps("recipe (c) warmup", rec, 1, RECIPE_WARMUP_STEPS,
                         per_step)
    windows = RECIPE_WARMUP_STEPS // RECIPE_ACCUM
    o = state.optimizer
    if (o.gradient_step, o.mini_step, o.param_groups[0]["count"]) != (
            windows, 0, windows):
        raise AssertionError(f"recipe (c): {o.gradient_step} updates, "
                             f"mini-step {o.mini_step}, count "
                             f"{o.param_groups[0]['count']}")
    # host-clock intervals after 2 untimed micro-batches, leaving out the
    # one that holds the save
    ends = {st: t for st, _, t in rec.records}
    gaps = [ends[i] - ends[i - 1] for i in range(3, RECIPE_WARMUP_STEPS + 1)
            if i != RECIPE_WARMUP_SAVE + 1]
    tps = TRAIN_BATCH * len(gaps) / sum(gaps)
    # resume inside the second window from checkpoint-3
    shutil.rmtree(os.path.join(ckpt, f"checkpoint-{RECIPE_WARMUP_STEPS}"))
    model2 = copy.deepcopy(model)
    model2.load_state_dict(start)
    resumed = TrainState(model2, opt.build(model2.parameters()))
    zero_counts()
    rec2 = run(resumed, RECIPE_WARMUP_STEPS, True)
    counts2 = read_counts("recipe (c) warmup resume", ["K5_ffn"])
    check_counts("recipe (c) warmup resume", counts2, {
        "K5_ffn": per_step["K5_ffn"]
        * (RECIPE_WARMUP_STEPS - RECIPE_WARMUP_SAVE)})
    losses2 = check_steps("recipe (c) warmup resume", rec2,
                          RECIPE_WARMUP_SAVE + 1, RECIPE_WARMUP_STEPS,
                          per_step)
    differ = [k for k, v in state.model.state_dict().items()
              if not torch.equal(v, resumed.model.state_dict()[k])]
    for p, q in zip(state.model.parameters(), resumed.model.parameters()):
        tensors = [(o.acc[p], resumed.optimizer.acc[q])] + [
            (o.state[p][k], resumed.optimizer.state[q][k])
            for k in ("exp_avg", "exp_avg_sq")]
        if not all(torch.equal(a, b) for a, b in tensors):
            differ.append("optimizer state")
            break
    phase(f"  recipe (c) warmup, remat '', {RECIPE_ACCUM} micro-batches of "
          f"{TRAIN_BATCH} x {TRAIN_LEN} an update, dropout 0.1: "
          f"{tps:.1f} triplets/s ({len(gaps)} micro-batches after 2 "
          f"untimed, without the one after the save; host clock); peak "
          f"memory {peak:.2f} GiB; {windows} updates; resumed from "
          f"checkpoint-{RECIPE_WARMUP_SAVE} (mini-step 1 of "
          f"{RECIPE_ACCUM}): losses "
          f"{'equal' if losses2 == losses[RECIPE_WARMUP_SAVE:] else 'differ'}"
          f", {len(differ)} parameter or optimizer tensors differ; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} [{card}]")
    if differ or losses2 != losses[RECIPE_WARMUP_SAVE:]:
        raise AssertionError(f"recipe (c): the resumed run left the "
                             f"uninterrupted one: {differ[:5]}")
    del resumed, model2
    torch.cuda.empty_cache()
    return state, path


def remat_step(args, dev, bert, sd, batch, name, expect):
    """One warmup forward and backward with dropout (the step's generators
    of (seed, 0)), no optimizer -> (loss, {name: gradient} on the card,
    the generators' end states, peak GiB above what was allocated)."""
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.pipelines.train_step import (
        dropout_generators,
        nll_loss,
    )

    model = build_dual_encoder("rdot_nll_condenser", bert, device=dev,
                               generator=torch.Generator().manual_seed(
                                   args.seed))
    model.load_state_dict(sd)
    gens = dropout_generators(args.seed, 0, dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    loss, _ = nll_loss(model, batch, gens)
    loss.backward()
    torch.cuda.synchronize()
    gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    check_counts(name, read_counts(name, list(expect)), expect)
    grads = {k: p.grad for k, p in model.named_parameters()}
    return loss.detach(), grads, [g.get_state() for g in gens], gib


def remat_agreement(ref, got):
    """-> (loss equal, tensors whose gradient differs, max |diff|,
    generators' end states equal)."""
    differ = [k for k, g in ref[1].items() if not torch.equal(g, got[1][k])]
    worst = max(((ref[1][k].float() - got[1][k].float()).abs().max().item()
                 for k in differ), default=0.0)
    gens = all(torch.equal(a, b) for a, b in zip(ref[2], got[2]))
    return torch.equal(ref[0], got[0]), differ, worst, gens


def recipe_remat_compare(args, dev, model, path, card):
    """Remat against no remat at the warmup step's shape (64 x 128, three
    towers, dropout on): one forward and backward for each policy from
    the same weights and generators; the loss and every gradient must be
    bit-equal, the generators end in the same states; a recompute that
    draws from the caller's generator (planted) must differ. The peak
    memory of each, above the parameters."""
    from cocodr_tpu_torch.models import bert as tbert
    from cocodr_tpu_torch.pipelines.warmup import (
        TripleTextBatcher,
        stream_triples,
    )

    triples = [t for t, _ in zip(stream_triples(path), range(TRAIN_BATCH))]
    batch = {k: torch.from_numpy(v).to(dev) for k, v in TripleTextBatcher(
        HashTokenizer(), TRAIN_LEN).collate(triples).items()}
    sd = model.state_dict()
    plain = dataclasses.replace(model.cfg.bert, remat=False, remat_policy="")
    layers = plain.num_hidden_layers
    out = {}
    for policy in RECIPE_POLICIES:
        name = f"recipe remat compare, {policy_name(policy)}"
        out[policy] = remat_step(args, dev, with_policy(plain, policy), sd,
                                 batch, name,
                                 {"K5_ffn": predicted_launches(policy, 3 * layers)})
        torch.cuda.empty_cache()
    real = tbert.recompute_generator
    tbert.recompute_generator = lambda generator, state: generator
    try:
        planted = remat_step(args, dev, with_policy(plain, ""), sd, batch,
                             "recipe remat compare, planted",
                             {"K5_ffn": predicted_launches("", 3 * layers)})
    finally:
        tbert.recompute_generator = real
    check_peaks("warmup", {p: out[p][3] for p in RECIPE_POLICIES})
    ref = out[None]
    lines, bad = [], []
    for policy in RECIPE_POLICIES[1:]:
        same_loss, differ, worst, gens = remat_agreement(ref, out[policy])
        lines.append(f"{policy_name(policy)}: loss "
                     f"{'equal' if same_loss else 'differs'}, "
                     f"{len(differ)} of {len(ref[1])} gradients differ (max "
                     f"|diff| {worst:.3e}), generators' end states "
                     f"{'equal' if gens else 'differ'}")
        if not (same_loss and not differ and gens):
            bad.append(policy)
    p_loss, p_differ, p_worst, _ = remat_agreement(ref, planted)
    phase(f"  recipe remat against no remat, one warmup step of "
          f"{TRAIN_BATCH} x {TRAIN_LEN} with dropout, bound bit-equal: "
          + "; ".join(lines) + f"; the recompute drawing "
          f"from the caller's generator (planted): {len(p_differ)} "
          f"gradients differ (max |diff| {p_worst:.3e}) [{card}]")
    if bad:
        raise AssertionError(f"recipe: remat {bad} changed the step")
    if not p_differ:
        raise AssertionError("recipe: a recompute from the caller's "
                             "generator passes the remat compare")


def recipe_accum_compare(args, dev, model, path, stage):
    """One window of RECIPE_ACCUM micro-batches, CMP_BATCH triples in all
    (their first tokens drawn at random: random_first_token), dropout
    off, on the card (bf16, remat '') and on the CPU (float32 plain
    versions, no remat) from the same weights, both through
    OptimizerConfig(grad_accum_steps=RECIPE_ACCUM): the accumulated
    gradient MultiSteps hands the inner LAMB, by compare_step's bounds;
    both take their first update at rate 0, so the parameters stay."""
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.pipelines.train_step import build_train_step
    from cocodr_tpu_torch.pipelines.warmup import (
        TripleTextBatcher,
        stream_triples,
    )
    from cocodr_tpu_torch.utils.train_state import TrainState

    per = CMP_BATCH // RECIPE_ACCUM
    triples = [t for t, _ in zip(stream_triples(path), range(CMP_BATCH))]
    arrays = random_first_token(args, TripleTextBatcher(
        HashTokenizer(), TRAIN_LEN).collate(triples))
    micro = [{k: v[i:i + per] for k, v in arrays.items()}
             for i in range(0, CMP_BATCH, per)]
    bert = model.cfg.bert
    cpu = build_dual_encoder("rdot_nll_condenser", dataclasses.replace(
        bert, dtype=torch.float32, remat=False), device="cpu",
        generator=torch.Generator().manual_seed(args.seed))
    cpu.load_state_dict(model.state_dict())
    card_model = copy.deepcopy(model)
    layers = bert.num_hidden_layers
    out = {}
    for name, m in (("card", card_model), ("cpu", cpu)):
        d = next(m.parameters()).device
        state = TrainState(m, recipe_optimizer(stage.optimizer).build(
            m.parameters()))
        before = {k: v.clone() for k, v in m.state_dict().items()}
        seen = {}
        inner_step = state.optimizer.inner.step

        def record():
            seen.update({k: p.grad.detach().double().cpu()
                         for k, p in m.named_parameters()})
            inner_step()

        state.optimizer.inner.step = record
        step = build_train_step()
        zero_counts()
        t = time.perf_counter()
        losses = [step(state, {k: torch.from_numpy(v).to(d)
                               for k, v in b.items()})[0].item()
                  for b in micro]
        secs = time.perf_counter() - t
        if name == "card":  # K1 forward and again in the recompute
            n = predicted_launches("", 3 * layers) * RECIPE_ACCUM
            check_counts("recipe accumulation compare (card)", read_counts(
                "recipe accumulation compare (card)", ["K1_ffn_block"]),
                {"K1_ffn_block": n})
        moved = [k for k, v in m.state_dict().items()
                 if not torch.equal(v, before[k])]
        if (moved or state.optimizer.gradient_step != 1
                or state.optimizer.param_groups[0]["count"] != 1):
            raise AssertionError(f"recipe accumulation compare ({name}): "
                                 f"{len(moved)} tensors moved at rate 0")
        out[name] = (statistics.mean(losses), seen)
        phase(f"  recipe accumulation compare: {name} window "
              f"{secs:.2f} s, micro-batch losses "
              f"{', '.join(f'{x:.6f}' for x in losses)}")
    (la, ga), (lb, gb) = out["card"], out["cpu"]
    rel, glob, worst, cos = step_agreement(la, ga, lb, gb)
    # the cosines cannot see a scale (a sum where the mean belongs)
    norm = math.sqrt(sum(g.square().sum().item() for g in ga.values())
                     / sum(g.square().sum().item() for g in gb.values()))
    phase(f"  recipe accumulation compare card (bf16, remat '') vs CPU "
          f"(float32), {RECIPE_ACCUM} x {per} triplets, dropout off: "
          f"mean loss rel {rel:.2e} (bound {CMP_LOSS_RTOL}); the "
          f"accumulated gradient's cosine {glob:.6f} (bound "
          f"{CMP_GLOBAL_COSINE}), norm ratio {norm:.6f} (bound 1 +- "
          f"{CMP_LOSS_RTOL}); worst tensor {worst} {cos:.6f} (bound "
          f"{CMP_TENSOR_COSINE})")
    if not (steps_agree(rel, glob, cos)
            and abs(norm - 1.0) <= CMP_LOSS_RTOL):
        raise AssertionError("recipe: the card's accumulated gradient and "
                             "the CPU's disagree")


def recipe_ance(args, dev, root, model, card):
    """(d) one ance_round of dro-greedy at AnceStageConfig.base() (LAMB,
    2 micro-batches an update, remat '', dropout 0.1) over RECIPE_DOCS
    passages: mine with the warmup's weights, then one window."""
    from cocodr_tpu_torch.core.configs import AnceStageConfig
    from cocodr_tpu_torch.data.streams import TripletBatcher
    from cocodr_tpu_torch.losses.dro import dro_greedy_init
    from cocodr_tpu_torch.pipelines import ance
    from cocodr_tpu_torch.pipelines.train_step import build_train_step
    from cocodr_tpu_torch.utils.train_state import TrainState

    stage = AnceStageConfig.base()
    layers = model.cfg.bert.num_hidden_layers
    cfg = ance.MineConfig(
        topk_training=stage.topk_training,
        negative_sample=stage.negative_sample, n_splits=5,
        cluster_query=True, cluster_centroids=stage.dro.n_groups,
        kmeans_iters=RECIPE_KMEANS_ITERS, kmeans_redo=1,
        batch_size=stage.eval_batch, seed=args.seed)
    pc, tq, dq, positives, dev_qrels = write_mine_data(
        args, root, "recipe", RECIPE_DOCS, RECIPE_DOCS, RECIPE_TRAIN_Q,
        RECIPE_DEV_Q)
    state = TrainState(model, recipe_optimizer(stage.optimizer).build(
        model.parameters()), extra=dro_greedy_init(stage.dro, dev))
    step = StepRecorder(build_train_step(ance_step_config(stage,
                                                          "dro-greedy")))
    work = os.path.join(root, "ann")
    per_step = {"K5_ffn": predicted_launches("", 3 * layers)}
    with MineRecorder() as rec:
        def expect():
            e = mine_expected(rec, cfg, layers,
                              (RECIPE_DOCS, RECIPE_DEV_Q, RECIPE_TRAIN_Q))
            e["K5_ffn"] = per_step["K5_ffn"] * RECIPE_ANCE_STEPS
            return e

        state, m, steps = counted(
            "recipe (d) ance_round",
            lambda: ance.ance_round(
                state, step, TripletBatcher(tq, pc), pc, tq, positives, dq,
                dev_qrels, work, 0, cfg, stage.per_device_batch,
                RECIPE_ANCE_STEPS, dropout_seed=args.seed, device=dev),
            expect, ["K1_ffn_block", "K2_dual_sweep", "K3_topk", "K5_ffn"])
        check_train_search("recipe (d)", rec.searches[1], RECIPE_DOCS, dev)
    if steps != RECIPE_ANCE_STEPS or state.optimizer.gradient_step != 1:
        raise AssertionError(f"recipe (d): {steps} steps, "
                             f"{state.optimizer.gradient_step} updates")
    check_steps("recipe (d) dro-greedy", step, 1, RECIPE_ANCE_STEPS, per_step)
    lines = check_ann_file(ance.ann_data_path(work, 0), RECIPE_DOCS,
                           positives, cfg.cluster_centroids,
                           stage.negative_sample // 5)
    phase(f"  recipe (d) ance_round over {RECIPE_DOCS} passages, "
          f"{RECIPE_TRAIN_Q} train and {RECIPE_DEV_Q} dev queries: time (s) "
          f"{timing_line(m)}; {lines} ann lines; dev ndcg@10 "
          f"{m['ndcg_cut_10']:.4f}; {steps} dro-greedy micro-batches, one "
          f"update [{card}]")
    return state


def recipe(args, dev):
    """Phase 13: the four COCO-DR stages chained through the port at
    BERT-base width, with remat and gradient accumulation. Each leg's
    launches are predicted, checked and printed here."""
    from cocodr_tpu_torch.core.configs import (
        CocoStageConfig,
        WarmupStageConfig,
    )

    coco_stage, warm_stage = CocoStageConfig.base(), WarmupStageConfig.base()
    card = nvidia_smi()
    with tempfile.TemporaryDirectory() as root:
        coco = recipe_coco(args, dev, root, coco_stage, dataclasses.replace(
            coco_stage.bert, dtype=torch.bfloat16), card)
        bert = dataclasses.replace(warm_stage.bert, dtype=torch.bfloat16,
                                   remat=True)
        model = recipe_handoff(args, dev, coco, bert)
        del coco
        torch.cuda.empty_cache()
        state, path = recipe_warmup(args, dev, root, model, warm_stage, card)
        recipe_remat_compare(args, dev, state.model, path, card)
        recipe_accum_compare(args, dev, state.model, path, warm_stage)
        torch.cuda.empty_cache()
        state = recipe_ance(args, dev, root, state.model, card)
        torch.cuda.empty_cache()
        eval_task(args, dev, state.model, root, "scifact")
    torch.cuda.empty_cache()


# --- phases 14-16: the HTTP front end, IVF search, the CLI ------------------

# The IVF phase's corpus: N_DOCS rows around IVF_CENTERS planted centres
# (unit vectors), each row a centre plus IVF_NOISE x a Gaussian of norm ~1,
# row-normalised in bf16; its queries are drawn the same way. The noise
# lets a query's exact top 100 reach into other clusters now and then, so
# recall at a small nprobe falls below 1 and says something.
IVF_CENTERS = 1024
IVF_NOISE = 2.0
IVF_NPROBES = (8, 32)
# recall@100 at nprobe 32 must reach this on the card; PERF.md gives the
# CPU rehearsal it comes from (a quarter of the corpus: 262,144 rows, 256
# centres and clusters, nprobe 8 for the same share of the clusters)
IVF_RECALL_32 = 0.95
HTTP_THREADS = 16
HTTP_SINGLE = 8  # (a): single-query requests a client thread
HTTP_ROUNDS = 4  # (b): requests of BATCH queries a client thread
CLI_WORDS = 20_000  # whole words of the CLI phase's vocab.txt
CLI_REPL_QUERIES = 16
CLI_IVF_NPROBE = 2
NATIVE_BATCHES = 64  # gathers of 512 random records a timing turn
NATIVE_THREADS = 4


def planted_corpus(gen, dev, n, d, n_centers, noise, chunk=131072):
    """(corpus [n, d] bf16, centres [n_centers, d] float32): rows around
    planted centres, row-normalised, drawn on `dev` in chunks."""
    centres = torch.randn(n_centers, d, generator=gen, device=dev)
    centres /= centres.norm(dim=1, keepdim=True)
    corpus = torch.empty((n, d), dtype=torch.bfloat16, device=dev)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        a = torch.randint(0, n_centers, (m,), generator=gen, device=dev)
        x = centres[a] + noise * torch.randn(m, d, generator=gen,
                                             device=dev) / math.sqrt(d)
        corpus[s:s + m] = (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    return corpus, centres


def planted_queries(gen, dev, centres, n, noise):
    d = centres.shape[1]
    a = torch.randint(0, centres.shape[0], (n,), generator=gen, device=dev)
    x = centres[a] + noise * torch.randn(n, d, generator=gen,
                                         device=dev) / math.sqrt(d)
    return (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)


def synchronize(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_calls(fn, dev, runs=3):
    """fn() `runs` times on the host clock, each ended by a synchronize
    -> (median seconds, last result)."""
    walls = []
    for _ in range(runs):
        synchronize(dev)
        t = time.perf_counter()
        out = fn()
        synchronize(dev)
        walls.append(time.perf_counter() - t)
    return statistics.median(walls), out


def check_ivf_ids(name, ids, n_docs):
    """Real rows only (no -1, no pad id), no duplicates in a row."""
    ids = np.asarray(ids)
    if ids.min() < 0 or ids.max() >= n_docs or any(
            len(set(row.tolist())) != ids.shape[1] for row in ids):
        raise AssertionError(f"{name}: ids out of range or repeated")


def ivf_recalls(dev, corpus, q, k, nprobes, seed=0, runs=3):
    """Build a bf16 IVF index of the corpus and search q at each nprobe
    and at full probe, beside the exact 'pallas' search, all against an
    exact plain search -> dict of the readings (build_s, pallas_s, and
    nprobe -> (seconds, recall@k)). The IVF searches must launch no
    kernel; full probe must equal the exact search up to near-ties.
    ivf_rehearsal.py calls this on the CPU."""
    from cocodr_tpu_torch.ops.ivf import build_ivf_index
    from cocodr_tpu_torch.parallel.topk import search_topk

    scores, ref_v, ref_i = exact_search(q, corpus, k)
    tol = 1e-4 * max(1.0, scores.abs().max().item())
    out = {"tol": tol}
    out["build_s"], out["index"] = timed_calls(
        lambda: build_ivf_index(corpus, dtype=torch.bfloat16, device=dev,
                                seed=seed), dev, runs=1)
    index = out["index"]
    zero_counts()
    out["pallas_s"], (pv, pi) = timed_calls(
        lambda: search_topk(q, corpus, k, method="pallas", device=dev), dev,
        runs)
    read_counts("ivf: exact pallas search", ["K2_dual_sweep", "K3_topk"]
                if dev.type == "cuda" else [])
    out["pallas_err"] = check_results(pv, pi, scores, ref_v, tol)
    for nprobe in tuple(nprobes) + (index.n_clusters,):
        zero_counts()
        secs, (v, i) = timed_calls(lambda: search_topk(
            q, None, k, method="ivf", ivf_index=index, ivf_nprobe=nprobe,
            device=dev), dev, runs)
        check_counts(f"ivf nprobe {nprobe}",
                     read_counts(f"ivf nprobe {nprobe}", []), {})
        check_ivf_ids(f"ivf nprobe {nprobe}", i, corpus.shape[0])
        out[nprobe] = (secs, recall(i, ref_i))
        if nprobe == index.n_clusters:
            out["full_err"] = check_results(v, i, scores, ref_v, tol)
    return out


def ivf(args, dev):
    """Phase 15: IVF search over a planted-cluster corpus of N_DOCS x DIM,
    then RetrievalService in ivf mode. -> the serve path's counts."""
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.ops.ivf import ivf_topk
    from cocodr_tpu_torch.pipelines.serve import RetrievalService, ServeConfig

    gen = torch.Generator(device=dev).manual_seed(args.seed + 14)
    corpus, centres = planted_corpus(gen, dev, N_DOCS, DIM, IVF_CENTERS,
                                     IVF_NOISE)
    q = planted_queries(gen, dev, centres, SEARCH_Q, IVF_NOISE)
    card = nvidia_smi()
    r = ivf_recalls(dev, corpus, q, SEARCH_K, IVF_NPROBES, seed=args.seed)
    index = r.pop("index")
    pad = float((index.block_ids < 0).float().mean())
    phase(f"  index of {N_DOCS} x {DIM} bf16 ({IVF_CENTERS} planted "
          f"centres): built in {r['build_s']:.3f} s, {index.n_clusters} "
          f"clusters, {index.n_blocks} blocks of {index.block_size} "
          f"({100 * pad:.1f}% pad rows) [{card}]")
    exact_qps = SEARCH_Q / r["pallas_s"]
    phase(f"  exact pallas search_topk: {exact_qps:.1f} queries/s "
          f"({r['pallas_s'] * 1e3:.3f} ms per {SEARCH_Q}), max score err "
          f"{r['pallas_err']:.3e} [{card}]")
    for nprobe in IVF_NPROBES + (index.n_clusters,):
        secs, rec = r[nprobe]
        phase(f"  ivf nprobe {nprobe}: {SEARCH_Q / secs:.1f} queries/s "
              f"({secs * 1e3:.3f} ms per {SEARCH_Q}; exact pallas "
              f"{exact_qps:.1f}), recall@{SEARCH_K} {rec:.5f} [{card}]")
    phase(f"  ivf full probe ({index.n_clusters}) equals the exact plain "
          f"search up to near-ties: max score err {r['full_err']:.3e} "
          f"(tol {r['tol']:.3e})")
    rec32 = r[32][1]
    if not rec32 >= IVF_RECALL_32:
        raise AssertionError(f"ivf nprobe 32: recall@{SEARCH_K} {rec32} < "
                             f"{IVF_RECALL_32}")
    del index, r
    torch.cuda.empty_cache()

    # RetrievalService in ivf mode: K1 12 a call and no kernel search
    model = build_dual_encoder(
        "rdot_nll_condenser", BertConfig.base(dtype=torch.bfloat16),
        device=dev, generator=torch.Generator().manual_seed(args.seed))
    t = time.perf_counter()
    svc = RetrievalService(model, HashTokenizer(), corpus, device=dev,
                           cfg=ServeConfig(top_k=TOP_K,
                                           max_query_len=QUERY_LEN,
                                           max_batch=BATCH, ivf=True))
    synchronize(dev)
    build_s = time.perf_counter() - t
    rng = np.random.default_rng(args.seed)
    batches = [make_queries(rng, BATCH) for _ in range(3)]
    single = make_queries(rng, 1)
    svc.search(make_queries(rng, BATCH))  # warm-up
    zero_counts()
    results = list(svc.search_stream(batches)) + [svc.search(single)]
    layers = model.cfg.bert.num_hidden_layers
    counts = read_counts("serve ivf", ["K1_ffn_block"]
                         if dev.type == "cuda" else [])
    check_counts("serve ivf", counts, with_k8({"K1_ffn_block": layers * 4})
                 if dev.type == "cuda" else {})
    full = svc.ivf_index.n_clusters
    errs = []
    with torch.inference_mode():
        for texts, (vals, ids) in zip(batches + [single], results):
            pad = svc._bucket(len(texts)) - len(texts)
            tok_ids, tok_mask = svc._tokenize(texts + [""] * pad)
            emb = svc.model.query_emb(torch.from_numpy(tok_ids).to(dev),
                                      torch.from_numpy(tok_mask).to(dev))
            # the service's own call: the padded batch, trimmed after
            want_v, want_i = ivf_topk(emb, svc.ivf_index, TOP_K,
                                      nprobe=svc.cfg.ivf_nprobe)
            emb = emb[:len(texts)]
            want_v = want_v[:len(texts)].cpu().numpy()
            want_i = want_i[:len(texts)].cpu().numpy()
            if not (np.array_equal(np.asarray(ids), want_i)
                    and np.array_equal(vals, want_v)):
                raise AssertionError("serve ivf: results differ from "
                                     "ivf_topk of the same embeddings")
            check_ivf_ids("serve ivf", ids, svc.n_docs)
            # full probe through the service's index equals exact search
            fv, fi = ivf_topk(emb, svc.ivf_index, TOP_K, nprobe=full)
            scores, ref_v, _ = exact_search(emb, corpus, TOP_K)
            tol = 1e-4 * max(1.0, scores.abs().max().item())
            errs.append(check_results(fv.cpu().numpy(), fi.cpu().numpy(),
                                      scores, ref_v, tol))
            del scores
    n_timed = 10
    timed = [make_queries(rng, BATCH) for _ in range(n_timed)]
    synchronize(dev)
    t = time.perf_counter()
    for _ in svc.search_stream(timed):
        pass
    synchronize(dev)
    per_batch = (time.perf_counter() - t) / n_timed
    tok_ids, tok_mask = svc._tokenize(timed[0])
    with torch.inference_mode():
        emb = svc.model.query_emb(torch.from_numpy(tok_ids).to(dev),
                                  torch.from_numpy(tok_mask).to(dev))
        search_s, _ = timed_calls(lambda: svc._search(emb, TOP_K), dev, 5)
    phase(f"  serve ivf (nprobe {svc.cfg.ivf_nprobe} of {full} clusters): "
          f"index built in {build_s:.3f} s at construction; results equal "
          f"ivf_topk of the same embeddings; full probe through its index "
          f"equals the exact plain search (max score err {max(errs):.3e}); "
          f"search_stream {per_batch * 1e3:.3f} ms/batch of {BATCH} "
          f"({BATCH / per_batch:.1f} queries/s), the IVF search alone "
          f"{search_s * 1e3:.3f} ms a batch (host clock) [{card}]")
    del svc, corpus
    torch.cuda.empty_cache()
    return counts


def http_request(port, method, path, body=None, timeout=120):
    """One HTTP request to the local server -> the decoded JSON answer;
    any status but 200 raises."""
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request(method, path,
                  body=None if body is None else json.dumps(body),
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        out = json.loads(r.read())
        if r.status != 200:
            raise AssertionError(f"HTTP {r.status} on {path}: {out}")
        return out
    finally:
        c.close()


def run_clients(fn, jobs):
    """fn(job) for every job on HTTP_THREADS client threads -> (seconds,
    results in job order); a failed request fails the phase."""
    import concurrent.futures

    t = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(HTTP_THREADS) as pool:
        out = list(pool.map(fn, jobs))
    return time.perf_counter() - t, out


def hits_agree(name, hits, vals, ids, tol):
    """HTTP hits (or a CLI's) against a search's rows (vals [Q, k], ids
    [Q][k]): scores within tol, an id in one list and not the other only
    within tol of the k-th score -> the largest score difference."""
    worst = 0.0
    for r, row in enumerate(hits):
        got_i = [h["id"] for h in row]
        got_v = np.array([h["score"] for h in row], np.float64)
        want_v = np.asarray(vals[r], np.float64)
        want_i = [str(d) if not isinstance(d, int) else d for d in ids[r]]
        if got_v.shape != want_v.shape:
            raise AssertionError(f"{name}: row {r} has {len(row)} hits")
        worst = max(worst, float(np.abs(got_v - want_v).max()))
        if worst > tol:
            raise AssertionError(f"{name}: scores of row {r} differ by "
                                 f"{worst} > {tol}")
        for doc in set(got_i) ^ set(want_i):
            v = (got_v[got_i.index(doc)] if doc in got_i
                 else want_v[want_i.index(doc)])
            if abs(v - want_v[-1]) > tol:
                raise AssertionError(f"{name}: row {r}: id {doc} moved")
    return worst


def default_serve_counts(layers, calls):
    """Launches of `calls` default-mode serve calls of a BERT tower."""
    per = SERVE_MODES["default"][2]
    out = {name: n * calls for name, n in per.items()}
    out["K1_ffn_block"] = out["K8_attention"] = layers * calls
    return out


def http(args, dev, corpus):
    """Phase 14: BERT-base behind the HTTP front end in the default mode
    over `corpus` (make_corpus's), HTTP_THREADS client threads: (a) single-query
    requests that coalesce, (b) requests of BATCH queries, timed beside
    search_stream over the same batches."""
    import threading

    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.pipelines.http_serve import make_server
    from cocodr_tpu_torch.pipelines.serve import RetrievalService, ServeConfig

    model = build_dual_encoder(
        "rdot_nll_condenser", BertConfig.base(dtype=torch.bfloat16),
        device=dev, generator=torch.Generator().manual_seed(args.seed))
    svc = RetrievalService(model, HashTokenizer(), corpus, device=dev,
                           cfg=ServeConfig(top_k=TOP_K,
                                           max_query_len=QUERY_LEN,
                                           max_batch=BATCH))
    layers = model.cfg.bert.num_hidden_layers
    del model
    rng = np.random.default_rng(args.seed + 15)
    svc.search(make_queries(rng, BATCH))  # warm-up
    card = nvidia_smi()
    kernels = (["K1_ffn_block", "K2_dual_sweep", "K3_topk"]
               if dev.type == "cuda" else [])
    server, batcher = make_server(svc, port=0, window_s=0.002)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        # (a) single queries from every client coalesce into batches
        singles = make_queries(rng, HTTP_THREADS * HTTP_SINGLE)
        b0 = batcher.batches
        zero_counts()
        secs_a, hits = run_clients(
            lambda text: http_request(port, "POST", "/search",
                                      {"query": text})["hits"], singles)
        n_a = batcher.batches - b0
        counts = read_counts("http (a) single queries", kernels)
        if dev.type == "cuda":
            check_counts("http (a)", counts,
                         default_serve_counts(layers, n_a))
        if not n_a < len(singles):
            raise AssertionError(f"http (a): {n_a} batches for "
                                 f"{len(singles)} requests")
        vals, ids = svc.search(singles)
        scale = max(1.0, float(np.abs(vals).max()))
        worst_a = hits_agree("http (a)", hits, vals, ids, 1e-2 * scale)
        phase(f"  http (a): {len(singles)} single-query requests from "
              f"{HTTP_THREADS} clients in {n_a} batches, "
              f"{len(singles) / secs_a:.1f} queries/s; answers agree with "
              f"search() of all {len(singles)} in one call (other batch "
              f"shapes) within {worst_a:.3e} (tol 1e-2 x max |score|) "
              f"[{card}]")

        # (b) one request a batch: answers equal search() of its texts
        jobs = [make_queries(rng, BATCH)
                for _ in range(HTTP_THREADS * HTTP_ROUNDS)]
        b0 = batcher.batches
        zero_counts()
        secs_b, hits = run_clients(
            lambda texts: http_request(port, "POST", "/search",
                                       {"queries": texts})["hits"], jobs)
        n_b = batcher.batches - b0
        counts = read_counts("http (b) batches", kernels)
        if dev.type == "cuda":
            check_counts("http (b)", counts,
                         default_serve_counts(layers, n_b))
        worst_b = 0.0
        for texts, got in zip(jobs, hits):
            vals, ids = svc.search(texts)
            tol = 1e-4 * max(1.0, float(np.abs(vals).max()))
            worst_b = max(worst_b, hits_agree("http (b)", got, vals, ids,
                                              tol))
        health = http_request(port, "GET", "/healthz")
        if health["n_docs"] != svc.n_docs:
            raise AssertionError(f"http: /healthz {health}")
    finally:
        server.shutdown()
        batcher.stop()
        server.server_close()
        thread.join(timeout=30)
    synchronize(dev)
    t = time.perf_counter()
    for _ in svc.search_stream(jobs, depth=8):
        pass
    synchronize(dev)
    secs_s = time.perf_counter() - t
    n_q = len(jobs) * BATCH
    phase(f"  http (b): {len(jobs)} requests of {BATCH} queries from "
          f"{HTTP_THREADS} clients in {n_b} batches: {n_q / secs_b:.1f} "
          f"queries/s over HTTP, search_stream of the same batches "
          f"{n_q / secs_s:.1f} queries/s; answers equal search() of each "
          f"request's texts up to near-ties (max score diff "
          f"{worst_b:.3e}) [{card}]")
    del svc
    torch.cuda.empty_cache()


# the launcher of a CLI subprocess: runs `python -m cocodr_tpu_torch.cli`
# (run_module as __main__) and writes the process's kernel launch counts
# to the file given first, also when the command fails
CLI_LAUNCHER = '''import importlib, json, runpy, sys
COUNTERS = {counters!r}
out = sys.argv[1]
sys.argv = ["cocodr_tpu_torch.cli"] + sys.argv[2:]
try:
    runpy.run_module("cocodr_tpu_torch.cli", run_name="__main__",
                     alter_sys=True)
except SystemExit as e:
    if e.code not in (None, 0):
        raise
finally:
    counts = {{name: getattr(getattr(importlib.import_module(mod), fn), attr)
              for name, (mod, fn, attr) in COUNTERS.items()}}
    with open(out, "w") as f:
        json.dump(counts, f)
'''


class CliRunner:
    """Runs CLI subcommands in subprocesses from a launcher in `root`."""

    def __init__(self, root):
        counters = {name: (fn.__module__, fn.__name__, attr)
                    for name, (fn, attr) in kernel_counters().items()}
        self.root = root
        self.launcher = os.path.join(root, "launch_cli.py")
        with open(self.launcher, "w") as f:
            f.write(CLI_LAUNCHER.format(counters=counters))
        self.env = dict(os.environ, PYTHONPATH=str(ROOT))
        self.n = 0
        self.jobs = []

    def command(self, argv):
        self.n += 1
        counts = os.path.join(self.root, f"counts_{self.n}.json")
        return [sys.executable, self.launcher, counts] + argv, counts

    def run(self, name, argv, stdin=None):
        """-> (seconds, stdout, launch counts); a failed command raises."""
        return self.finish(name, self.start(argv, stdin))

    def start(self, argv, stdin=None):
        """The command started, its output going to files -> its job for
        finish(); it runs beside this process's work meanwhile."""
        cmd, counts = self.command(argv)
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        proc = subprocess.Popen(
            cmd, stdout=out, stderr=err, text=True, env=self.env, cwd=ROOT,
            stdin=subprocess.DEVNULL if stdin is None else subprocess.PIPE)
        if stdin is not None:
            proc.stdin.write(stdin)
            proc.stdin.close()
        job = (proc, out, err, counts, time.perf_counter())
        self.jobs.append(job)
        return job

    def finish(self, name, job):
        """Wait for a started command -> as run()."""
        proc, out, err, counts, t = job
        proc.wait(timeout=300)
        secs = time.perf_counter() - t
        res = argparse.Namespace(returncode=proc.returncode)
        for key, f in (("stdout", out), ("stderr", err)):
            f.seek(0)
            setattr(res, key, f.read())
            f.close()
        if proc.returncode != 0:
            raise AssertionError(f"cli {name}: exit {proc.returncode}\n"
                                 f"{res.stderr[-4000:]}")
        with open(counts) as f:
            got = json.load(f)
        phase(f"  cli {name}: {secs:.2f} s (a subprocess); launches {got}")
        return secs, res, got

    def kill_all(self):
        """End every started command still running."""
        for job in self.jobs:
            job[0].kill()


def write_cli_checkpoint(args, root):
    """A BERT-base checkpoint directory as HuggingFace writes one of
    BertForMaskedLM: random weights from the seed (bert.* names and the MLM
    head's cls.predictions.*, its decoder tied to the word embeddings,
    pytorch_model.bin), config.json,
    tokenizer_config.json and a vocab.txt of BERT's 30,522 entries: the
    special tokens at their BERT ids, CLI_WORDS whole words w0.., the
    pieces ##0..##9 (so that w{n} >= CLI_WORDS splits into pieces) and
    fillers."""
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.models.hf import state_dict_to_hf

    bert = BertConfig.base()
    model = build_dual_encoder("rdot_nll_condenser", bert, device="cpu",
                               generator=torch.Generator().manual_seed(
                                   args.seed + 16))
    ckpt = os.path.join(root, "ckpt")
    os.makedirs(ckpt)
    sd = state_dict_to_hf(model.state_dict(), model.cfg)
    gen = torch.Generator().manual_seed(args.seed + 17)
    H, pre = bert.hidden_size, "cls.predictions."
    sd.update({
        pre + "transform.dense.weight": torch.randn(
            H, H, generator=gen) * bert.initializer_range,
        pre + "transform.dense.bias": torch.zeros(H),
        pre + "transform.LayerNorm.weight": torch.ones(H),
        pre + "transform.LayerNorm.bias": torch.zeros(H),
        pre + "bias": torch.zeros(bert.vocab_size),
        pre + "decoder.weight": sd["bert.embeddings.word_embeddings.weight"],
        pre + "decoder.bias": torch.zeros(bert.vocab_size)})
    torch.save(sd, os.path.join(ckpt, "pytorch_model.bin"))
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump({"model_type": "bert", "vocab_size": bert.vocab_size,
                   "hidden_size": bert.hidden_size,
                   "num_hidden_layers": bert.num_hidden_layers,
                   "num_attention_heads": bert.num_attention_heads,
                   "intermediate_size": bert.intermediate_size,
                   "hidden_act": "gelu", "max_position_embeddings": 512,
                   "type_vocab_size": 2, "layer_norm_eps": 1e-12,
                   "pad_token_id": 0}, f)
    with open(os.path.join(ckpt, "tokenizer_config.json"), "w") as f:
        json.dump({"do_lower_case": True}, f)
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + [f"w{i}" for i in range(CLI_WORDS)]
             + [f"##{i}" for i in range(10)])
    vocab += [f"x{i}" for i in range(bert.vocab_size - len(vocab))]
    with open(os.path.join(ckpt, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    return ckpt


def roberta_bpe_vocab():
    """RoBERTa-base's byte-level BPE for the cli phase's words w0..,
    made without tokenizers (the card's machine has none). GPT-2's split
    cuts ' w1234' into ' w' and '1234'; the merges, in rank order: Ġ + w,
    the 100 digit pairs, then the 10,000 pairs of two-digit tokens, so a
    number merges where its lowest-ranked pairs fall ('1234' is '1234',
    '5185' is '5' '18' '5'). The vocabulary, 50,265 entries: <s> 0, <pad>
    1, </s> 2, <unk> 3, the 256 byte symbols, the merged tokens, fillers
    and <mask> 50,264. -> (token -> id, merges)."""
    from cocodr_tpu_torch.data.bpe import bytes_to_unicode
    from cocodr_tpu_torch.models.bert import BertConfig

    two = [a + b for a in "0123456789" for b in "0123456789"]
    merges = ([("Ġ", "w")] + [(p[0], p[1]) for p in two]
              + [(p, q) for p in two for q in two])
    tokens = (["<s>", "<pad>", "</s>", "<unk>"]
              + list(bytes_to_unicode().values())
              + [a + b for a, b in merges])
    n = BertConfig.roberta_base().vocab_size
    tokens += [f"Ġf{i}" for i in range(n - 1 - len(tokens))] + ["<mask>"]
    return {t: i for i, t in enumerate(tokens)}, merges


def write_roberta_tokenizer(files_dir, json_dir):
    """The same tokenizer twice: files_dir gets vocab.json, merges.txt and
    tokenizer_config.json (what a RoBERTa checkpoint carries), json_dir a
    hand-written tokenizer.json alone (RobertaTokenizerFast's components,
    merges as 'a b' strings)."""
    vocab, merges = roberta_bpe_vocab()
    with open(os.path.join(files_dir, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(files_dir, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    with open(os.path.join(files_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "RobertaTokenizer",
                   "add_prefix_space": False, "model_max_length": 512}, f)
    added = [dict(id=vocab[t], content=t, single_word=False,
                  lstrip=t == "<mask>", rstrip=False,
                  normalized=t != "<mask>", special=True)
             for t in ("<s>", "<pad>", "</s>", "<unk>", "<mask>")]
    byte_level = dict(type="ByteLevel", add_prefix_space=False,
                      trim_offsets=True, use_regex=True)
    spec = dict(
        version="1.0", truncation=None, padding=None, added_tokens=added,
        normalizer=None, pre_tokenizer=byte_level,
        post_processor=dict(type="RobertaProcessing", sep=["</s>", 2],
                            cls=["<s>", 0], trim_offsets=True,
                            add_prefix_space=False),
        decoder=byte_level,
        model=dict(type="BPE", dropout=None, unk_token=None,
                   continuing_subword_prefix="", end_of_word_suffix="",
                   fuse_unk=False, byte_fallback=False, ignore_merges=False,
                   vocab=vocab, merges=[f"{a} {b}" for a, b in merges]))
    with open(os.path.join(json_dir, "tokenizer.json"), "w") as f:
        json.dump(spec, f)


def write_roberta_checkpoint(args, root):
    """A RoBERTa-base checkpoint directory as HuggingFace writes one of
    RobertaForMaskedLM: random weights from the seed (roberta.* names and
    the MLM head's lm_head.*, its decoder tied to the word embeddings,
    pytorch_model.bin), config.json (model_type roberta, 50,265 words,
    514 positions, one token type, LayerNorm eps 1e-5, pad id 1) and
    write_roberta_tokenizer's vocab.json, merges.txt and
    tokenizer_config.json; beside it a directory with the same tokenizer
    as a tokenizer.json alone. -> (checkpoint dir, tokenizer.json dir)."""
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.models.hf import state_dict_to_hf

    bert = BertConfig.roberta_base()
    model = build_dual_encoder("rdot_nll_condenser", bert, device="cpu",
                               generator=torch.Generator().manual_seed(
                                   args.seed + 18))
    ckpt, json_dir = (os.path.join(root, "roberta_ckpt"),
                      os.path.join(root, "roberta_tokenizer_json"))
    os.makedirs(ckpt)
    os.makedirs(json_dir)
    sd = state_dict_to_hf(model.state_dict(), model.cfg)
    gen = torch.Generator().manual_seed(args.seed + 19)
    H, V = bert.hidden_size, bert.vocab_size
    sd.update({
        "lm_head.dense.weight": torch.randn(
            H, H, generator=gen) * bert.initializer_range,
        "lm_head.dense.bias": torch.zeros(H),
        "lm_head.layer_norm.weight": torch.ones(H),
        "lm_head.layer_norm.bias": torch.zeros(H),
        "lm_head.decoder.weight": sd["roberta.embeddings.word_embeddings.weight"],
        "lm_head.decoder.bias": torch.zeros(V),
        "lm_head.bias": torch.zeros(V)})
    torch.save(sd, os.path.join(ckpt, "pytorch_model.bin"))
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump({"model_type": "roberta", "vocab_size": V,
                   "hidden_size": H,
                   "num_hidden_layers": bert.num_hidden_layers,
                   "num_attention_heads": bert.num_attention_heads,
                   "intermediate_size": bert.intermediate_size,
                   "hidden_act": "gelu",
                   "max_position_embeddings": bert.max_position_embeddings,
                   "type_vocab_size": bert.type_vocab_size,
                   "layer_norm_eps": bert.layer_norm_eps,
                   "pad_token_id": bert.pad_token_id}, f)
    write_roberta_tokenizer(ckpt, json_dir)
    return ckpt, json_dir


def read_trec(path):
    """qid -> [(doc id, score)] in rank order."""
    run = {}
    with open(path) as f:
        for line in f:
            qid, q0, did, rank, score, tag = line.split()
            if q0 != "Q0" or tag != "cocodr_tpu":
                raise AssertionError(f"bad TREC line {line!r}")
            run.setdefault(qid, []).append((did, float(score)))
            if int(rank) != len(run[qid]):
                raise AssertionError(f"bad rank in {line!r}")
    return run


def cli(args, dev):
    """Phase 16: the CLI as a user runs it, each subcommand a subprocess
    (its launch counts written at exit): preprocess-beir of a SciFact-sized
    BEIR task with the port's WordPiece tokenizer, encode of its corpus
    from a BERT-base checkpoint directory, serve --queries (a bulk TREC
    run), serve --search-method ivf (the stdin REPL) and serve --http; each
    output held against the same work in this process. The RoBERTa leg
    (cli_roberta_*) runs its subprocesses beside these, and tokenizes in
    this process while BERT's encode runs."""
    from cocodr_tpu_torch import cli as tcli
    from cocodr_tpu_torch.data.records import TokenCache, load_id_map
    from cocodr_tpu_torch.data.tokenizer import load_tokenizer
    from cocodr_tpu_torch.pipelines.encode import (
        EncodeConfig,
        Encoder,
        encode_cache,
    )
    from cocodr_tpu_torch.pipelines.serve import RetrievalService, ServeConfig

    card = nvidia_smi()
    on_card = dev.type == "cuda"
    common = [] if on_card else ["--cpu-devices", "1"]
    with tempfile.TemporaryDirectory() as root, \
            contextlib.ExitStack() as stack:
        ckpt = write_cli_checkpoint(args, root)
        rng = np.random.default_rng([args.seed, 16])
        data = write_beir_task(rng, root, "scifact")
        rec = os.path.join(root, "rec")
        run = CliRunner(root)
        stack.callback(run.kill_all)
        rob_ckpt, rob_jobs = cli_roberta_start(args, run, root, data)
        secs, _, counts = run.run("preprocess-beir", [
            "preprocess-beir", "--data-dir", data, "--out", rec,
            "--tokenizer", ckpt, "--task", "scifact", "--n-workers", "4"])
        check_counts("cli preprocess-beir", counts, {})
        passages = TokenCache(os.path.join(rec, "passages"))
        n_docs = len(passages)
        phase(f"  cli preprocess-beir: {n_docs} docs at "
              f"{passages.max_len} tokens, "
              f"{len(TokenCache(os.path.join(rec, 'queries')))} queries")

        emb_path = os.path.join(root, "corpus.npy")
        log_dir = os.path.join(root, "log")
        enc_job = run.start([
            "encode", "--checkpoint", ckpt, "--records",
            os.path.join(rec, "passages"), "--out", emb_path,
            "--batch-size", "512", "--log-dir", log_dir] + common)
        rob = cli_roberta_encode(run, rob_ckpt, root, data, rob_jobs,
                                 cli_roberta_here(rob_ckpt, data, root),
                                 common)
        secs, _, counts = run.finish("encode", enc_job)
        tok = load_tokenizer(ckpt)
        id_map = os.path.join(rec, "passages.docid2offset.pickle")
        off2id = {v: k for k, v in load_id_map(id_map).items()}
        doc_ids = [off2id[i] for i in range(n_docs)]
        queries = []
        with open(os.path.join(data, "queries.jsonl")) as f:
            for line in f:
                j = json.loads(line)
                queries.append((j["_id"], j["text"]))
        tsv = os.path.join(root, "queries.tsv")
        with open(tsv, "w") as f:
            f.writelines(f"{q}\t{t}\n" for q, t in queries)
        trec = os.path.join(root, "run.trec")
        repl = [t for _, t in queries[:CLI_REPL_QUERIES]]
        # serve --queries and the ivf REPL run beside this process's work
        q_job = run.start([
            "serve", "--checkpoint", ckpt, "--emb", emb_path, "--id-map",
            id_map, "--queries", tsv, "--output", trec] + common)
        ivf_job = run.start([
            "serve", "--checkpoint", ckpt, "--emb", emb_path, "--id-map",
            id_map, "--search-method", "ivf", "--ivf-nprobe",
            str(CLI_IVF_NPROBE)] + common, stdin="\n".join(repl) + "\n")
        model = tcli._load_model(ckpt, "rdot_nll_condenser", dev)
        layers = model.cfg.bert.num_hidden_layers
        n_batches = math.ceil(n_docs / 512)
        if on_card:
            check_counts("cli encode", counts,
                         with_k8({"K1_ffn_block": layers * n_batches}))
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            enc_rate = json.loads(f.readline())["encode/records_per_s"]
        emb = np.load(emb_path)
        zero_counts()
        direct = encode_cache(Encoder(model, device=dev), passages,
                              EncodeConfig(batch_size=512))
        counts = read_counts("cli: encode_cache in this process",
                             ["K1_ffn_block"] if on_card else [])
        # bit for bit on the card; a CPU rehearsal's two processes sum in
        # other orders (their thread counts differ)
        diff = float(np.abs(emb - direct).max())
        if not diff <= (0.0 if on_card else 1e-5):
            raise AssertionError(f"cli encode: .npy differs from "
                                 f"encode_cache by {diff}")
        phase(f"  cli encode: {n_docs} docs at {passages.max_len} tokens, "
              f"{enc_rate:.1f} docs/s (the CLI's own clock), "
              f"{n_batches} batches of 512; the .npy equals encode_cache "
              f"of the same checkpoint in this process (max |diff| "
              f"{diff:.3e}) [{card}]")

        secs, out, counts = run.finish("serve --queries", q_job)
        n_calls = math.ceil(len(queries) / BATCH)
        if on_card:
            check_counts("cli serve --queries", counts,
                         default_serve_counts(layers, n_calls))
        bulk = json.loads(out.stderr.strip().splitlines()[-1])
        svc = RetrievalService(model, tok, emb, doc_ids=doc_ids, device=dev,
                               cfg=ServeConfig())
        texts = [t for _, t in queries]
        zero_counts()
        results = list(svc.search_stream(
            [texts[i:i + BATCH] for i in range(0, len(texts), BATCH)]))
        read_counts("cli: the same service in this process",
                    ["K1_ffn_block", "K2_dual_sweep", "K3_topk"]
                    if on_card else [])
        got = read_trec(trec)
        vals = np.concatenate([v for v, _ in results])
        ids = [row for _, i in results for row in i]
        hits = [[{"id": d, "score": v} for d, v in got[q]]
                for q, _ in queries]
        # the run file's 6 decimals; the CPU rehearsal's processes differ
        worst = hits_agree("cli serve --queries", hits, vals, ids,
                           1e-6 if on_card else 1e-4)
        phase(f"  cli serve --queries: {len(queries)} queries, TREC run "
              f"equal to RetrievalService.search_stream in this process "
              f"(max score diff {worst:.3e}: the run's 6 decimals); "
              f"{bulk['qps']} queries/s (the CLI's own clock) [{card}]")

        secs, out, counts = run.finish("serve --search-method ivf (REPL)",
                                       ivf_job)
        if on_card:
            check_counts("cli serve ivf", counts,
                         with_k8({"K1_ffn_block": layers * len(repl)}))
        lines = [json.loads(x) for x in out.stdout.splitlines()
                 if x.startswith("{")]
        if lines[0] != {"ready": True, "n_docs": n_docs}:
            raise AssertionError(f"cli serve ivf: {lines[0]}")
        ivf_svc = RetrievalService(model, tok, emb, doc_ids=doc_ids,
                                   device=dev, cfg=ServeConfig(
                                       ivf=True, ivf_nprobe=CLI_IVF_NPROBE))
        worst = 0.0
        for text, line in zip(repl, lines[1:]):
            vals, ids = ivf_svc.search([text])
            tol = 1e-4 * max(1.0, float(np.abs(vals).max()))
            worst = max(worst, hits_agree("cli serve ivf", [line["hits"]],
                                          vals, ids, tol))
        if len(lines) != len(repl) + 1:
            raise AssertionError(f"cli serve ivf: {len(lines)} lines")
        phase(f"  cli serve --search-method ivf: {len(repl)} REPL queries "
              f"({ivf_svc.ivf_index.n_clusters} clusters, nprobe "
              f"{CLI_IVF_NPROBE}) answer as the same IVF service in this "
              f"process (max score diff {worst:.3e})")
        del ivf_svc

        cli_http(run, ckpt, emb_path, id_map, common, svc, texts, layers,
                 on_card, card)
        del svc
        cli_roberta_finish(dev, run, data, rob_ckpt, *rob, on_card, card)
        ivf_eval_and_mine(dev, model, data, rec, tok, root, on_card, card)
        del model
    torch.cuda.empty_cache()


ROBERTA_REC_FILES = ("passages", "passages_meta", "queries",
                     "queries_meta", "passages.docid2offset.pickle",
                     "queries.qid2offset.pickle")


def cli_roberta_start(args, run, root, data):
    """The cli phase's RoBERTa leg, begun beside the BERT leg: the
    RoBERTa-base checkpoint and tokenizer.json directories written, and
    preprocess-beir started with each. -> (checkpoint dir, [records dir,
    job] for each tokenizer directory)."""
    ckpt, json_dir = write_roberta_checkpoint(args, root)
    jobs = []
    for i, tok_dir in enumerate((ckpt, json_dir)):
        rec = os.path.join(root, f"roberta_rec{i}")
        jobs.append((rec, run.start([
            "preprocess-beir", "--data-dir", data, "--out", rec,
            "--tokenizer", tok_dir, "--task", "scifact", "--n-workers",
            "2"])))
    return ckpt, jobs


def cli_roberta_here(ckpt, data, root):
    """The RoBERTa leg's tokenization in this process (the port's
    byte-level BPE from the checkpoint's vocab.json + merges.txt), into
    records to hold the CLI's against. -> (records dir, seconds)."""
    from cocodr_tpu_torch.data.tokenizer import load_tokenizer
    from cocodr_tpu_torch.pipelines import eval_beir as eb

    here = os.path.join(root, "roberta_rec_here")
    t = time.perf_counter()
    eb.prepare_beir_task(data, here, load_tokenizer(ckpt),
                         eb.BeirEvalConfig.for_task("scifact"))
    return here, time.perf_counter() - t


def cli_roberta_encode(run, ckpt, root, data, jobs, here, common):
    """Both preprocess-beir runs finished, their records byte-equal to
    each other (vocab.json + merges.txt and tokenizer.json alone are one
    tokenizer) and to this process's; encode of the passages and serve
    --records --queries (which encodes them again at startup, through the
    native reader) started together. -> (records dir, .npy path, queries,
    TREC path, encode job, serve job)."""
    names = ("vocab.json + merges.txt", "tokenizer.json alone")
    for name, (_, job) in zip(names, jobs):
        _, _, counts = run.finish(f"roberta preprocess-beir ({name})", job)
        check_counts("cli roberta preprocess-beir", counts, {})
    (rec, _), (rec_json, _) = jobs
    here, here_s = here
    for other, what in ((rec_json, "the tokenizer.json directory's"),
                        (here, "this process's")):
        for name in ROBERTA_REC_FILES:
            with open(os.path.join(rec, name), "rb") as f, \
                    open(os.path.join(other, name), "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"cli roberta preprocess-beir: "
                                         f"{name} differs from {what}")
    phase(f"  cli roberta preprocess-beir: the records of the vocab.json + "
          f"merges.txt and the tokenizer.json directories are byte-equal, "
          f"and equal to this process's byte-level BPE ({here_s:.2f} s "
          f"here in one process)")
    queries = []
    with open(os.path.join(data, "queries.jsonl")) as f:
        for line in f:
            j = json.loads(line)
            queries.append((j["_id"], j["text"]))
    tsv = os.path.join(root, "roberta_queries.tsv")
    with open(tsv, "w") as f:
        f.writelines(f"{q}\t{t}\n" for q, t in queries)
    emb_path = os.path.join(root, "roberta_corpus.npy")
    trec = os.path.join(root, "roberta_run.trec")
    passages = os.path.join(rec, "passages")
    enc_job = run.start(["encode", "--checkpoint", ckpt, "--records",
                         passages, "--out", emb_path, "--batch-size",
                         "512", "--log-dir",
                         os.path.join(root, "roberta_log")] + common)
    serve_job = run.start([
        "serve", "--checkpoint", ckpt, "--records", passages, "--id-map",
        passages + ".docid2offset.pickle", "--queries", tsv, "--output",
        trec, "--batch-size", "512"] + common)
    return rec, emb_path, queries, trec, enc_job, serve_job


def native_reader_check(path, card):
    """data/native.py's NativeTokenCache on a records file: byte-equal to
    the memmap TokenCache (batch, batch_with_mask and lengths over every
    record), then timed on batch_with_mask of 512 random records (the
    encode path's gather) at NATIVE_THREADS threads and at one (each call
    starts its threads, as the JAX package's reader does) beside
    TokenCache, in three turns each on the host clock, with no subprocess
    of this phase running."""
    from cocodr_tpu_torch.data.native import NativeTokenCache, library
    from cocodr_tpu_torch.data.records import TokenCache

    t = time.perf_counter()
    library()
    build_s = time.perf_counter() - t
    plain = TokenCache(path)
    fast = NativeTokenCache(path, n_threads=NATIVE_THREADS)
    one = NativeTokenCache(path, n_threads=1)
    every = np.arange(len(plain))
    for method in ("batch", "batch_with_mask"):
        for a, b in zip(getattr(plain, method)(every),
                        getattr(fast, method)(every)):
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                raise AssertionError(f"native reader: {method} differs "
                                     "from TokenCache")
    if plain.lengths().tobytes() != fast.lengths().tobytes():
        raise AssertionError("native reader: lengths differ")
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, len(plain), 512)
               for _ in range(NATIVE_BATCHES)]
    rates = {"native": [], "one": [], "memmap": []}
    for _ in range(3):
        for name, cache in (("native", fast), ("one", one),
                            ("memmap", plain)):
            t = time.perf_counter()
            for idx in batches:
                cache.batch_with_mask(idx)
            rates[name].append(512 * NATIVE_BATCHES
                               / (time.perf_counter() - t))
    fast.close()
    one.close()
    rate = {k: statistics.median(v) for k, v in rates.items()}
    phase(f"  native reader ({build_s:.2f} s to build or load): "
          f"{len(plain)} records of {plain.max_len} tokens byte-equal to "
          f"TokenCache; batch_with_mask of 512 random records "
          f"{rate['native']:.0f} rows/s at {NATIVE_THREADS} threads, "
          f"{rate['one']:.0f} at one, memmap TokenCache "
          f"{rate['memmap']:.0f} rows/s (host clock, "
          f"median of 3 turns of {NATIVE_BATCHES} batches) [{card}]")


def cli_roberta_finish(dev, run, data, ckpt, rec, emb_path, queries, trec,
                       enc_job, serve_job, on_card, card):
    """The RoBERTa leg's checks: the native reader over its records,
    encode's .npy against encode_cache here (K1 12 a batch of 512), then
    serve --records --queries (K1 for its encode and its query batches)
    against RetrievalService.search_stream here over that .npy."""
    from cocodr_tpu_torch import cli as tcli
    from cocodr_tpu_torch.data.native import open_token_cache
    from cocodr_tpu_torch.data.records import load_id_map
    from cocodr_tpu_torch.data.tokenizer import load_tokenizer
    from cocodr_tpu_torch.pipelines.encode import (
        EncodeConfig,
        Encoder,
        encode_cache,
    )
    from cocodr_tpu_torch.pipelines.serve import RetrievalService, ServeConfig

    secs, _, counts = run.finish("roberta encode", enc_job)
    with open(os.path.join(os.path.dirname(emb_path), "roberta_log",
                           "metrics.jsonl")) as f:
        enc_rate = json.loads(f.readline())["encode/records_per_s"]
    native_reader_check(os.path.join(rec, "passages"), card)
    passages = open_token_cache(os.path.join(rec, "passages"))
    n_docs = len(passages)
    model = tcli._load_model(ckpt, "rdot_nll_condenser", dev)
    bert = model.cfg.bert
    if not (bert.position_style == "roberta" and bert.layer_norm_eps == 1e-5
            and bert.vocab_size == 50_265 and bert.pad_token_id == 1):
        raise AssertionError(f"cli roberta: loaded as {bert}")
    layers = bert.num_hidden_layers
    n_batches = math.ceil(n_docs / 512)
    if on_card:
        check_counts("cli roberta encode", counts,
                     with_k8({"K1_ffn_block": layers * n_batches}))
    emb = np.load(emb_path)
    zero_counts()
    direct = encode_cache(Encoder(model, device=dev), passages,
                          EncodeConfig(batch_size=512))
    read_counts("cli roberta: encode_cache in this process",
                ["K1_ffn_block"] if on_card else [])
    passages.close()
    diff = float(np.abs(emb - direct).max())
    if not diff <= (0.0 if on_card else 1e-5):
        raise AssertionError(f"cli roberta encode: .npy differs from "
                             f"encode_cache by {diff}")
    phase(f"  cli roberta encode: RoBERTa-base, {n_docs} docs at "
          f"{passages.max_len} tokens in {n_batches} batches of 512, "
          f"{enc_rate:.1f} docs/s (the CLI's own clock; {secs:.2f} s, a "
          f"subprocess); the .npy equals encode_cache here (max |diff| "
          f"{diff:.3e}) [{card}]")

    secs, _, counts = run.finish("roberta serve --records --queries",
                                 serve_job)
    n_calls = math.ceil(len(queries) / BATCH)
    if on_card:
        want = default_serve_counts(layers, n_calls)
        want["K1_ffn_block"] += layers * n_batches
        want["K8_attention"] += layers * n_batches
        check_counts("cli roberta serve --records --queries", counts, want)
    off2id = {v: k for k, v in load_id_map(
        os.path.join(rec, "passages.docid2offset.pickle")).items()}
    svc = RetrievalService(model, load_tokenizer(ckpt), emb,
                           doc_ids=[off2id[i] for i in range(n_docs)],
                           device=dev, cfg=ServeConfig())
    texts = [t for _, t in queries]
    zero_counts()
    results = list(svc.search_stream(
        [texts[i:i + BATCH] for i in range(0, len(texts), BATCH)]))
    read_counts("cli roberta: the same service in this process",
                ["K1_ffn_block", "K2_dual_sweep", "K3_topk"]
                if on_card else [])
    got = read_trec(trec)
    vals = np.concatenate([v for v, _ in results])
    ids = [row for _, i in results for row in i]
    hits = [[{"id": d, "score": v} for d, v in got[q]] for q, _ in queries]
    worst = hits_agree("cli roberta serve --records --queries", hits, vals,
                       ids, 1e-6 if on_card else 1e-4)
    phase(f"  cli roberta serve --records --queries: {len(queries)} queries "
          f"({secs:.2f} s, a subprocess, its corpus encoded at startup), "
          f"TREC run equal to search_stream here over encode's .npy (max "
          f"score diff {worst:.3e}) [{card}]")


def ivf_eval_and_mine(dev, model, data, rec, tok, root, on_card, card):
    """evaluate_beir_task and mine() by search_method 'ivf' over the cli
    phase's records and model, at full probe (ivf_nprobe past the
    records' clusters): the eval's metrics within near-tie distance of
    the 'pallas' eval's, the ann file's lines valid, time_ivf_build
    reported, and no kernel search launched (K1 and K8 only, for the
    encodes)."""
    from cocodr_tpu_torch.data.records import TokenCache
    from cocodr_tpu_torch.pipelines import ance
    from cocodr_tpu_torch.pipelines import eval_beir as eb

    layers = model.cfg.bert.num_hidden_layers
    kernels = ["K1_ffn_block"] if on_card else []
    cfg = eb.BeirEvalConfig.for_task("scifact", search_method="ivf",
                                     ivf_nprobe=1000)
    paths = eb.prepare_beir_task(data, rec, tok, cfg)  # the CLI's records
    corpus_path, query_path, d2o, q2o, qrels = paths
    n_docs, n_q = len(d2o), len(q2o)
    batches = math.ceil(n_docs / cfg.batch_size) + math.ceil(
        n_q / cfg.batch_size)
    zero_counts()
    got = eb.evaluate_beir_task(model, *paths, cfg, device=dev)
    counts = read_counts("eval scifact by ivf", kernels)
    if on_card:
        check_counts("eval by ivf", counts,
                     with_k8({"K1_ffn_block": layers * batches}))
    want = eb.evaluate_beir_task(model, *paths, dataclasses.replace(
        cfg, search_method="pallas"), device=dev)
    diff = max(abs(got[m] - want[m]) for m in want)
    # near-ties at the k-th score move the metrics by ~1e-3 (the eval
    # phase's card-against-plain reading: 1.67e-3); a wrong search by far
    if not diff <= 1e-2:
        raise AssertionError(f"eval by ivf: metrics {got} against pallas "
                             f"{want}")
    phase(f"  eval scifact by ivf at full probe: ndcg@10 "
          f"{got['ndcg_cut_10']:.4f}, recall@1000 {got['recall_1000']:.4f}; "
          f"'pallas' {want['ndcg_cut_10']:.4f}, "
          f"{want['recall_1000']:.4f} (max |diff| {diff:.2e}) [{card}]")

    qrels_off = {q2o[q]: {d2o[d]: r for d, r in rel.items()}
                 for q, rel in qrels.items()}
    positives = {q: min(rel) for q, rel in qrels_off.items()}
    caches = TokenCache(corpus_path), TokenCache(query_path)
    mcfg = ance.MineConfig(search_method="ivf", ivf_nprobe=1000,
                           batch_size=cfg.batch_size)
    out = os.path.join(root, "mine_ivf")
    zero_counts()
    m = ance.mine(model, None, caches[0], caches[1], positives, caches[1],
                  qrels_off, out, 0, mcfg, device=dev)
    counts = read_counts("mine by ivf", kernels)
    if on_card:
        check_counts("mine by ivf", counts, with_k8({
            "K1_ffn_block": layers * (math.ceil(n_docs / mcfg.batch_size)
                                      + 2)}))
    lines = check_ann_file(ance.ann_data_path(out, 0), n_docs, positives, 1,
                           mcfg.negative_sample // mcfg.n_splits)
    phase(f"  mine by ivf at full probe ({n_docs} passages, {n_q} train "
          f"and dev queries): time (s) {timing_line(m)}; {lines} ann lines "
          f"of real, distinct negatives [{card}]")


def cli_http(run, ckpt, emb_path, id_map, common, svc, texts, layers,
             on_card, card):
    """serve --http in a subprocess: the ready line, two requests of 32
    queries and one of one, /healthz, then SIGINT; the answers held
    against `svc` (the same service in this process)."""
    import signal
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd, counts_path = run.command([
        "serve", "--checkpoint", ckpt, "--emb", emb_path, "--id-map",
        id_map, "--http", f"127.0.0.1:{port}"] + common)
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=run.env,
                            cwd=ROOT)
    try:
        ready = json.loads(proc.stdout.readline())
        up_s = time.perf_counter() - t
        if not ready.get("ready"):
            raise AssertionError(f"cli serve --http: {ready}")
        groups = [texts[:32], texts[32:64], texts[64:65]]
        worst = 0.0
        for group in groups:
            hits = http_request(port, "POST", "/search",
                                {"queries": group})["hits"]
            vals, ids = svc.search(group)
            tol = 1e-4 * max(1.0, float(np.abs(vals).max()))
            worst = max(worst, hits_agree("cli serve --http", hits, vals,
                                          ids, tol))
        health = http_request(port, "GET", "/healthz")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            _, err = proc.communicate(timeout=60)
        finally:
            proc.kill()
    if proc.returncode != 0:
        raise AssertionError(f"cli serve --http: exit {proc.returncode}\n"
                             f"{err[-4000:]}")
    with open(counts_path) as f:
        counts = json.load(f)
    calls = health["batches"] + 1  # the warm-up search before ready
    phase(f"  cli serve --http: ready after {up_s:.2f} s; "
          f"{health['requests']} queries in {health['batches']} batches; "
          f"launches {counts}")
    if on_card:
        check_counts("cli serve --http", counts,
                     default_serve_counts(layers, calls))
    phase(f"  cli serve --http: answers equal RetrievalService.search in "
          f"this process up to near-ties (max score diff {worst:.3e}) "
          f"[{card}]")


MESH_SERVE_BATCHES = 8  # (b): batches of BATCH queries
MESH_WARMUP_STEPS = 5  # (c): steps of each run
MESH_SEARCH_METHODS = (("pallas", ["K2_dual_sweep", "K3_topk"]),
                       ("fast", ["K2_dual_sweep_packed", "K3_topk"]))
# (g): two gloo processes on the one card. gloo_cuda_probe.py found, on
# torch 2.11.0+cu128 (H100 80GB HBM3, 700 W), that gloo takes CUDA
# tensors for every collective the port runs (all_gather, all_reduce,
# broadcast, barrier, broadcast_object_list, and the scatter of the
# differentiable all-gather's backward), so the leg runs: the (a)
# searches with each rank holding half the corpus, then GLOO_STEPS
# data-parallel warmup steps without dropout against a world of one's.
# The CPU tests' 1e-5 in the parameters (tests/test_torch_sharded_train.py)
# holds in float32; in bf16 the halves' gradients round apart (~1e-3) and
# LAMB's first steps, near sign(g) an element, turn that into steps of
# +-lr where a gradient is near 0 (2.6e-4 after 3 steps on the H100). So
# the first step's loss and averaged gradients are held to the world of
# one's by the card-against-CPU bounds (compare_step's, rounding of the
# same kind), every step's loss by CMP_LOSS_RTOL
GLOO_WORLD, GLOO_STEPS = 2, 3
# (g)'s scores against (a)'s: float32 sums of the same bf16 products, in
# another order where the rescoring's shapes differ (a 768-term sum of
# scores ~0.15 moves by ~1e-7); ids may differ only between such ties
GLOO_SCORE_TOL = 1e-6


def same_state_dicts(name, a, b):
    """Two state dicts bit-equal, key for key."""
    diff = [k for k in a if not torch.equal(a[k], b[k])]
    if a.keys() != b.keys() or diff:
        raise AssertionError(f"{name}: tensors differ: {diff[:5]}")


def counted_pair(name, plain, sharded, needed, dev):
    """plain() then sharded(), the counts zeroed before and read after
    each; the sharded path's launches must equal the plain path's ->
    (plain's result, sharded's result, the counts, each path's seconds on
    the host clock)."""
    out, secs, counts = [], [], []
    for tag, fn in (("plain", plain), ("sharded", sharded)):
        zero_counts()
        t = time.perf_counter()
        out.append(fn())
        synchronize(dev)
        secs.append(time.perf_counter() - t)
        counts.append(read_counts(f"mesh {name} ({tag})", needed))
    if counts[0] != counts[1]:
        raise AssertionError(f"mesh {name}: the sharded path launched "
                             f"{counts[1]}, the plain one {counts[0]}")
    return out[0], out[1], counts[1], secs


def mesh_search(args, dev, mesh, corpus, card):
    """(a) mips_topk_sharded against search_topk, 'pallas' and 'fast' ->
    (launch counts, the sharded (scores, ids)) by method."""
    from cocodr_tpu_torch.parallel.topk import (
        distributed_topk,
        mips_topk_sharded,
        search_topk,
    )

    gen = torch.Generator(device=dev).manual_seed(args.seed + 18)
    q = normed(gen, dev, SEARCH_Q, DIM)
    on_card = dev.type == "cuda"
    counts, results = {}, {}
    for method, needed in MESH_SEARCH_METHODS:
        def plain():
            return search_topk(q, corpus, SEARCH_K, method=method,
                               device=dev)

        def sharded():
            return mips_topk_sharded(q, corpus, SEARCH_K, mesh,
                                     method=method, device=dev)

        plain(), sharded()  # warm: the kernels' first launches
        (v0, i0), (v1, i1), c, secs = counted_pair(
            f"(a) search {method}", plain, sharded,
            needed if on_card else [], dev)
        if not (np.array_equal(i0, i1) and np.array_equal(v0, v1)):
            raise AssertionError(f"mesh (a) {method}: the sharded search's "
                                 "results differ from search_topk's")
        counts[method], results[method] = c, (v1, i1)
        phase(f"  mesh (a) {method}: {SEARCH_Q} queries x {N_DOCS} docs, "
              f"k {SEARCH_K}: ids and scores equal search_topk's; "
              f"{SEARCH_Q / secs[1]:.0f} q/s sharded, "
              f"{SEARCH_Q / secs[0]:.0f} q/s plain (host clock); launches "
              f"{ {k: v for k, v in c.items() if v} } [{card}]")
    v = torch.from_numpy(v1).to(dev)
    i = torch.from_numpy(i1).to(dev)
    if on_card:
        ag = time_ms(lambda: distributed_topk(v, i, SEARCH_K, mesh))
        phase(f"  mesh (a) distributed_topk of [{SEARCH_Q}, {SEARCH_K}] "
              f"(the all-gather and the merge): {ag:.4f} ms [{card}]")
    return counts, results


def mesh_serve(args, dev, mesh, corpus, card):
    """(b) the sharded RetrievalService against the plain one."""
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.pipelines.serve import RetrievalService, ServeConfig

    bert = BertConfig.base(dtype=torch.bfloat16)
    model = build_dual_encoder("rdot_nll_condenser", bert, device=dev,
                               generator=torch.Generator().manual_seed(
                                   args.seed))
    cfg = ServeConfig(top_k=TOP_K, max_query_len=QUERY_LEN, max_batch=BATCH)
    rng = np.random.default_rng(args.seed + 18)
    texts = make_queries(rng, BATCH * MESH_SERVE_BATCHES)
    batches = [texts[s:s + BATCH] for s in range(0, len(texts), BATCH)]
    services = [RetrievalService(model, HashTokenizer(), corpus, cfg=cfg,
                                 device=dev),
                RetrievalService(model, HashTokenizer(), corpus, cfg=cfg,
                                 mesh=mesh, device=dev)]
    for svc in services:
        svc.search(batches[0])  # warm
    on_card = dev.type == "cuda"
    (plain, sharded, counts, secs) = counted_pair(
        "(b) serve", lambda: [services[0].search(b) for b in batches],
        lambda: [services[1].search(b) for b in batches],
        ["K1_ffn_block", "K2_dual_sweep", "K3_topk"] if on_card else [],
        dev)
    for (v0, i0), (v1, i1) in zip(plain, sharded):
        if not (np.array_equal(v0, v1) and i0 == i1):
            raise AssertionError("mesh (b): the sharded service's answers "
                                 "differ from the plain one's")
    layers = bert.num_hidden_layers
    if on_card and counts["K1_ffn_block"] != layers * len(batches):
        raise AssertionError(f"mesh (b): K1 {counts['K1_ffn_block']}")
    phase(f"  mesh (b) serve: {len(batches)} batches of {BATCH}, top "
          f"{TOP_K} over {N_DOCS} docs: answers equal the plain service's; "
          f"{secs[1] * 1e3 / len(batches):.2f} ms a batch sharded, "
          f"{secs[0] * 1e3 / len(batches):.2f} plain (host clock); launches "
          f"{ {k: v for k, v in counts.items() if v} } [{card}]")
    return counts


def mesh_warmup(args, dev, mesh, root, card):
    """(c) run_warmup with shard_train_init's state and put_batch against
    the plain run: 5 steps at 64 x 128 with dropout."""
    from cocodr_tpu_torch.core.configs import OptimizerConfig
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.parallel.sharded_train import shard_train_init
    from cocodr_tpu_torch.pipelines.train_step import build_train_step
    from cocodr_tpu_torch.pipelines.warmup import WarmupConfig, run_warmup
    from cocodr_tpu_torch.utils.train_state import TrainState

    bert = BertConfig.base(dtype=torch.bfloat16)
    layers = bert.num_hidden_layers
    path = write_triples(args, os.path.join(root, "triples.tsv"),
                         TRAIN_BATCH * MESH_WARMUP_STEPS)
    runs = []
    for tag, sharded in (("plain", False), ("sharded", True)):
        model = build_dual_encoder("rdot_nll_condenser", bert, device=dev,
                                   generator=torch.Generator().manual_seed(
                                       args.seed))
        opt = OptimizerConfig(lr=2e-4, warmup_steps=5, total_steps=100
                              ).build(model.parameters())
        put = None
        if sharded:
            state, put = shard_train_init(mesh, model, opt)
        else:
            state = TrainState(model, opt)
        rec = StepRecorder(build_train_step())
        cfg = WarmupConfig(max_seq_len=TRAIN_LEN, batch_size=TRAIN_BATCH,
                           num_epochs=1, save_steps=10 ** 9,
                           max_steps=MESH_WARMUP_STEPS, log_every=10 ** 9)
        zero_counts()
        run_warmup(state, rec, path, HashTokenizer(), cfg,
                   os.path.join(root, f"warmup_{tag}"), resume=False,
                   dropout_seed=args.seed, device_put=put)
        check_steps(f"mesh (c) {tag}", rec, 1, MESH_WARMUP_STEPS,
                    {"K5_ffn": 3 * layers} if dev.type == "cuda" else {})
        runs.append(([r[1] for r in rec.records],
                     {k: v.clone() for k, v in
                      state.model.state_dict().items()}))
        del state, model, opt
    if runs[0][0] != runs[1][0]:
        raise AssertionError(f"mesh (c): losses {runs[1][0]} != "
                             f"{runs[0][0]}")
    same_state_dicts("mesh (c) parameters", runs[1][1], runs[0][1])
    phase(f"  mesh (c) warmup: {MESH_WARMUP_STEPS} steps of {TRAIN_BATCH} "
          f"x {TRAIN_LEN} with dropout through shard_train_init and "
          f"put_batch: losses {', '.join(f'{x:.4f}' for x in runs[1][0])} "
          f"and parameters bit-equal to the plain run (K5 {3 * layers} a "
          f"step in both) [{card}]")
    return {"K5_ffn": 3 * layers * MESH_WARMUP_STEPS}


def mesh_coco(args, dev, mesh, card):
    """(d) a direct and a grad-cache COCO step with the span contrastive
    over the world (axis_name) against the plain steps, with dropout."""
    from cocodr_tpu_torch.core.configs import CocoStageConfig
    from cocodr_tpu_torch.parallel.sharded_train import shard_train_init
    from cocodr_tpu_torch.pipelines.coco import build_coco_train_step
    from cocodr_tpu_torch.utils.train_state import TrainState

    stage = CocoStageConfig.base()
    bert = dataclasses.replace(stage.bert, dtype=torch.bfloat16)
    rng = np.random.default_rng([args.seed, 18])
    ids = rng.integers(1000, 30522, (COCO_SPANS, COCO_LEN)).astype(np.int32)
    lens = rng.integers(COCO_LEN // 2, COCO_LEN + 1, COCO_SPANS)
    mask = (np.arange(COCO_LEN)[None, :] < lens[:, None]).astype(np.int32)
    ids = ids * mask
    ids[:, 0] = 101
    labels = np.where((rng.random(ids.shape) < 0.15) & (mask > 0), ids,
                      -100).astype(np.int32)
    host = {"input_ids": ids, "attention_mask": mask, "labels": labels}
    counts = {}
    for chunk in (0, COCO_CHUNK):
        def run(sharded):
            model = coco_model(args, dev, stage, bert, 18)
            opt = stage.optimizer.build(model.parameters())
            if sharded:
                state, put = shard_train_init(mesh, model, opt)
                batch = put(host)
            else:
                state = TrainState(model, opt)
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in host.items()}
            m = build_coco_train_step(coco_config(stage, chunk))(
                state, batch, args.seed)
            return ({k: v.clone() for k, v in m.items()},
                    {k: v.clone() for k, v in model.state_dict().items()})

        name = "cache" if chunk else "direct"
        (m0, p0), (m1, p1), c, secs = counted_pair(
            f"(d) coco {name}", lambda: run(False), lambda: run(True),
            ["K5_ffn"] if dev.type == "cuda" else [], dev)
        if any(not torch.equal(m0[k], m1[k]) for k in m0):
            raise AssertionError(f"mesh (d) {name}: metrics {m1} != {m0}")
        same_state_dicts(f"mesh (d) {name} parameters", p1, p0)
        counts[name] = c
        phase(f"  mesh (d) coco {name} step ({COCO_SPANS} x {COCO_LEN}, "
              f"dropout; chunk {chunk or 'none'}): metrics "
              f"{ {k: round(float(v), 4) for k, v in m1.items()} } and "
              f"parameters bit-equal to the plain step's; launches "
              f"{ {k: v for k, v in c.items() if v} } [{card}]")
    return counts


def mesh_mine(args, dev, mesh, root, card):
    """(e) mine(mesh=) against mine() over MINE_DOCS passages."""
    from cocodr_tpu_torch.core.configs import AnceStageConfig
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.pipelines import ance

    stage = AnceStageConfig.base()
    bert = dataclasses.replace(stage.bert, dtype=torch.bfloat16)
    cfg = ance.MineConfig(
        topk_training=stage.topk_training,
        negative_sample=stage.negative_sample, n_splits=5,
        cluster_query=True, cluster_centroids=stage.dro.n_groups,
        kmeans_iters=50, kmeans_redo=1, batch_size=stage.eval_batch,
        seed=args.seed)
    pc, tq, dq, positives, dev_qrels = write_mine_data(
        args, root, "mesh_mine", MINE_DOCS, MINE_DOCS, MINE_TRAIN_Q,
        MINE_DEV_Q)
    model = build_dual_encoder(stage.model_type, bert, device=dev,
                               generator=torch.Generator().manual_seed(
                                   args.seed))

    def run(tag, mesh_):
        return ance.mine(model, None, pc, tq, positives, dq, dev_qrels,
                         os.path.join(root, f"mine_{tag}"), 0, cfg,
                         mesh=mesh_, device=dev)

    m0, m1, c, secs = counted_pair(
        "(e) mine", lambda: run("plain", None), lambda: run("mesh", mesh),
        ["K1_ffn_block", "K2_dual_sweep", "K3_topk"]
        if dev.type == "cuda" else [], dev)
    a, b = (open(ance.ann_data_path(os.path.join(root, f"mine_{t}"), 0)).read()
            for t in ("plain", "mesh"))
    if a != b or not a:
        raise AssertionError("mesh (e): mine(mesh=)'s ann file differs")
    keys = [k for k in m0 if not k.startswith("time_")]
    if any(m0[k] != m1[k] for k in keys):
        raise AssertionError(f"mesh (e): dev metrics differ")
    phase(f"  mesh (e) mine(mesh=): {MINE_DOCS} passages, {MINE_TRAIN_Q} "
          f"train and {MINE_DEV_Q} dev queries: the ann file "
          f"({len(a.splitlines())} lines) and the dev metrics equal "
          f"mine()'s; {secs[1]:.2f} s against {secs[0]:.2f} s; launches "
          f"{ {k: v for k, v in c.items() if v} } [{card}]")
    return c


def mesh_cli_start(args, dev, root):
    """(f), started: eval-beir --mesh auto in a subprocess on the cli
    phase's SciFact-sized task, running beside (c)-(e) -> its job."""
    ckpt = write_cli_checkpoint(args, root)
    rng = np.random.default_rng([args.seed, 16])
    data = write_beir_task(rng, root, "scifact")
    run = CliRunner(root)
    common = [] if dev.type == "cuda" else ["--cpu-devices", "1"]
    job = run.start([
        "eval-beir", "--data-dir", data, "--work-dir",
        os.path.join(root, "w_mesh"), "--checkpoint", ckpt, "--task",
        "scifact", "--mesh", "auto"] + common)
    return {"run": run, "job": job, "ckpt": ckpt, "data": data}


def mesh_cli_finish(dev, root, job, card):
    """(f), read: the subprocess's metrics and launches against eval_beir
    in this process without a mesh."""
    from cocodr_tpu_torch import cli as tcli
    from cocodr_tpu_torch.data.tokenizer import load_tokenizer
    from cocodr_tpu_torch.pipelines.eval_beir import eval_beir

    secs, out, counts = job["run"].finish(
        "eval-beir --mesh auto (beside (c)-(e))", job["job"])
    got = json.loads(out.stdout[out.stdout.index("{"):])
    model = tcli._load_model(job["ckpt"], "rdot_nll_condenser", dev)
    zero_counts()
    want = eval_beir(model, job["data"], os.path.join(root, "w_plain"),
                     load_tokenizer(job["ckpt"]), task="scifact",
                     device=dev)
    plain = read_counts("mesh (f) eval_beir in this process", [])
    if counts != plain:
        raise AssertionError(f"mesh (f): eval-beir --mesh auto launched "
                             f"{counts}, eval_beir here {plain}")
    worst = max(abs(got[k] - want[k]) for k in want)
    if got.keys() != want.keys() or worst > 1e-6:
        raise AssertionError(f"mesh (f): metrics {got} != {want}")
    phase(f"  mesh (f) cli eval-beir --mesh auto: {secs:.2f} s (a "
          f"subprocess); nDCG@10 {got['ndcg_cut_10']:.4f}, every metric "
          f"within {worst:.1e} of eval_beir without a mesh; launches "
          f"{ {k: v for k, v in counts.items() if v} } [{card}]")
    return counts


def to_host(x):
    """A tensor or array -> a numpy array on the host."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def tie_moves(v, i, v0, i0):
    """Top-k (scores, ids) [Q, k] against (v0, i0) of the same search ->
    (max |score diff|, the rows whose ids differ). Raises unless every
    differing position is a tie: the id's own score in the other list
    (or, if it fell out, that list's k-th score) within GLOO_SCORE_TOL."""
    err = float(np.abs(v.astype(np.float64) - v0.astype(np.float64)).max())
    rows = np.flatnonzero((i != i0).any(axis=1)).tolist()
    for r in rows:
        for a, b, va, vb in ((i[r], i0[r], v[r], v0[r]),
                             (i0[r], i[r], v0[r], v[r])):
            at = {d: n for n, d in enumerate(b.tolist())}
            for n in np.flatnonzero(a != b):
                m = at.get(int(a[n]))
                other = vb[m] if m is not None else vb[-1]
                if abs(float(va[n]) - float(other)) > GLOO_SCORE_TOL:
                    raise AssertionError(
                        f"mesh (g): row {r}, id {int(a[n])} at {n} scores "
                        f"{float(va[n])!r}, {float(other)!r} in the other "
                        "list: not a tie")
    return err, rows


def gloo_warmup(seed, triples, ckpt_dir, dev, mesh=None):
    """GLOO_STEPS warmup steps of TRAIN_BATCH x TRAIN_LEN without dropout
    from the seed's weights, data-parallel over `mesh` (shard_train_init)
    or on one device -> (losses, the parameters on the host, launches,
    the first step's gradients after the average and the clip)."""
    from cocodr_tpu_torch.core.configs import OptimizerConfig
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.parallel.sharded_train import shard_train_init
    from cocodr_tpu_torch.pipelines.train_step import build_train_step
    from cocodr_tpu_torch.pipelines.warmup import WarmupConfig, run_warmup
    from cocodr_tpu_torch.utils.train_state import TrainState

    model = build_dual_encoder(
        "rdot_nll_condenser", BertConfig.base(dtype=torch.bfloat16),
        device=dev, generator=torch.Generator().manual_seed(seed))
    opt = OptimizerConfig(lr=2e-4, warmup_steps=5, total_steps=100
                          ).build(model.parameters())
    put = None
    if mesh is None:
        state = TrainState(model, opt)
    else:
        state, put = shard_train_init(mesh, model, opt)
    rec = StepRecorder(build_train_step())
    first = {}

    def step(st, batch, gens):
        out = rec(st, batch, gens)
        if not first:
            first.update({k: p.grad.detach().float().cpu()
                          for k, p in st.model.named_parameters()
                          if p.grad is not None})
        return out

    cfg = WarmupConfig(max_seq_len=TRAIN_LEN, batch_size=TRAIN_BATCH,
                       num_epochs=1, save_steps=10 ** 9,
                       max_steps=GLOO_STEPS, log_every=10 ** 9)
    zero_counts()
    run_warmup(state, step, triples, HashTokenizer(), cfg, ckpt_dir,
               resume=False, dropout_seed=None, device_put=put)
    counts = read_counts("mesh (g) warmup", ["K1_ffn_block"])
    return ([r[1] for r in rec.records],
            {k: v.detach().cpu().clone()
             for k, v in state.model.state_dict().items()}, counts, first)


def gloo_rank(seed, triples, work):
    """(g), one rank of GLOO_WORLD joined over gloo on the one card
    (core/mesh.py::spawn): the (a) searches with this rank's share of the
    corpus, then gloo_warmup over the world -> {search: (scores, ids) by
    method, counts, losses, digest: a CRC of the parameters' bytes, and,
    on rank 0, the parameters}."""
    import torch.distributed as dist

    from cocodr_tpu_torch.core.mesh import MeshConfig, create_mesh
    from cocodr_tpu_torch.parallel.topk import mips_topk_sharded

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = create_mesh(MeshConfig(), dev)
    rank = dist.get_rank()
    # the corpus and queries of mesh() and mesh_search, from the seed
    corpus = make_corpus(torch.Generator(device=dev).manual_seed(seed), dev)
    q = normed(torch.Generator(device=dev).manual_seed(seed + 18), dev,
               SEARCH_Q, DIM)
    out = {"search": {}, "counts": {}}
    for method, needed in MESH_SEARCH_METHODS:
        zero_counts()
        v, i = mips_topk_sharded(q, corpus, SEARCH_K, mesh, method=method,
                                 device=dev)
        out["search"][method] = (to_host(v), to_host(i))
        out["counts"][method] = read_counts(
            f"mesh (g) rank {rank} {method}", needed)
    del corpus, q
    torch.cuda.empty_cache()
    losses, params, out["counts"]["warmup"], grads = gloo_warmup(
        seed, triples, os.path.join(work, "warmup"), dev, mesh)
    crc = 0
    for v in params.values():
        crc = zlib.crc32(v.numpy().tobytes(), crc)
    out.update(losses=losses, digest=crc)
    if rank == 0:
        out.update(params=params, grads=grads)
    return out


def mesh_gloo_start(args, root):
    """(g), started: the world of GLOO_WORLD gloo processes on a thread, so
    that it runs beside (c)-(f) -> (thread, its outcome dict)."""
    import threading

    from cocodr_tpu_torch.core.mesh import spawn

    triples = write_triples(args, os.path.join(root, "gloo_triples.tsv"),
                            TRAIN_BATCH * GLOO_STEPS)
    work = os.path.join(root, "gloo")
    outcome = {"triples": triples}

    def run():
        t = time.perf_counter()
        try:
            outcome["ranks"] = spawn(gloo_rank, GLOO_WORLD,
                                     os.path.join(work, "store"), args.seed,
                                     triples, work, timeout=600)
        except BaseException as e:  # raised again by mesh_gloo_finish
            outcome["error"] = e
        outcome["seconds"] = time.perf_counter() - t

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, outcome


def mesh_gloo_finish(args, dev, root, started, searched, search_counts,
                     card):
    """(g), read: each rank's search ids equal (a)'s up to ties and its
    launches the plain per-shard ones; the ranks' parameters
    bit-identical; against a world of one (gloo_warmup in this process on
    the same data, while the world runs) the first step's loss and
    averaged gradients by compare_step's bounds, every step's loss within
    CMP_LOSS_RTOL; the parameters' largest difference reported."""
    from cocodr_tpu_torch.models.bert import BertConfig

    thread, outcome = started
    losses1, params1, counts1, grads1 = gloo_warmup(
        args.seed, outcome["triples"], os.path.join(root, "gloo_one"), dev)
    layers = BertConfig.base().num_hidden_layers
    check_counts("mesh (g) world of one", counts1,
                 {"K1_ffn_block": 3 * layers * GLOO_STEPS})
    thread.join(660)
    if thread.is_alive():
        raise AssertionError("mesh (g): the gloo world has not ended")
    if "error" in outcome:
        raise AssertionError("mesh (g): the gloo world failed") \
            from outcome["error"]
    ranks = outcome["ranks"]
    score_err, tied = 0.0, {}
    for r, res in enumerate(ranks):
        for method, _ in MESH_SEARCH_METHODS:
            v, i = res["search"][method]
            err, rows = tie_moves(v, i, *searched[method])
            phase(f"  mesh (g) rank {r} {method}: scores max |diff| "
                  f"{err:.3e} against (a)'s, {len(rows)} rows whose ids "
                  f"differ (rows {rows[:8]})")
            if err > GLOO_SCORE_TOL:
                raise AssertionError(f"mesh (g) rank {r} {method}: scores "
                                     f"{err:.3e} off (a)'s")
            score_err = max(score_err, err)
            tied[method] = len(rows)
            check_counts(f"mesh (g) rank {r} {method}",
                         res["counts"][method], search_counts[method])
        check_counts(f"mesh (g) rank {r} warmup", res["counts"]["warmup"],
                     counts1)
    if len({res["digest"] for res in ranks}) != 1:
        raise AssertionError("mesh (g): the ranks' parameters differ")
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(ranks[0]["losses"], losses1))
    rel, glob, gworst, gcos = step_agreement(
        ranks[0]["losses"][0], ranks[0]["grads"], losses1[0], grads1)
    worst = max(params1, key=lambda k: (ranks[0]["params"][k].float()
                                        - params1[k].float()).abs().max())
    p_err = (ranks[0]["params"][worst].float()
             - params1[worst].float()).abs().max().item()
    phase(f"  mesh (g) {GLOO_WORLD} gloo processes on the one card, "
          f"{outcome['seconds']:.2f} s beside (c)-(f): the searches' ids "
          f"equal (a)'s on every rank up to ties within {GLOO_SCORE_TOL} "
          f"(rows reordered by them {tied}; scores max |diff| "
          f"{score_err:.3e}), launches as (a)'s; {GLOO_STEPS} warmup "
          f"steps of {TRAIN_BATCH} x {TRAIN_LEN} without dropout, the "
          f"ranks' parameters bit-equal, "
          f"losses {', '.join(f'{x:.6f}' for x in ranks[0]['losses'])} "
          f"against a world of one's "
          f"{', '.join(f'{x:.6f}' for x in losses1)} (rel {loss_err:.2e}, "
          f"bound {CMP_LOSS_RTOL}); the first step's averaged, clipped "
          f"gradients: cosine {glob:.6f} (bound {CMP_GLOBAL_COSINE}), "
          f"worst tensor {gworst} {gcos:.6f} (bound {CMP_TENSOR_COSINE}); "
          f"parameters after step {GLOO_STEPS} max |diff| {p_err:.3e} in "
          f"{worst}; launches {counts1} a rank [{card}]")
    if not (steps_agree(rel, glob, gcos) and loss_err <= CMP_LOSS_RTOL):
        raise AssertionError("mesh (g): the world of two strays from the "
                             "world of one")
    return counts1


# (h): tensor parallelism over a world of TP_M gloo processes on the one
# card (data 1 x model TP_M; NCCL takes one rank a card). The split steps
# are held to a world of one's unsplit steps by the averaged and clipped
# gradients' global cosine and the worst tensor's (key biases left out,
# step_agreement) at (g)'s measured agreement of two bf16 orders of one
# step, and by (g)'s loss bound, CMP_LOSS_RTOL: with random weights the
# triplet scores are ~745 +- a few, and a bf16 ulp of each of the 768
# embedding elements moves a score by ~0.05-0.1, so a split forward's loss
# lands 4e-3-3e-2 from the unsplit one's (H100 80GB HBM3, 700 W) while
# its gradients agree to a cosine of 0.999
TP_BATCH = 16  # triplets of each split warmup step (TRAIN_LEN tokens)
TP_ENC_BATCH = 64  # records of the split encode forwards
TP_LARGE_LAYERS = 4  # bert-large's depth in its split forward (widths whole)
TP_LOSS_RTOL = CMP_LOSS_RTOL
TP_GLOBAL_COSINE = 0.998
TP_TENSOR_COSINE = 0.98
TP_ENC_COSINE = 0.999  # every row of a split forward against the unsplit
# (h)'s steps: (tag, dropout, attention_impl, the split launches a rank,
# the world of one's), at bert-base's 12 layers x 3 towers
TP_STEPS = (
    ("dropout", True, "einsum", {"K5_split_partial": 36,
                                 "K5_split_finish": 36}, {"K5_ffn": 36}),
    ("no dropout", False, "fused", {"K1_split_partial": 36,
                                    "K1_split_finish": 36,
                                    "K8_attention": 36},
     {"K1_ffn_block": 36, "K8_attention": 36}))


def tp_arrays(seed):
    """TP_ENC_BATCH triplets of hashed words (HashTokenizer, TRAIN_LEN
    tokens), each sequence's first token drawn at random (as
    random_first_token: a shared [CLS] makes the gradient a difference of
    near-equal terms) -> the arrays; a step takes the first TP_BATCH."""
    from cocodr_tpu_torch.pipelines.warmup import TripleTextBatcher

    rng = np.random.default_rng([seed, 20])

    def text(lo, hi):
        return " ".join(f"w{x}" for x in rng.integers(0, 50000,
                                                       rng.integers(lo, hi)))

    triples = [(text(4, 16), text(30, 120), text(30, 120))
               for _ in range(TP_ENC_BATCH)]
    arrays = TripleTextBatcher(HashTokenizer(), TRAIN_LEN).collate(triples)
    return random_first_token(argparse.Namespace(seed=seed), arrays)


def tp_bert(attention_impl, large=False):
    from cocodr_tpu_torch.models.bert import BertConfig

    if large:
        return BertConfig.large(dtype=torch.bfloat16,
                                attention_impl=attention_impl,
                                num_hidden_layers=TP_LARGE_LAYERS)
    return BertConfig.base(dtype=torch.bfloat16,
                           attention_impl=attention_impl)


def tp_step(seed, arrays, bert, dropout, dev, path, mesh=None):
    """One warmup (nll) step at TP_BATCH from the seed's weights, dropout
    0.1 from step 0's generators or off, split over the mesh's model axis
    (shard_train_init) or on one device -> (loss, {name: the averaged and
    clipped gradient, whole, float32 on the host}, the launches, the
    state)."""
    from cocodr_tpu_torch.core.configs import OptimizerConfig
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.parallel.sharded_train import shard_train_init
    from cocodr_tpu_torch.parallel.tp import gather_tensor
    from cocodr_tpu_torch.pipelines.train_step import (
        build_train_step,
        dropout_generators,
    )
    from cocodr_tpu_torch.utils.train_state import TrainState

    model = build_dual_encoder(
        "rdot_nll_condenser", bert, device=dev,
        generator=torch.Generator().manual_seed(seed))
    opt = OptimizerConfig(lr=2e-4, warmup_steps=5, total_steps=100
                          ).build(model.parameters())
    batch = {k: v[:TP_BATCH] for k, v in arrays.items()}
    if mesh is None:
        state = TrainState(model, opt)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    else:
        state, put = shard_train_init(mesh, model, opt)
        batch = put(batch)
    gens = dropout_generators(seed, 0, dev) if dropout else None
    zero_counts()
    loss, _ = build_train_step()(state, batch, gens)
    synchronize(dev)
    counts = read_counts(path, [])
    grads = {k: gather_tensor(p, p.grad).float().cpu()
             for k, p in model.named_parameters()}
    return loss.item(), grads, counts, state


def tp_forward(seed, arrays, bert, dev, path, mesh=None):
    """The body tower's embeddings of the arrays' TP_ENC_BATCH positives
    in inference, from the seed's weights, split over the mesh's model
    axis (shard_params_tp) or whole -> (embeddings on the host, launches).
    """
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.parallel.tp import shard_params_tp

    model = build_dual_encoder(
        "rdot_nll_condenser", bert, device=dev,
        generator=torch.Generator().manual_seed(seed + 20)).eval()
    if mesh is not None:
        shard_params_tp(model, mesh)
    ids, mask = (torch.from_numpy(arrays[k]).to(dev)
                 for k in ("pos_ids", "pos_mask"))
    zero_counts()
    with torch.inference_mode():
        emb = model.body_emb(ids, mask).float().cpu()
    synchronize(dev)
    return emb, read_counts(path, [])


def tp_rank(seed, arrays, work, dev_type):
    """(h), one rank of TP_M joined over gloo on the one card (core/mesh.py
    ::spawn), mesh 1 x TP_M: the two TP_STEPS (a checkpoint saved after
    the second, its payload gathered whole), then the split encode
    forwards of bert-base and of bert-large's widths -> {tag: (loss,
    gradients on rank 0)}, the launches and seconds of each leg, and on
    rank 0 the checkpoint's path with the gathered parameters and LAMB
    moments, and every rank's embeddings."""
    import torch.distributed as dist

    from cocodr_tpu_torch.core.mesh import MeshConfig, create_mesh
    from cocodr_tpu_torch.parallel.tp import (
        gather_optimizer_state,
        gather_params_tp,
    )
    from cocodr_tpu_torch.utils.train_state import save_checkpoint

    dev = torch.device(dev_type, 0) if dev_type == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = create_mesh(MeshConfig(1, TP_M), dev)
    rank = dist.get_rank()
    out = {"counts": {}, "seconds": {}}
    for tag, dropout, impl, _, _ in TP_STEPS:
        t = time.perf_counter()
        loss, grads, out["counts"][tag], state = tp_step(
            seed, arrays, tp_bert(impl), dropout, dev,
            f"mesh (h) rank {rank} {tag} step", mesh)
        out[tag] = (loss, grads if rank == 0 else None)
        if not dropout:
            path = save_checkpoint(os.path.join(work, "ckpt"), state)
            params = {k: v.cpu() for k, v in
                      gather_params_tp(state.model).items()}
            names = [n for n, _ in state.model.named_parameters()]
            osd = gather_optimizer_state(state.optimizer,
                                         state.optimizer.state_dict())
            moments = {names[i]: {k: v.cpu() for k, v in st.items()}
                       for i, st in osd["state"].items()}
            if rank == 0:
                out["ckpt"] = (path, params, moments)
        del state, grads
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["seconds"][tag] = time.perf_counter() - t
    for tag, large in (("encode base", False), ("encode large", True)):
        t = time.perf_counter()
        out[tag], out["counts"][tag] = tp_forward(
            seed, arrays, tp_bert("fused", large), dev,
            f"mesh (h) rank {rank} {tag}", mesh)
        out["seconds"][tag] = time.perf_counter() - t
    return out


def mesh_tp_start(args, root, dev_type):
    """(h), started: the world of TP_M gloo processes on a thread, so that
    it runs beside (c)-(g) -> (thread, its outcome dict)."""
    import threading

    from cocodr_tpu_torch.core.mesh import spawn

    work = os.path.join(root, "tp")
    outcome = {"arrays": tp_arrays(args.seed)}

    def run():
        t = time.perf_counter()
        try:
            outcome["ranks"] = spawn(tp_rank, TP_M,
                                     os.path.join(work, "store"), args.seed,
                                     outcome["arrays"], work, dev_type,
                                     timeout=600)
        except BaseException as e:  # raised again by mesh_tp_finish
            outcome["error"] = e
        outcome["seconds"] = time.perf_counter() - t

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, outcome


def mesh_tp_finish(args, dev, started, card):
    """(h), read: each rank's split launches; each TP step against a world
    of one's unsplit step from the same weights, batch and masks (this
    process, while the world runs) by TP_LOSS_RTOL, TP_GLOBAL_COSINE and
    TP_TENSOR_COSINE; the TP checkpoint loaded at a world of one (a plain
    state) bit-equal to the parameters and LAMB moments the TP state
    gathered; each split forward's rows against the unsplit forward's by
    TP_ENC_COSINE, the ranks' embeddings bit-equal -> the split launches
    a rank, by leg."""
    from cocodr_tpu_torch.core.configs import OptimizerConfig
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.utils.train_state import TrainState, load_checkpoint

    thread, outcome = started
    arrays, on_card = outcome["arrays"], dev.type == "cuda"
    ones = {}
    for tag, dropout, impl, _, expect_one in TP_STEPS:
        loss, grads, counts, state = tp_step(
            args.seed, arrays, tp_bert(impl), dropout, dev,
            f"mesh (h) world of one {tag} step")
        if on_card:
            check_counts(f"mesh (h) world of one {tag}", counts, expect_one)
        ones[tag] = (loss, grads)
        del state
    enc_one = {tag: tp_forward(args.seed, arrays, tp_bert("fused", large),
                               dev, f"mesh (h) world of one {tag}")[0]
               for tag, large in (("encode base", False),
                                  ("encode large", True))}
    thread.join(660)
    if thread.is_alive():
        raise AssertionError("mesh (h): the gloo world has not ended")
    if "error" in outcome:
        raise AssertionError("mesh (h): the gloo world failed") \
            from outcome["error"]
    ranks = outcome["ranks"]
    layers, large_layers = 12, TP_LARGE_LAYERS
    expect = {tag: e for tag, _, _, e, _ in TP_STEPS}
    for tag, n in (("encode base", layers), ("encode large", large_layers)):
        expect[tag] = {"K1_split_partial": n, "K1_split_finish": n,
                       "K8_attention": n}
    for r, res in enumerate(ranks):
        for tag, want in expect.items():
            if on_card:
                check_counts(f"mesh (h) rank {r} {tag}", res["counts"][tag],
                             want)
    lines, ok = [], True
    for tag, _, _, _, _ in TP_STEPS:
        (loss_tp, grads_tp), (loss1, grads1) = ranks[0][tag], ones[tag]
        rel, glob, worst, cos = step_agreement(loss_tp, grads_tp, loss1,
                                               grads1)
        ok &= (rel <= TP_LOSS_RTOL and glob >= TP_GLOBAL_COSINE
               and cos >= TP_TENSOR_COSINE)
        lines.append(f"{tag}: loss {loss_tp:.6f} against {loss1:.6f} (rel "
                     f"{rel:.2e}, bound {TP_LOSS_RTOL}), gradients cosine "
                     f"{glob:.6f} (bound {TP_GLOBAL_COSINE}), worst tensor "
                     f"{worst} {cos:.6f} (bound {TP_TENSOR_COSINE}), "
                     f"{ranks[0]['seconds'][tag]:.2f} s a rank")
    path, params, moments = ranks[0]["ckpt"]
    model = build_dual_encoder("rdot_nll_condenser", tp_bert("fused"),
                               device=dev)
    state = load_checkpoint(path, TrainState(model, OptimizerConfig(
        lr=2e-4, warmup_steps=5, total_steps=100).build(model.parameters())))
    same_state_dicts("mesh (h) checkpoint's parameters",
                     {k: v.cpu() for k, v in model.state_dict().items()},
                     params)
    opt_sd = state.optimizer.state_dict()["state"]
    names = [n for n, _ in model.named_parameters()]
    for i, st in opt_sd.items():
        same_state_dicts(f"mesh (h) checkpoint's moments of {names[i]}",
                         {k: v.cpu() for k, v in st.items()},
                         moments[names[i]])
    if len(opt_sd) != len(moments):
        raise AssertionError("mesh (h): the checkpoint's moments are not "
                             "the TP state's")
    for tag, one in enc_one.items():
        embs = [res[tag] for res in ranks]
        if any(not torch.equal(e, embs[0]) for e in embs[1:]):
            raise AssertionError(f"mesh (h) {tag}: the ranks' embeddings "
                                 "differ")
        cos = torch.nn.functional.cosine_similarity(
            embs[0].double(), one.double(), dim=1)
        err = (embs[0] - one).abs().max().item()
        ok &= cos.min().item() >= TP_ENC_COSINE
        lines.append(f"{tag}: rows' cosine min {cos.min().item():.6f} "
                     f"(bound {TP_ENC_COSINE}), max |diff| {err:.3e}, "
                     f"{ranks[0]['seconds'][tag]:.2f} s a rank")
    phase(f"  mesh (h) tensor parallelism, {TP_M} gloo processes on the "
          f"one card (mesh 1 x {TP_M}), {outcome['seconds']:.2f} s beside "
          f"(c)-(g); against a world of one's unsplit steps and forwards: "
          + "; ".join(lines) + f"; the checkpoint written by the split "
          f"state loads at a world of one bit-equal to the parameters and "
          f"moments it gathered; launches a rank by leg "
          f"{ {t: {k: v for k, v in c.items() if v} for t, c in ranks[0]['counts'].items()} } [{card}]")
    if not ok:
        raise AssertionError("mesh (h): the split run strays from the world "
                             "of one")
    total = {}
    for tag in ("dropout", "no dropout", "encode base"):
        for k, v in ranks[0]["counts"][tag].items():
            total[k] = total.get(k, 0) + v
    return {"tp": total, "tp_large": ranks[0]["counts"]["encode large"]}


def mesh(args, dev):
    """Phase 18: the data-parallel paths on a world of one nccl process
    (core/mesh.py::create_mesh makes it; the card's machine has one card),
    each forced through its sharded code even at W = 1 and held against
    the plain path: (a) the sharded search, (b) the sharded service, (c)
    warmup through shard_train_init, (d) the COCO steps with the span
    contrastive over the world, (e) mine(mesh=), (f) eval-beir --mesh auto
    in a subprocess; on the card also (g), a world of two gloo processes
    beside (c)-(f); and (h), tensor parallelism over a world of TP_M gloo
    processes beside (c)-(g). Each data-parallel path's launch counts
    equal the plain path's; (h)'s are the split kernels'."""
    import torch.distributed as dist

    from cocodr_tpu_torch.core.mesh import MeshConfig, create_mesh

    card = nvidia_smi()
    mesh_ = create_mesh(MeshConfig(), dev)
    backend = dist.get_backend()
    if dev.type == "cuda" and backend != "nccl":
        raise AssertionError(f"mesh: backend {backend} on the card")
    phase(f"  mesh: a world of {dist.get_world_size()} ({backend}), mesh "
          f"{tuple(mesh_.shape)} {mesh_.mesh_dim_names}")
    counts = {}
    try:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        corpus = make_corpus(gen, dev)
        counts["search"], searched = mesh_search(args, dev, mesh_, corpus,
                                                 card)
        counts["serve"] = mesh_serve(args, dev, mesh_, corpus, card)
        del corpus
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as root, \
                contextlib.ExitStack() as stack:
            # (f) and (g) run beside (c)-(e)
            job = mesh_cli_start(args, dev, root)
            stack.callback(job["run"].kill_all)
            gloo = (mesh_gloo_start(args, root) if dev.type == "cuda"
                    else None)
            tp = mesh_tp_start(args, root, dev.type)
            counts["warmup"] = mesh_warmup(args, dev, mesh_, root, card)
            torch.cuda.empty_cache()
            counts["coco"] = mesh_coco(args, dev, mesh_, card)
            torch.cuda.empty_cache()
            counts["mine"] = mesh_mine(args, dev, mesh_, root, card)
            torch.cuda.empty_cache()
            counts["cli"] = mesh_cli_finish(dev, root, job, card)
            if gloo is not None:
                counts["gloo"] = mesh_gloo_finish(
                    args, dev, root, gloo, searched, counts["search"], card)
            counts.update(mesh_tp_finish(args, dev, tp, card))
    finally:
        dist.destroy_process_group()
    return counts


# Phase 19 (moe): E1 at DeepSeek-V2-Lite's widths, the rows routed by
# ops/moe.py::route from random gate weights
MOE_E, MOE_H, MOE_F, MOE_K = 64, 2048, 1408, 6
# (tokens, share of pads): a few rows an expert (empty experts, partial
# tiles), the moe_encode cell's batch of 128 records of 288 tokens on
# average (221,184 rows) without pads and with a fifth of them pads (routed
# past offsets[E]), and 128 x 512 (393,216 rows)
MOE_SHAPES = ((16, 0.25), (1000, 0.3), (36_864, 0.0), (36_864, 0.2),
              (65_536, 0.0))
MOE_TIMED = 36_864  # shapes of this many tokens and more are timed
# Each routed row's largest |E1 - plain| over its largest |plain|. Both
# round h to bf16 after float32 sums taken in another order, so an h
# element may land one bf16 ulp (<= 2^-7 |h|) away, and the float32 sum
# over F of such elements moves a row by a small share of that. The limit
# is two bf16 ulps of the row's largest output; a row given to the
# neighbouring expert (a block's expert boundary off by one) and an
# expert missing one 128-column tile of F read far above it (planted
# below, at the padded cell shape).
MOE_ROW_TOL = 2.0 ** -6
# the tower's attention at the cell's widest bucket and its narrowest
MOE_ATTN_SHAPES = ((128, 512), (128, 128))


def moe_row_err(got, ref, r):
    """The worst routed row of a real token: max |got - ref| over the
    row's largest |ref| (rows of pads are left out: E1 writes none)."""
    keep = r.order[:int(r.offsets[-1])]
    g, f = got[keep], ref[keep]
    return ((g - f).abs().amax(1) / f.abs().amax(1)).max().item()


def moe_planted(moe_ops, got, r, w_gate, w_up, w_down):
    """The faults a wrong tile or block boundary makes, each computed by
    the plain version on altered inputs; E1's output must fail each."""
    mid = w_gate.shape[0] // 2
    shifted = r.offsets.clone()
    shifted[mid] += 1  # expert mid's first row given to expert mid - 1
    no_tile = w_gate.clone()
    no_tile[mid, 128:256] = 0  # silu(0) = 0: one F tile of expert mid lost
    for name, wg, offs in (("neighbour expert", w_gate, shifted),
                           ("missing F tile", no_tile, r.offsets)):
        bad = moe_ops.expert_ffn_reference(r.rows, wg, w_up, w_down, offs,
                                           r.weights, r.order)
        err = moe_row_err(got, bad, r)
        phase(f"  E1 planted {name}: worst row {err:.3e} (must exceed "
              f"{MOE_ROW_TOL:.3e})")
        if not err > MOE_ROW_TOL:
            raise AssertionError(f"E1's check misses a planted {name}")


def moe_library(r, w_gate, w_up, w_down):
    """The same function by library calls -> {name: fn}: torch._grouped_mm
    (where this torch has it) for gate, up and down with SiLU·mul between,
    and one cuBLAS product an expert (offsets read once, here)."""
    import torch.nn.functional as F

    fns = {}
    offs = r.offsets[1:].contiguous()
    if hasattr(torch, "_grouped_mm"):
        def grouped():
            a = torch._grouped_mm(r.rows, w_gate.transpose(1, 2), offs=offs)
            b = torch._grouped_mm(r.rows, w_up.transpose(1, 2), offs=offs)
            h = (F.silu(a.float()) * b.float()).to(r.rows.dtype)
            return torch._grouped_mm(h, w_down.transpose(1, 2), offs=offs)
        fns["_grouped_mm"] = grouped
    bounds = r.offsets.tolist()

    def per_expert():
        for e in range(MOE_E):
            x = r.rows[bounds[e]:bounds[e + 1]]
            (F.silu(x @ w_gate[e].T) * (x @ w_up[e].T)) @ w_down[e].T
    fns["cuBLAS an expert"] = per_expert
    return fns


def moe_attention(gen, dev):
    """The tower's attention (models/deepseek_v2.py): SDPA, causal, q/k
    head dim 192, v 128 as they are, in turns with v padded to 192 (which
    SDPA's flash kernel takes); the outputs agree within two bf16 ulps of
    the largest."""
    import torch.nn.functional as F

    scale = 0.114721
    for B, S in MOE_ATTN_SHAPES:
        q, k = (torch.randn(B, 16, S, 192, generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        v = torch.randn(B, 16, S, 128, generator=gen, device=dev).to(
            torch.bfloat16)

        def unpadded():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  scale=scale)

        def padded():
            return F.scaled_dot_product_attention(
                q, k, F.pad(v, (0, 64)), is_causal=True,
                scale=scale)[..., :128]
        a, b = unpadded().float(), padded().float()
        err, tol = (a - b).abs().max().item(), 2.0 ** -6 * b.abs().max().item()
        ms, pad_ms = time_turns(unpadded, padded, 10)
        phase(f"  attention B={B} S={S} N=16 q/k 192 v 128 causal: SDPA "
              f"{ms:.4f} ms, v padded to 192 {pad_ms:.4f} ms (in turns); "
              f"max |diff| {err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError("SDPA with v at 128 disagrees with v "
                                 f"padded: {err}")


def moe(args, dev):
    """Phase 19: E1 (csrc/moe_experts.cu via ops/moe.py::expert_ffn) at
    DeepSeek-V2-Lite's widths (64 experts of 1,408 over hidden 2,048, top
    6), the rows routed by moe.route, at every MOE_SHAPES case against the
    plain version on the same inputs (MOE_ROW_TOL), its two launches a call
    counted; planted faults at the padded cell shape; from MOE_TIMED tokens
    up, its ms beside the bound of portbench/work_moe.py::expert_work, the
    plain loop, torch._grouped_mm and one cuBLAS product an expert. Then
    the tower's attention through SDPA (moe_attention) -> E1's summary
    entry at the cell's unpadded shape and the launch counts."""
    from cocodr_tpu_torch.ops import moe as moe_ops
    from portbench.work_moe import expert_work

    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def draw(*shape):
        return (torch.randn(*shape, generator=gen, device=dev)
                * 0.02).to(torch.bfloat16)
    E, H, F_, k = MOE_E, MOE_H, MOE_F, MOE_K
    w_gate, w_up, w_down, router = (draw(E, F_, H), draw(E, F_, H),
                                    draw(E, H, F_), draw(E, H))
    entry, counts = None, {}
    for T, pad in MOE_SHAPES:
        x = torch.randn(T, H, generator=gen, device=dev).to(torch.bfloat16)
        real = torch.rand(T, generator=gen, device=dev) >= pad
        r = moe_ops.route(x, router, k, real)
        a = (r.rows, w_gate, w_up, w_down, r.offsets, r.weights, r.order)
        zero_counts()
        got = moe_ops.expert_ffn(*a)
        counts = read_counts(f"E1 T={T}", ["E1_moe_experts"])
        check_counts(f"E1 T={T}", counts, {"E1_moe_experts": 2})
        ref = moe_ops.expert_ffn_reference(*a)
        n_real = int(r.offsets[-1])
        empty = int((r.offsets.diff() == 0).sum())
        err = moe_row_err(got, ref, r)
        phase(f"  E1 T={T} ({n_real} routed rows, {T * k - n_real} of pads,"
              f" {empty} experts without a row): worst row {err:.3e} (tol "
              f"{MOE_ROW_TOL:.3e})")
        if not err <= MOE_ROW_TOL:
            raise AssertionError(f"E1 disagrees with its plain version at "
                                 f"T={T}: worst row {err}")
        if T == MOE_TIMED and pad:
            moe_planted(moe_ops, got, r, w_gate, w_up, w_down)
        del got, ref
        if T < MOE_TIMED:
            continue
        ms = device_ms(lambda: moe_ops.expert_ffn(*a), 10)
        plain = time_ms(lambda: moe_ops.expert_ffn_reference(*a), runs=3,
                        warmup=1)
        ops, nbytes = expert_work(n_real, E, H, F_)
        b_ms, b_by = bound(nbytes, ops, BF16_FLOP_PER_S)
        lib = {name: device_ms(fn, 10 if name == "_grouped_mm" else 3)
               for name, fn in moe_library(r, w_gate, w_up,
                                           w_down).items()}
        phase(f"  E1 T={T} ({n_real} rows): kernel {ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of it; plain "
              f"{plain:.4f} ms; "
              + ", ".join(f"{n} {v:.4f} ms" for n, v in lib.items()))
        if entry is None:  # the summary's shape: the cell's batch, no pads
            entry = dict(name="E1_moe_experts", route="cuda",
                         source="cocodr_tpu_torch/csrc/moe_experts.cu",
                         replaces=None, ms=ms, plain_ms=plain, bound_ms=b_ms,
                         bound_by=b_by,
                         library_ms=lib.get("_grouped_mm",
                                            lib["cuBLAS an expert"]))
        del r, a
        torch.cuda.empty_cache()
    moe_attention(gen, dev)
    return entry, counts


PHASES = ["kernels", "search", "serve", "encode", "train", "eval",
          "ance-train", "ance-mine", "coco", "variants", "recipe", "http",
          "ivf", "cli", "cli-recipe", "mesh", "moe"]


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

    clock = PhaseClock()
    clock.start("build", "build: nvcc -> " + str(_build.BUILD_ROOT))
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
        clock.start("kernels", "kernel checks")
        k5 = check_k5(ffn, gen, dev)
        kernels = [check_k1(ffn, gen, dev), k5]
        corpus = make_corpus(gen, dev)
        kernels.append(check_k2(mips_hier, corpus, gen, dev))
        kernels.append(check_k3(mips_hier, gen, dev))
        kernels.append(check_k4(ffn, gen, dev))
        kernels.append(check_k7(ffn, gen, dev))
        check_map_cache(ffn, gen, dev)
        kernels.append(check_k8(attention, gen, dev))
        kernels += check_splits(ffn, gen, dev)
        corpus_i8, dim_scale = mips_int8.quantize_corpus_int8(corpus)
        sweeps = check_sweeps(gen, dev, corpus, corpus_i8, dim_scale)
        check_sweep_shapes(gen, dev, corpus, corpus_i8)
    if "search" in run:
        clock.start("search")
        search_counts = search(gen, dev, corpus, corpus_i8, dim_scale)
    if "kernels" in run:
        del corpus_i8
    if "serve" in run:
        clock.start("serve")
        serve_counts = serve(args, dev, corpus)
    if "kernels" in run:
        del corpus
    torch.cuda.empty_cache()
    for name, fn in (("encode", encode), ("train", train),
                     ("eval", evaluate), ("ance-train", ance_train),
                     ("ance-mine", ance_mine), ("coco", coco),
                     ("variants", variants), ("recipe", recipe),
                     ("http", http), ("ivf", ivf), ("cli", cli),
                     ("cli-recipe", cli_recipe), ("mesh", mesh),
                     ("moe", moe)):
        if name not in run:
            continue
        clock.start(name)
        if name == "train":
            out = fn(args, dev, k5["ms"])
        elif name == "http":
            out = fn(args, dev, make_corpus(gen, dev))
        else:
            out = fn(args, dev)
        if name == "encode":
            encode_counts = out
        elif name == "train":
            train_counts = out
        elif name == "mesh":
            mesh_counts = out
        elif name == "moe":
            moe_entry, moe_counts = out
        torch.cuda.empty_cache()
    phase(f"phase seconds (host clock): {clock.summary()} [{smi}]")
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
             "K10_block32_sweep": (search_counts, "K10_block32_sweep"),
             "K1_ffn_block_split": (mesh_counts["tp"], "K1_split_partial"),
             "K4_ffn_block_chunked_split": (mesh_counts["tp_large"],
                                            "K1_split_partial"),
             "K5_ffn_split": (mesh_counts["tp"], "K5_split_partial"),
             "E1_moe_experts": (moe_counts, "E1_moe_experts")}
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
    kernels.append(moe_entry)
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
