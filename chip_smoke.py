#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cocodr_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases, each printed with its elapsed seconds:
  1. environment: torch and CUDA versions, the card's name and power limit;
     fails when CUDA is not available;
  2. build: nvcc compiles cocodr_tpu_torch/csrc/*.cu for sm_90a;
  3. kernel checks: each kernel (K1 fused FFN half-layer, K2 dual block-max
     sweep, K3 extract-max top-k) against its plain PyTorch version on the
     card, at the shapes of the serving path, with its time, the plain
     version's time, the time of one library call that computes the same
     function where there is one, and the least time the card could take;
  4. serve: BERT-base (rdot_nll_condenser, random weights from the seed)
     behind RetrievalService over 1,048,576 bf16 768-d docs on the card:
     three batches of 64 queries through search_stream and one single
     query through search, with every kernel's launch count read around
     that run; ids and scores checked against an exact plain search.
Then one JSON line of per-kernel numbers, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}. Any failure raises and
the process exits non-zero; a hang ends at the watchdog with a traceback.
"""
from __future__ import annotations

import faulthandler

faulthandler.dump_traceback_later(600, exit=True)

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
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
FP32_OP_PER_S = 67e12

N_DOCS = 1_048_576
DIM = 768
BATCH = 64
QUERY_LEN = 64
TOP_K = 10


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
    """Median device time of fn() over `runs` calls, CUDA events."""
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


def check_k1(ffn, gen, dev):
    """K1 at T = 64 * 64 tokens, bert-base widths, bf16; plus a ragged T."""
    H, F = 768, 3072

    def inputs(T):
        def rnd(*shape, std=1.0, mean=0.0):
            return torch.randn(*shape, generator=gen, device=dev) * std + mean
        bf = torch.bfloat16
        return (rnd(T, H).to(bf), rnd(H, std=0.1, mean=1.0),
                rnd(H, std=0.1), rnd(F, H, std=0.02).to(bf),
                rnd(F, std=0.02).to(bf), rnd(H, F, std=0.02).to(bf),
                rnd(H, std=0.02).to(bf), rnd(H, std=0.1, mean=1.0),
                rnd(H, std=0.1))

    errs = []
    for T in (4096, 1000):
        args = inputs(T)
        got = ffn.fused_ffn_block(*args).float()
        ref = ffn.ffn_block_reference(*args).float()
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        # two bf16 ulps of the largest output (bf16 spacing <= 2^-7 |x|):
        # h and out round to bf16 after float32 sums taken in another order
        tol = 2.0 ** -6 * ref.abs().max().item()
        phase(f"  K1 T={T} H={H} F={F}: max_abs_err={err:.3e} tol={tol:.3e}")
        if not err <= tol or not torch.isfinite(got).all():
            raise AssertionError(f"K1 disagrees with its plain version: {err}")
        errs.append(err)
    T = 4096
    args = inputs(T)
    ms = time_ms(lambda: ffn.fused_ffn_block(*args))
    plain = time_ms(lambda: ffn.ffn_block_reference(*args))
    nbytes = (2 * T * H * 2 + 2 * H * F * 2 + (F + H) * 2 + 4 * H * 4)
    b_ms, b_by = bound(nbytes, 4 * T * H * F, BF16_FLOP_PER_S)
    phase(f"  K1 T={T}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})")
    return dict(name="K1_ffn_block", route="cuda",
                source="cocodr_tpu_torch/csrc/ffn_block.cu",
                replaces="cocodr_tpu/ops/pallas_ffn.py:130",
                max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


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
    ms = time_ms(lambda: mips.dual_sweep(q, corpus))
    plain = time_ms(lambda: mips.dual_sweep_reference(q, corpus))
    nbytes = N_DOCS * DIM * 2 + Q * DIM * 2 + Q * (N_DOCS // 8
                                                   + N_DOCS // 64) * 4
    b_ms, b_by = bound(nbytes, 2 * Q * N_DOCS * DIM, BF16_FLOP_PER_S)
    phase(f"  K2: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})")
    return dict(name="K2_dual_sweep", route="cuda",
                source="cocodr_tpu_torch/csrc/mips_sweep.cu",
                replaces="cocodr_tpu/ops/pallas_mips.py:100",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def check_k3(mips, gen, dev):
    """K3 at the serving path's three [Q, W] shapes (super, fine, rescore
    at k = 10), an int32 tie case, a -inf case, and a row too wide for
    shared memory. The kernel must equal its plain version exactly."""
    Q, k = BATCH, TOP_K
    cases = []
    for W in (N_DOCS // 512, 64 * TOP_K, 8 * TOP_K):
        cases.append((f"f32 [{Q},{W}]", torch.randn(Q, W, generator=gen,
                                                    device=dev)))
    cases.append(("i32 ties", torch.randint(0, 8, (Q, 2048), generator=gen,
                                            device=dev, dtype=torch.int32)))
    x = torch.randn(Q, 640, generator=gen, device=dev)
    x[:, 5:] = float("-inf")
    x[1, :] = float("-inf")
    cases.append(("-inf rows", x))
    cases.append(("wide f32 [4,100000]",
                  torch.randn(4, 100_000, generator=gen, device=dev)))
    err = 0.0
    for name, x in cases:
        v, i = mips.topk(x, k)
        rv, ri = mips.topk_reference(x, k)
        torch.cuda.synchronize()
        if not (torch.equal(v, rv) and torch.equal(i, ri)):
            raise AssertionError(f"K3 {name}: kernel != plain version")
        # equal values give 0, and -inf - -inf gives NaN, counted as 0
        diff = (v.double() - rv.double()).nan_to_num(0.0).abs().max().item()
        err = max(err, diff)
        phase(f"  K3 {name} k={k}: values and ids equal to the plain "
              f"version (tol 0)")
    out = None
    for W in (N_DOCS // 512, 64 * TOP_K, 8 * TOP_K):
        x = torch.randn(Q, W, generator=gen, device=dev)
        ms = time_ms(lambda: mips.topk(x, k))
        plain = time_ms(lambda: mips.topk_reference(x, k))
        lib = time_ms(lambda: torch.topk(x, k, dim=1))
        Wp = -(-W // 128) * 128
        b_ms, b_by = bound(Q * W * 4 + Q * k * 8, k * Q * Wp, FP32_OP_PER_S)
        phase(f"  K3 [{Q},{W}] k={k}: kernel {ms:.4f} ms, plain {plain:.4f}"
              f" ms, torch.topk {lib:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        if out is None:  # the widest shape stands for K3 in the summary
            out = dict(name="K3_topk", route="cuda",
                       source="cocodr_tpu_torch/csrc/topk.cu",
                       replaces="cocodr_tpu/ops/pallas_mips.py:214",
                       max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib)
    return out


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


def serve(args, gen, dev, corpus, kernels):
    from cocodr_tpu_torch.models.bert import BertConfig
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.ops import ffn, mips_hier
    from cocodr_tpu_torch.pipelines.serve import (
        SEARCH_TILE,
        RetrievalService,
        ServeConfig,
    )

    cfg = BertConfig.base(dtype=torch.bfloat16)
    model = build_dual_encoder("rdot_nll_condenser", cfg, device=dev,
                               generator=torch.Generator().manual_seed(
                                   args.seed))
    svc = RetrievalService(
        model, HashTokenizer(), corpus,
        cfg=ServeConfig(top_k=TOP_K, max_query_len=QUERY_LEN,
                        max_batch=BATCH),
        device=dev,
    )
    phase(f"  service up: BERT-base bf16, {svc.n_docs} docs resident")
    rng = np.random.default_rng(args.seed)
    batches = [make_queries(rng, BATCH) for _ in range(3)]
    single = make_queries(rng, 1)
    svc.search(make_queries(rng, BATCH))  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    counters = {"K1_ffn_block": ffn.fused_ffn_block,
                "K2_dual_sweep": mips_hier.dual_sweep,
                "K3_topk": mips_hier.topk}
    for fn in counters.values():
        fn.launches = 0
    t = time.perf_counter()
    results = list(svc.search_stream(batches))
    stream_s = time.perf_counter() - t
    one = svc.search(single)
    launches = {name: fn.launches for name, fn in counters.items()}
    phase(f"  main path launches: {launches}")
    calls = len(batches) + 1
    expect = {"K1_ffn_block": cfg.num_hidden_layers * calls,
              "K2_dual_sweep": calls, "K3_topk": 3 * calls}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")

    errs = []
    with torch.inference_mode():
        for texts, (vals, ids) in zip(batches + [single],
                                      results + [one]):
            # the service's own bucket padding, so that the encoder runs
            # the same shapes and gives the same embeddings
            pad = svc._bucket(len(texts)) - len(texts)
            tok_ids, tok_mask = svc._tokenize(texts + [""] * pad)
            emb = model.query_emb(torch.from_numpy(tok_ids).to(dev),
                                  torch.from_numpy(tok_mask).to(dev))
            scores, ref_v, _ = exact_search(emb[:len(texts)], corpus, TOP_K)
            tol = 1e-4 * max(1.0, scores.abs().max().item())
            errs.append(check_results(vals, ids, scores, ref_v, tol))
    phase(f"  results equal the exact plain search: max score err "
          f"{max(errs):.3e} (tol 1e-4 x max |score|)")

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
    card = f"{torch.cuda.get_device_name(0)}, {nvidia_smi()}"
    phase(f"  search_stream: {per_batch * 1e3:.3f} ms/batch of {BATCH}, "
          f"{BATCH / per_batch:.1f} queries/s over {n_timed} batches "
          f"(first 3-batch run {stream_s * 1e3:.1f} ms); single query "
          f"{single_ms:.3f} ms [{card}]")

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
        search_ms = time_ms(lambda: mips_hier.mips_topk_hierarchical(
            emb, svc.corpus, TOP_K, tile=SEARCH_TILE, n_real=svc.n_docs))
        # host time to enqueue the encoder alone: when it is near the
        # encoder's card span, the card waits on the host's launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n_timed):
            model.query_emb(ids_t, mask_t)
        enq_ms = (time.perf_counter() - t) * 1e3 / n_timed
        torch.cuda.synchronize()
    phase(f"  per batch of {BATCH}: tokenize {tok_ms:.3f} ms (host), encode "
          f"{enc_ms:.3f} ms, search {search_ms:.3f} ms (card spans); encoder "
          f"enqueue {enq_ms:.3f} ms (host) [{card}]")
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]


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
    from cocodr_tpu_torch.ops import _build, ffn, mips_hier

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

    phase("kernel checks")
    kernels = [check_k1(ffn, gen, dev)]
    corpus = make_corpus(gen, dev)
    kernels.append(check_k2(mips_hier, corpus, gen, dev))
    kernels.append(check_k3(mips_hier, gen, dev))

    phase("serve")
    serve(args, gen, dev, corpus, kernels)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()


if __name__ == "__main__":
    main()
