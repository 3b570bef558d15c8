#!/usr/bin/env python3
"""Time the block-max sweeps and the top-k of one or more checkouts of
this repository on one NVIDIA H100, each in its own process, in the order
given.

    python3 sweep_times.py TREE [TREE ...]

For each TREE (a directory holding cocodr_tpu_torch/), the process builds
that tree's kernels and times K2 (dual block-max sweep), K6 (int8 sweep)
and K9 (top-2 certificate sweep) at Q = 64 and Q = 1024 over a
1,048,576 x 768 corpus drawn from one seed, by chip_smoke.device_ms
(loops of back-to-back launches behind a sleep kernel) with the time of
one launch per event pair beside; then K3 (exact top-k) at every shape of
chip_smoke.K3_SHAPES and on two tie-heavy inputs (int32 rows of values
0..7, and rows of finfo(float32).min with one larger entry in every other
row), in turns with torch.topk (chip_smoke.time_turns). Comparing two
trees: give them as parent, change, change, parent, so that both see the
card in the same states. Prints the card's name and power limit, then one
JSON line per tree, kernel and shape.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def one(tree: Path, seed: int) -> None:
    import torch

    import chip_smoke as cs  # this checkout's helpers, whatever the tree

    sys.path.insert(0, str(tree))
    import cocodr_tpu_torch
    from cocodr_tpu_torch.ops import _build, mips_exact2, mips_hier, mips_int8

    if Path(cocodr_tpu_torch.__file__).resolve().parent.parent != tree:
        raise RuntimeError(f"cocodr_tpu_torch must come from {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: sweep_times.py needs a GPU")
    lib = _build.library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    corpus = cs.make_corpus(gen, dev)
    corpus_i8, dim_scale = mips_int8.quantize_corpus_int8(corpus)
    for Q in (cs.BATCH, cs.SEARCH_Q):
        q = cs.normed(gen, dev, Q, cs.DIM)
        q_i8, _ = mips_int8.quantize_queries(q, dim_scale)
        runs = {"K2_dual_sweep": lambda: mips_hier.dual_sweep(q, corpus),
                "K6_int8_sweep": lambda: mips_int8.int8_sweep(q_i8, corpus_i8),
                "K9_top2_sweep": lambda: mips_exact2.top2_sweep(q, corpus)}
        for name, fn in runs.items():
            ms = cs.device_ms(fn, 20 if Q == cs.BATCH else 5)
            print(json.dumps({"tree": str(tree), "kernel": name, "Q": Q,
                              "loop_ms": ms, "one_launch_ms": cs.time_ms(fn),
                              "build_s": lib.seconds}), flush=True)
    for what, make, k in topk_inputs(cs, torch):
        x = make(gen, dev)
        Q, W = x.shape
        n = 200 if Q == cs.BATCH else 50
        ms, lib_ms = cs.time_turns(lambda: mips_hier.topk(x, k),
                                   lambda: torch.topk(x, k, dim=1), n)
        b_ms, b_by = cs.k3_bound(Q, W, k)
        print(json.dumps({"tree": str(tree), "kernel": "K3_topk",
                          "shape": what, "k": k, "ms": ms,
                          "torch_topk_ms": lib_ms, "bound_ms": b_ms,
                          "bound_by": b_by}), flush=True)


def topk_inputs(cs, torch):
    """(what, make(gen, dev) -> x, k): chip_smoke's K3 shapes, then the
    tie-heavy inputs."""
    out = [(f"{what} [{Q},{W}] {str(dt)[6:]}",
            lambda gen, dev, dt=dt, Q=Q, W=W: cs.k3_input(gen, dev, dt, Q, W),
            k) for what, dt, Q, W, k in cs.K3_SHAPES]

    def ties(gen, dev):
        return torch.randint(0, 8, (cs.SEARCH_Q, 2048), generator=gen,
                             device=dev, dtype=torch.int32)

    def sentinel(gen, dev):
        x = torch.full((cs.SEARCH_Q, 2048), torch.finfo(torch.float32).min,
                       device=dev)
        x[::2, 7] = 1.0
        return x

    out.append((f"ties 0..7 [{cs.SEARCH_Q},2048] int32", ties, cs.SEARCH_K))
    out.append((f"finfo.min rows [{cs.SEARCH_Q},2048] float32", sentinel,
                cs.SEARCH_K))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(args.trees[0].resolve(), args.seed)
        return
    import chip_smoke as cs

    print(cs.nvidia_smi(), flush=True)
    for tree in args.trees:
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--one", "--seed", str(args.seed), str(tree)],
                       check=True, timeout=900)


if __name__ == "__main__":
    main()
