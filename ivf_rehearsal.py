#!/usr/bin/env python3
"""CPU rehearsal of chip_smoke.py's IVF phase at a quarter of its corpus,
which sets the phase's recall bound (chip_smoke.IVF_RECALL_32) before the
card runs it.

    python3 ivf_rehearsal.py [--queries 256] [--threads 8]

The corpus is chip_smoke.planted_corpus at 262,144 x 768 bf16 around 256
planted centres (the card's 1,048,576 rows around 1,024, so each centre
keeps its ~1,024 rows), with the card phase's noise; the index has the
default 256 clusters, so nprobe 2 and 8 probe the share of the clusters
that the card's nprobe 8 and 32 probe of its 1,024. Prints the build's
and the searches' seconds (the CPU's, not the card's), and recall@100 of
IVF at nprobe 2, 8 and full probe against an exact plain search, through
chip_smoke.ivf_recalls (which also holds full probe and the exact
'pallas' search to the exact search).
"""
from __future__ import annotations

import argparse
import faulthandler
import json

import torch

import chip_smoke

ROWS, CENTRES, NPROBES = 262_144, 256, (2, 8)


def main() -> None:
    faulthandler.cancel_dump_traceback_later()  # chip_smoke's watchdog
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    dev = torch.device("cpu")
    gen = torch.Generator().manual_seed(args.seed + 14)
    corpus, centres = chip_smoke.planted_corpus(
        gen, dev, ROWS, chip_smoke.DIM, CENTRES, chip_smoke.IVF_NOISE)
    q = chip_smoke.planted_queries(gen, dev, centres, args.queries,
                                   chip_smoke.IVF_NOISE)
    r = chip_smoke.ivf_recalls(dev, corpus, q, chip_smoke.SEARCH_K, NPROBES,
                               seed=args.seed, runs=1)
    index = r.pop("index")
    print(json.dumps({
        "rows": ROWS, "centres": CENTRES, "queries": args.queries,
        "clusters": index.n_clusters, "blocks": index.n_blocks,
        "cpu_build_s": r["build_s"],
        "recall_at_100": {str(p): r[p][1]
                          for p in NPROBES + (index.n_clusters,)},
        "full_probe_max_score_err": r["full_err"],
    }))


if __name__ == "__main__":
    main()
