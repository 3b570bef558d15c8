"""Readings of a cell's compared numbers over many seeds in one process:
the program's sound path and its controls (and, for training, planted
faults), at the cell's own sizes, on the card. The limits in
limits/<cell>.json are set from these readings (PERF.md). Run on the card:

    python3 portbench/control.py --workload <name> --variant program \
        --seeds 1,2,3
"""
import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import shutil

    from portbench import harness

    manifest = harness.load_json(harness.BENCHMARK)
    cell = harness.find_cell(manifest, args.workload)
    files = harness.cell_files(manifest, cell)
    driver = harness.load_driver(files.traffic["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        tmp = tempfile.mkdtemp(prefix="portbench-")
        try:
            t = time.perf_counter()
            ctx = harness.Ctx(files, seed, 0.0, False, args.device, tmp, t)
            out = driver.readings(ctx, args.variant)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "variant": args.variant,
                          "seed": seed, **out,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
