"""Run one cell of the benchmark once, on the machine it is started on.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the compared numbers beside their limits as the last lines of
standard error and one JSON object as the last line of standard output.
Exits 3, printing no result, without as many CUDA cards as the cell asks
for, and 4 if a module of JAX or of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    # every cache of a run stays in the checkout, at fixed paths; the
    # port's kernels build into cocodr_tpu_torch/_build/
    cache = ROOT / ".portbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache / "inductor"))
    import torch

    from portbench import harness

    manifest = harness.load_json(harness.BENCHMARK)
    cell = harness.find_cell(manifest, args.workload)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    if args.trace:
        print(f"portbench: card {harness.card_info()}", file=sys.stderr)
    line = harness.run_cell(manifest, args.workload, args.seed, args.seconds,
                            bool(args.trace), device="cuda:0",
                            t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or of the JAX package were loaded: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        ok = "ok" if isinstance(c["value"], (int, float)) and (
            c["value"] <= c["limit"]) else "FAIL"
        print(f"check {name} {c['value']} limit {c['limit']} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
