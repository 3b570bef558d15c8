#!/usr/bin/env python3
"""Which of the collectives the port runs does torch.distributed's gloo
backend take for CUDA tensors, on this installation and card?

    python3 gloo_cuda_probe.py [--out PATH]

Two processes join a gloo world through a FileStore and each calls, on
tensors on card 0, every collective cocodr_tpu_torch issues: the list
all_gather (core/mesh.py::gather_rows, parallel/topk.py::distributed_topk),
all_reduce (psum, the gradient average of parallel/sharded_train.py),
broadcast (shard_train_init), barrier, broadcast_object_list
(pipelines/serve.py::Lockstep) and the differentiable all-gather of
losses/contrastive.py (torch.distributed.nn.functional.all_gather), whose
backward over gloo is a scatter from each rank in turn; then that scatter
on its own. Each call either returns the right values or raises, and the
probe records which. Rank 0 prints the torch version, the card's name and
power limit, and one JSON object {collective: "ok" or the error's first
line}, also written to --out.

chip_smoke.py reads no result of this script at run time: what it found
decides, in that file's code, whether the two-process leg over gloo runs.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2


def _calls(dev, rank):
    import torch.distributed.nn.functional as dist_nn

    x = torch.full((4, 3), float(rank + 1), device=dev)

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(WORLD)]
        dist.all_gather(parts, x)
        got = torch.cat(parts)[:, 0].tolist()
        assert got == [1.0] * 4 + [2.0] * 4, got

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        assert y[0, 0].item() == 3.0, y

    def broadcast():
        y = x.clone()
        dist.broadcast(y, src=0)
        assert y[0, 0].item() == 1.0, y

    def barrier():
        dist.barrier()

    def broadcast_object_list():
        box = [("queries", rank)]
        dist.broadcast_object_list(box, src=0)
        assert box[0] == ("queries", 0), box

    def differentiable_all_gather():
        leaf = x.clone().requires_grad_()
        out = torch.cat(dist_nn.all_gather(leaf))
        w = torch.arange(1, out.shape[0] + 1, device=dev, dtype=out.dtype)
        (out * w[:, None]).sum().backward()
        # the sum over both ranks of d(out)/d(leaf): 2 * rows of this rank
        want = 2 * w[rank * 4:(rank + 1) * 4]
        assert torch.equal(leaf.grad[:, 0], want), leaf.grad

    def scatter():
        y = torch.empty_like(x)
        dist.scatter(y, [x + i for i in range(WORLD)] if rank == 0 else None,
                     src=0)
        assert y[0, 0].item() == 1.0 + rank, y

    return [all_gather, all_reduce, broadcast, barrier,
            broadcast_object_list, differentiable_all_gather, scatter]


def _rank(rank, store_path, out):
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=60))
    found = {}
    for call in _calls(dev, rank):
        try:
            call()
            torch.cuda.synchronize()
            found[call.__name__] = "ok"
        except Exception as e:  # the finding itself: the call is refused
            found[call.__name__] = (f"{type(e).__name__}: "
                                    f"{str(e).splitlines()[0][:300]}")
    dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(found, f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/gloo_cuda_probe.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(os.path.join(tmp, "store"),
                                        args.out),
                           nprocs=WORLD, start_method="spawn")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{smi.stdout.strip()}")
    with open(args.out) as f:
        print(json.dumps(json.load(f)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
