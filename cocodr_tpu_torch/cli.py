"""Command-line interface of the port: the counterpart of cocodr_tpu/cli.py,
its fifteen subcommands with the JAX CLI's flags and outputs. The four
COCO-DR stages chain through it as docs/commands.md chains them through the
JAX CLI (each stage's checkpoint handed on by export-hf):

  python -m cocodr_tpu_torch.cli preprocess-coco --data-dirs ... --out spans \\
      --tokenizer BERT_DIR
  python -m cocodr_tpu_torch.cli coco --train-dir spans --checkpoint BERT_DIR \\
      --ckpt-dir coco_ck --preset coco-base
  python -m cocodr_tpu_torch.cli export-hf --from-orbax --checkpoint coco_ck \\
      --config BERT_DIR --out coco_ck/export
  python -m cocodr_tpu_torch.cli preprocess-msmarco --collection ... --out marco \\
      --tokenizer BERT_DIR [--train-queries ... --train-qrels ... ...]
  python -m cocodr_tpu_torch.cli warmup --triples ... --checkpoint coco_ck/export \\
      --tokenizer BERT_DIR --ckpt-dir warmup_ck [--eval-data-dir marco]
  python -m cocodr_tpu_torch.cli export-hf --checkpoint ... --out warmup_ck/export
  python -m cocodr_tpu_torch.cli ance --data-dir marco \\
      --checkpoint warmup_ck/export --ckpt-dir ance_ck [--preset ance-base]
  python -m cocodr_tpu_torch.cli ance-mine / ance-train   (the async pair)
  python -m cocodr_tpu_torch.cli eval-beir --data-dir ... --checkpoint ...
  python -m cocodr_tpu_torch.cli parity --checkpoint ... --beir-dir ...
  python -m cocodr_tpu_torch.cli preprocess-beir / encode / serve / convert-hf
  python -m cocodr_tpu_torch.cli presets

Checkpoints are HuggingFace directories (config.json with
pytorch_model.bin or model.safetensors) read through models/hf.py,
tokenizers the port's own (data/tokenizer.py: tokenizer.json, RoBERTa's
vocab.json + merges.txt or BERT's vocab.txt, taken as AutoTokenizer takes
them), and token records through the threaded native reader
(data/native.py, built with g++ at first use): transformers is never
imported. A training stage's own checkpoints are
the port's (utils/train_state.py: checkpoint-{step}/state.pt and a DONE
marker); `export-hf` turns one into a HuggingFace directory, and
`--from-orbax` keeps its JAX name for a COCO checkpoint of the port (the
port reads no orbax checkpoint). Commands that compute run on the card;
`--cpu-devices 1` runs them on the CPU through the kernels' plain
versions. The model computes in bf16 on the card (the kernels' dtype) and
in float32 on the CPU (the JAX CLI's dtype); parameters and optimizer
state are float32. `--compile-cache` and coco's `--dropout-rng` are
accepted for the JAX command lines and have no effect.

Several devices (core/mesh.py): `--mesh DATAxMODEL|auto` runs a command
over a world of processes, one a device: data-parallel over DATA, and the
training commands (warmup, ance, ance-train, coco) split every BERT
layer's weights over MODEL (tensor parallelism, parallel/tp.py), as the
JAX CLI's shard_train_init does; the inference commands run data-parallel
with whole weights on every rank, as the JAX CLI replicates them there. `--distributed`
joins the world torchrun made (`torchrun --nproc-per-node N -m
cocodr_tpu_torch.cli CMD ... --distributed --mesh auto`: nccl, a card a
process); `--cpu-devices N` with N > 1 and a mesh spawns N CPU processes
over gloo (the JAX CLI's N virtual CPU devices); a mesh alone makes a
world of one. Every rank reads the same inputs; over a mesh rank 0 alone
prints and writes files (core/mesh.py::is_writer), while without one
each process of a --distributed world runs the command on its own card,
as each process of the JAX CLI does. `serve` over a mesh answers through rank 0, which sends
each query batch to the other ranks (pipelines/serve.py::Lockstep): its
REPL reads rank 0's stdin, which a spawned CPU rank does not have, so
there use --queries or --http.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import os
import shutil
import sys
import tempfile
import time


def _add_common(p):
    p.add_argument("--preset", default=None,
                   help="a stage preset (see `presets`)")
    p.add_argument("--compile-cache", default=None,
                   help="accepted for the JAX CLI's command lines and "
                        "ignored: the port has no compile cache (its kernels "
                        "are built once per checkout by nvcc)")
    p.add_argument("--mesh", default=None,
                   help="device mesh 'DATAxMODEL' (e.g. 8x1, 4x2: MODEL > 1 "
                        "splits the layers of a training command) or 'auto' "
                        "for all devices data-parallel; default "
                        "single-device")
    p.add_argument("--cpu-devices", type=int, default=0,
                   help="run on the CPU through the kernels' plain versions "
                        "(default: the card); N > 1 with --mesh spawns N "
                        "CPU processes joined over gloo")
    p.add_argument("--distributed", action="store_true",
                   help="join the world torchrun describes (RANK, "
                        "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT)")
    p.add_argument("--log-dir", default=None,
                   help="TensorBoard + JSONL metrics directory")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the whole command "
                        "into this directory (Chrome trace JSON) and the "
                        "spans of its threads (spans-*.json)")


def _device(args):
    """--cpu-devices / --distributed -> the torch device: the CPU, or the
    card (this rank's under torchrun, whose world main() has joined)."""
    import torch

    if args.cpu_devices >= 1:
        return torch.device("cpu")
    from cocodr_tpu_torch.ops._device import resolve_device

    dev = resolve_device("cuda")
    if getattr(args, "distributed", False):
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _build_mesh(args, dev):
    """--mesh spec -> a DeviceMesh over the world (core/mesh.py), or None
    for single-device."""
    spec = getattr(args, "mesh", None)
    if not spec:
        return None
    from cocodr_tpu_torch.core.mesh import MeshConfig, create_mesh, is_writer

    if spec == "auto":
        cfg = MeshConfig()
    else:
        try:
            d, m = spec.lower().split("x")
            cfg = MeshConfig(data=int(d), model=int(m))
        except ValueError:
            raise SystemExit(
                f"bad --mesh '{spec}': expected DATAxMODEL or auto")
    mesh = create_mesh(cfg, dev)
    if not is_writer(mesh):  # rank 0 alone prints
        sys.stdout = open(os.devnull, "w")
    return mesh


# how long a spawned CPU world may run (a command's whole run)
_WORLD_TIMEOUT = 30 * 86400.0


def _parse_buckets(spec):
    """--length-buckets '64,128' -> (64, 128); '' -> () (single width)."""
    if not spec:
        return ()
    return tuple(int(x) for x in spec.split(","))


def _metrics_logger(args, mesh=None):
    from cocodr_tpu_torch.core.mesh import is_writer

    if not getattr(args, "log_dir", None) or not is_writer(mesh):
        return None
    from cocodr_tpu_torch.utils.logging import MetricsLogger

    os.makedirs(args.log_dir, exist_ok=True)
    return MetricsLogger(
        log_dir=args.log_dir,
        jsonl_path=os.path.join(args.log_dir, "metrics.jsonl"),
    )


def _log(args, metrics, mesh=None):
    logger = _metrics_logger(args, mesh)
    if logger is not None:
        logger.log(0, metrics, prefix=f"{args.cmd}/")
        logger.close()


def _load_tokenizer(path: str):
    from cocodr_tpu_torch.data.tokenizer import load_tokenizer

    return load_tokenizer(path)


# the parameters a bare backbone checkpoint lacks, initialised afresh
_FRESH = ("head.", "doc_head.", "encoder.pooler.", "doc_encoder.pooler.")


# torch.nn.init's initialisers, which torch.nn's modules call as they are
# built
_INITIALISERS = ("uniform_", "normal_", "kaiming_uniform_", "ones_",
                 "zeros_")


def _uninitialised(build):
    """build() on the CPU with torch.nn.init's initialisers made no-ops:
    the parameters are allocated but not drawn (a checkpoint's tensors are
    copied in next). Building on the meta device instead would route the
    draws through PyTorch's Python reference ops, whose first use imports
    torch._dynamo: seconds a process."""
    from torch.nn import init

    saved = {name: getattr(init, name) for name in _INITIALISERS}
    try:
        for name in _INITIALISERS:
            setattr(init, name, lambda tensor, *a, **kw: tensor)
        return build()
    finally:
        for name, fn in saved.items():
            setattr(init, name, fn)


def _assemble(model, sd, fresh, std: float, seed: int):
    """A model built by _uninitialised takes sd's tensors; each submodule
    named by a prefix in `fresh` that sd lacks gets BERT's
    initialisation, in `fresh`'s order, from a CPU generator seeded `seed`
    -> (model keys sd lacks outside `fresh`, sd keys the model lacks)."""
    import torch

    from cocodr_tpu_torch.models.bert import init_weights

    missing, unexpected = model.load_state_dict(sd, strict=False)
    gen = torch.Generator().manual_seed(seed)
    for prefix in fresh:
        if any(k.startswith(prefix) for k in missing):
            init_weights(model.get_submodule(prefix.rstrip(".")), std, gen)
    return [k for k in missing if not k.startswith(fresh)], unexpected


def _load_model(checkpoint: str, model_type: str, device,
                int8_encode: bool = False, seed: int = 0):
    """A HuggingFace checkpoint directory (config.json and
    model.safetensors or pytorch_model.bin) -> a DualEncoder of model_type
    on `device`, float32 parameters, computing in bf16 on the card and
    float32 on the CPU (matmul_int8 with int8_encode). A checkpoint
    without the model's head or pooler (a bare backbone) leaves those
    parameters at a fresh initialisation drawn from a generator seeded
    `seed`; a single-backbone checkpoint gives both towers of a two-tower
    model (the reference initialises DPR's question and context models
    from one pretrained BERT, warmup/model/models.py:300-302)."""
    import torch

    from cocodr_tpu_torch.models.dual_encoder import (
        MODEL_REGISTRY,
        DualEncoder,
    )
    from cocodr_tpu_torch.models.hf import (
        config_from_hf,
        load_torch_state_dict,
        state_dict_from_hf,
    )

    with open(os.path.join(checkpoint, "config.json")) as f:
        bert = config_from_hf(json.load(f))
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    bert = dataclasses.replace(bert, dtype=dtype, matmul_int8=int8_encode)
    weights = None
    for name in ("model.safetensors", "pytorch_model.bin"):
        path = os.path.join(checkpoint, name)
        if os.path.exists(path):
            weights = load_torch_state_dict(path)
            break
    if weights is None:
        raise FileNotFoundError(f"no weights in {checkpoint}")
    if model_type not in MODEL_REGISTRY:
        raise KeyError(f"unknown model_type {model_type!r}; known: "
                       f"{sorted(MODEL_REGISTRY)}")
    cfg = MODEL_REGISTRY[model_type](bert)
    has_head = any(k.startswith("embeddingHead.") for k in weights)
    if cfg.two_tower and not any(k.startswith("question_model.")
                                 for k in weights):
        single = state_dict_from_hf(weights, dataclasses.replace(
            cfg, two_tower=False, use_head=False))
        mapped = dict(single)
        mapped.update({"doc_encoder." + k[len("encoder."):]: v
                       for k, v in single.items()})
    else:
        mapped = state_dict_from_hf(weights, dataclasses.replace(
            cfg, use_head=cfg.use_head and has_head))
    model = _uninitialised(lambda: DualEncoder(cfg))
    stale, unexpected = _assemble(model, mapped, _FRESH,
                                  bert.initializer_range, seed)
    if unexpected or stale:
        raise ValueError(f"{checkpoint}: keys the model lacks {unexpected}, "
                         f"model keys the checkpoint lacks {stale}")
    return model.to(device).eval()


def _len_kw(args):
    """--query-len / --doc-len -> BeirEvalConfig overrides (0: the task's
    default)."""
    kw = {}
    if args.query_len:
        kw["query_len"] = args.query_len
    if args.doc_len:
        kw["doc_len"] = args.doc_len
    return kw


def cmd_preprocess_beir(args):
    """Tokenize a BEIR task directory into record files (stage 1 of the
    reference's eval pipeline)."""
    from cocodr_tpu_torch.pipelines.eval_beir import (
        BeirEvalConfig,
        prepare_beir_task,
    )

    tokenizer = _load_tokenizer(args.tokenizer)
    cfg = BeirEvalConfig.for_task(args.task or os.path.basename(
        os.path.normpath(args.data_dir)), **_len_kw(args))
    prepare_beir_task(args.data_dir, args.out, tokenizer, cfg,
                      n_workers=args.n_workers)
    print(f"tokenized {args.data_dir} -> {args.out}")


def cmd_encode(args):
    """Encode a token-record file to .npy embeddings (the reference's
    encode-only stage, evaluate/drivers/run_ann_data_gen.py:273-274
    --inference); a multi-chunk model over records wider than its chunk
    writes one row a chunk and the row -> record map as OUT.rows.npy."""
    import numpy as np

    from cocodr_tpu_torch.core.mesh import is_writer
    from cocodr_tpu_torch.data.native import open_token_cache
    from cocodr_tpu_torch.pipelines.encode import (
        EncodeConfig,
        Encoder,
        encode_cache,
        encode_cache_multivector,
    )

    dev = _device(args)
    mesh = _build_mesh(args, dev)
    model = _load_model(args.checkpoint, args.model_type, dev,
                        int8_encode=args.int8_encode)
    cache = open_token_cache(args.records)
    enc = Encoder(model, mesh=mesh, is_query=args.queries,
                  noise_level=args.noise_level, device=dev)
    del model
    ecfg = EncodeConfig(batch_size=args.batch_size,
                        length_buckets=_parse_buckets(args.length_buckets))
    chunk_len = enc.model.cfg.chunk_len
    t0 = time.perf_counter()
    if chunk_len and cache.max_len > chunk_len:
        emb, row2doc = encode_cache_multivector(enc, cache, ecfg,
                                                chunk_len=chunk_len)
        if is_writer(mesh):
            np.save(args.out + ".rows.npy", row2doc)
    else:
        emb = encode_cache(enc, cache, ecfg)
    seconds = time.perf_counter() - t0
    if is_writer(mesh):
        np.save(args.out + ".tmp.npy", emb)
        os.replace(args.out + ".tmp.npy", args.out)
    _log(args, {"records": len(cache), "seconds": seconds,
                "records_per_s": len(cache) / max(seconds, 1e-9)}, mesh)
    print(json.dumps({
        "out": args.out, "n": int(emb.shape[0]), "dim": int(emb.shape[1]),
    }))


def _serve_http(args, service, n_docs):
    from cocodr_tpu_torch.pipelines.http_serve import make_server

    # one search before the ready line: the first call on the card sets
    # up cuBLAS and the allocator, which must not eat a request's timeout
    service.search([""])
    host, _, port = args.http.rpartition(":")
    server, _ = make_server(service, host=host or "127.0.0.1", port=int(port),
                            window_s=args.batch_window_ms / 1000.0)
    print(json.dumps({"ready": True, "http": args.http, "n_docs": n_docs}),
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.batcher.stop()
        server.server_close()


def _serve_bulk(args, service):
    """qid\\ttext TSV in, TREC run out, through the pipelined
    search_stream."""
    qids, texts = [], []
    with open(args.queries) as f:
        for ln in f:
            parts = ln.rstrip("\n").split("\t")
            if len(parts) >= 2:
                qids.append(parts[0])
                texts.append(parts[1])
    bs = service.cfg.max_batch
    batches = [texts[i:i + bs] for i in range(0, len(texts), bs)]
    t0 = time.perf_counter()
    qi = 0
    with contextlib.ExitStack() as stack:
        out = (stack.enter_context(open(args.output, "w"))
               if args.output else sys.stdout)
        for vals, ids in service.search_stream(batches,
                                               depth=args.stream_depth):
            for r in range(len(ids)):
                for rank, (d, v) in enumerate(zip(ids[r], vals[r]), 1):
                    out.write(f"{qids[qi]} Q0 {d} {rank} {float(v):.6f} "
                              f"cocodr_tpu\n")
                qi += 1
    dt = time.perf_counter() - t0
    qps = len(texts) / max(dt, 1e-9)
    _log(args, {"queries": len(texts), "seconds": dt, "qps": qps})
    print(json.dumps({"queries": len(texts), "seconds": round(dt, 3),
                      "qps": round(qps, 1)}), file=sys.stderr, flush=True)


def cmd_serve(args):
    """Online retrieval: a stdin REPL (one query a line -> one JSON line of
    the top-k (doc id, score) pairs), a bulk TREC run (--queries), or an
    HTTP server (--http). Corpus embeddings come from --emb (a .npy from
    `encode`) or are encoded at startup from --records."""
    import numpy as np

    from cocodr_tpu_torch.core.mesh import is_writer
    from cocodr_tpu_torch.pipelines.serve import (
        Lockstep,
        RetrievalService,
        ServeConfig,
    )

    dev = _device(args)
    mesh = _build_mesh(args, dev)
    model = _load_model(args.checkpoint, args.model_type, dev,
                        int8_encode=args.int8_encode)
    tokenizer = _load_tokenizer(args.tokenizer or args.checkpoint)
    if args.emb:
        corpus_emb = np.load(args.emb)
    else:
        from cocodr_tpu_torch.data.native import open_token_cache
        from cocodr_tpu_torch.pipelines.encode import (
            EncodeConfig,
            Encoder,
            encode_cache,
        )

        corpus_emb = encode_cache(
            Encoder(model, mesh=mesh, is_query=False, device=dev),
            open_token_cache(args.records),
            EncodeConfig(batch_size=args.batch_size))
    doc_ids = None
    if args.id_map:
        from cocodr_tpu_torch.data.records import load_id_map

        off2id = {v: k for k, v in load_id_map(args.id_map).items()}
        doc_ids = [off2id.get(i, i) for i in range(corpus_emb.shape[0])]
    # over a mesh, rank 0 sends each query batch to the other ranks
    service = (RetrievalService if mesh is None else Lockstep)(
        model, tokenizer, corpus_emb, doc_ids=doc_ids,
        cfg=ServeConfig(top_k=args.top_k, fast_search=args.fast,
                        quantize_int8=args.int8, exact_fp32=args.exact_fp32,
                        ivf=args.search_method == "ivf",
                        ivf_nprobe=args.ivf_nprobe),
        mesh=mesh, device=dev,
    )
    del model
    n_docs = int(corpus_emb.shape[0])
    if mesh is not None:
        if not is_writer(mesh):
            return service.follow()
        try:
            return _serve_modes(args, service, n_docs)
        finally:
            service.close()
    return _serve_modes(args, service, n_docs)


def _serve_modes(args, service, n_docs):
    if args.http:
        return _serve_http(args, service, n_docs)
    if args.queries:
        return _serve_bulk(args, service)
    print(json.dumps({"ready": True, "n_docs": n_docs}), flush=True)
    for line in sys.stdin:
        q = line.rstrip("\n")
        if not q:
            continue
        vals, ids = service.search([q])
        print(json.dumps({"query": q, "hits": [
            {"id": str(d), "score": float(v)}
            for d, v in zip(ids[0], vals[0])
        ]}), flush=True)


def _preset(args, default):
    from cocodr_tpu_torch.core.configs import PRESETS

    return PRESETS[args.preset]() if args.preset else default()


def _saver(args):
    if not getattr(args, "async_checkpoint", False):
        return None
    from cocodr_tpu_torch.utils.train_state import AsyncSaver

    return AsyncSaver()


def cmd_presets(args):
    from cocodr_tpu_torch.core.configs import PRESETS, to_json

    for name, fn in PRESETS.items():
        print(f"== {name} ==")
        print(to_json(fn()))


def cmd_eval_beir(args):
    """A BEIR task directory -> nDCG / recall / MRR (the reference's 3-stage
    eval pipeline); records are tokenized into --work-dir on first use."""
    from cocodr_tpu_torch.core.mesh import is_writer
    from cocodr_tpu_torch.pipelines.eval_beir import eval_beir

    dev = _device(args)
    mesh = _build_mesh(args, dev)
    model = _load_model(args.checkpoint, args.model_type, dev,
                        int8_encode=args.int8_encode)
    tokenizer = _load_tokenizer(args.tokenizer or args.checkpoint)
    task = args.task or os.path.basename(os.path.normpath(args.data_dir))
    metrics = eval_beir(
        model, args.data_dir, args.work_dir, tokenizer, task=task,
        mesh=mesh, device=dev, batch_size=args.batch_size, top_k=args.top_k,
        exact_fp32=args.exact_fp32,
        length_buckets=_parse_buckets(args.length_buckets),
        search_method=args.search_method, ivf_nprobe=args.ivf_nprobe,
        **_len_kw(args))
    if args.result_dir and is_writer(mesh):
        # the per-BEIR-task group curves the ANCE trainer reads
        # (reference ANCE/drivers/run_ann.py:270-284)
        from cocodr_tpu_torch.pipelines.ance import write_group_ndcg

        write_group_ndcg(args.result_dir, task, args.result_num,
                         metrics["ndcg_cut_10"], checkpoint=args.checkpoint)
    logger = _metrics_logger(args, mesh)
    if logger:
        logger.log(args.result_num, metrics, prefix=f"beir/{task}/")
        logger.close()
    print(json.dumps(metrics, indent=2))


# Published BEIR-avg nDCG@10 per released checkpoint (reference
# README.md:72-81), keyed by the checkpoint directory's basename.
EXPECTED_BEIR_AVG = {
    "cocodr-base-msmarco": 0.461,
    "cocodr-base-msmarco-idro-only": 0.447,
    "cocodr-base-msmarco-warmup": 0.435,
    "cocodr-base": 0.288,
    "cocodr-large-msmarco": 0.484,
    "cocodr-large-msmarco-idro-only": 0.462,
    "cocodr-large-msmarco-warmup": 0.456,
    "cocodr-large": 0.316,
}


def cmd_parity(args):
    """Quality parity of a checkpoint: encode -> exact search -> nDCG@10
    over one or more BEIR task directories, averaged and held against the
    published number (reference README.md:72-81) or --expect-ndcg. Exit
    code 1 on FAIL."""
    from cocodr_tpu_torch.pipelines.eval_beir import eval_beir

    dev = _device(args)
    model = _load_model(args.checkpoint, args.model_type, dev)
    tokenizer = _load_tokenizer(args.tokenizer or args.checkpoint)
    work_dir = args.work_dir or os.path.join(tempfile.gettempdir(),
                                             "cocodr_parity")
    per_task = {}
    for data_dir in args.beir_dir:
        task = os.path.basename(os.path.normpath(data_dir))
        metrics = eval_beir(
            model, data_dir, os.path.join(work_dir, task), tokenizer,
            task=task, device=dev, batch_size=args.batch_size,
            top_k=args.top_k, exact_fp32=args.exact_fp32, **_len_kw(args))
        per_task[task] = metrics["ndcg_cut_10"]
        print(f"{task}: nDCG@10 = {metrics['ndcg_cut_10']:.4f}")
    avg = sum(per_task.values()) / len(per_task)
    expected = args.expect_ndcg
    if expected is None:
        name = os.path.basename(os.path.normpath(args.checkpoint))
        expected = EXPECTED_BEIR_AVG.get(name)
    result = {
        "checkpoint": args.checkpoint,
        "tasks": per_task,
        "avg_ndcg_cut_10": round(avg, 4),
        "expected": expected,
    }
    if expected is not None:
        ok = abs(avg - expected) <= args.tolerance
        result["parity"] = "PASS" if ok else "FAIL"
        print(f"parity {result['parity']}: avg nDCG@10 {avg:.4f} vs "
              f"published {expected:.4f} (+/-{args.tolerance}) "
              f"[reference README.md:72-81]")
    else:
        print("no published number for this checkpoint name; pass "
              "--expect-ndcg (known: " + ", ".join(EXPECTED_BEIR_AVG) + ")")
    print(json.dumps(result))
    if result.get("parity") == "FAIL":
        sys.exit(1)


def cmd_preprocess_msmarco(args):
    """An MS MARCO collection and its query / qrels files -> token records
    (passages, {train,dev}-query) and offset-space qrels."""
    from cocodr_tpu_torch.data.preprocess import (
        rewrite_qrels,
        tokenize_msmarco_passages,
        tokenize_queries,
    )

    tokenizer = _load_tokenizer(args.tokenizer)
    os.makedirs(args.out, exist_ok=True)
    lowercase = "condenser" in args.model_type
    pid2off = tokenize_msmarco_passages(
        args.collection, os.path.join(args.out, "passages"), tokenizer,
        args.max_seq_length, lowercase=lowercase, data_type=args.data_type,
        n_workers=args.n_workers)
    for split, qfile, qrfile in (
            ("train", args.train_queries, args.train_qrels),
            ("dev", args.dev_queries, args.dev_qrels)):
        if not qfile:
            continue
        qid2off = tokenize_queries(
            qfile, os.path.join(args.out, f"{split}-query"), tokenizer,
            args.max_query_length, lowercase=lowercase,
            n_workers=args.n_workers)
        if qrfile:
            rewrite_qrels(qrfile, os.path.join(args.out, f"{split}-qrel.tsv"),
                          qid2off, pid2off)
    print(f"wrote records to {args.out}")


def _step_logger(logger, prefix, unit, per_step, start_step):
    """-> log_fn(step, metrics): one JSON line on stdout, the metrics with
    `{unit}_per_s` on the host clock since the previous line (since the
    run's start, at start_step, for the first), and the metrics to
    --log-dir."""
    last = [start_step, time.perf_counter()]

    def log_fn(s, m):
        now = time.perf_counter()
        m = dict(m, **{f"{unit}_per_s": (s - last[0]) * per_step
                       / max(now - last[1], 1e-9)})
        last[:] = [s, now]
        print(json.dumps({"step": s, **m}), flush=True)
        if logger:
            logger.log(s, m, prefix=prefix)

    return log_fn


def _resume_step(ckpt_dir: str) -> int:
    """The step of the newest DONE checkpoint under ckpt_dir, 0 if none."""
    from cocodr_tpu_torch.utils.train_state import CKPT_PREFIX, latest_checkpoint

    ck = latest_checkpoint(ckpt_dir)
    return int(os.path.basename(ck)[len(CKPT_PREFIX):]) if ck else 0


def _warmup_eval(args, model, dev):
    """--eval-data-dir -> eval_fn(state): combined_mrr over the dev queries
    and passages (with --eval-top1000, the reranking MRR too), one JSON
    line a call."""
    from cocodr_tpu_torch.data.native import open_token_cache
    from cocodr_tpu_torch.data.records import load_id_map, load_qrels
    from cocodr_tpu_torch.evals.mrr_eval import combined_mrr, load_top_dev

    d = args.eval_data_dir
    dev_qc = open_token_cache(os.path.join(d, "dev-query"))
    dev_pc = open_token_cache(os.path.join(d, "passages"))
    dev_qrels = {q: list(docs) for q, docs in
                 load_qrels(os.path.join(d, "dev-qrel.tsv")).items()}
    candidates = None
    if args.eval_top1000:
        # the reference's top1000.dev rerank mode
        # (warmup/utils/eval_mrr.py:166-229)
        candidates = load_top_dev(
            args.eval_top1000,
            load_id_map(os.path.join(d, "dev-query.qid2offset.pickle")),
            load_id_map(os.path.join(d, "passages.pid2offset.pickle")))

    def eval_fn(state):
        m = combined_mrr(state.model, dev_qc, dev_pc, dev_qrels,
                         candidates=candidates, device=dev)
        print(json.dumps({"step": int(state.step), **m}), flush=True)

    return eval_fn


def cmd_warmup(args):
    """BM25-warmup training on a triples TSV (reference
    warmup/drivers/run_bm25_warmup.py) with the nll step, checkpoints in
    --ckpt-dir, resumed from the newest DONE one."""
    from cocodr_tpu_torch.core.configs import WarmupStageConfig
    from cocodr_tpu_torch.pipelines.train_step import (
        TrainStepConfig,
        build_train_step,
    )
    from cocodr_tpu_torch.pipelines.warmup import WarmupConfig, run_warmup

    cfg = _preset(args, WarmupStageConfig.base)
    dev = _device(args)
    mesh = _build_mesh(args, dev)
    model = _load_model(args.checkpoint, cfg.model_type, dev)
    tokenizer = _load_tokenizer(args.tokenizer or args.checkpoint)
    state, device_put = _train_state(mesh, model,
                                     cfg.optimizer.build(model.parameters()))
    step = build_train_step(TrainStepConfig(loss_kind="nll"))
    eval_fn = _warmup_eval(args, model, dev) if args.eval_data_dir else None
    wcfg = WarmupConfig(
        max_seq_len=args.max_seq_len or cfg.max_seq_len,
        batch_size=args.batch_size or cfg.per_device_batch,
        num_epochs=cfg.num_epochs,
        save_steps=cfg.save_steps,
        max_steps=args.max_steps,
        eval_every_steps=args.eval_every,
        log_every=args.log_every,
    )
    logger = _metrics_logger(args, mesh)
    saver = _saver(args)
    log_fn = _step_logger(logger, "warmup/", "triplets", wcfg.batch_size,
                          _resume_step(args.ckpt_dir))
    run_warmup(state, step, args.triples, tokenizer, wcfg, args.ckpt_dir,
               eval_fn=eval_fn, log_fn=log_fn,
               dropout_seed=None if args.no_dropout else args.seed,
               saver=saver, device_put=device_put)
    if saver:
        saver.close()
    if logger:
        logger.close()


def _train_state(mesh, model, optimizer, extra=None):
    """-> (TrainState, device_put): data-parallel over a mesh
    (parallel/sharded_train.py::shard_train_init), else one device's state
    and None."""
    if mesh is not None:
        from cocodr_tpu_torch.parallel.sharded_train import shard_train_init

        return shard_train_init(mesh, model, optimizer, extra=extra)
    from cocodr_tpu_torch.utils.train_state import TrainState

    return TrainState(model, optimizer, extra=extra), None


def _int8_variant(model):
    """A twin of a dual encoder with matmul_int8 (W8A8 FFN blocks, K7) on
    the same device: the same parameter names, so that the mining encodes
    load the float model's weights into it (the int8 blocks quantize the
    float32 FFN weights per call); training keeps the float model."""
    from cocodr_tpu_torch.models.dual_encoder import DualEncoder

    cfg = dataclasses.replace(model.cfg, bert=dataclasses.replace(
        model.cfg.bert, matmul_int8=True))
    twin = _uninitialised(lambda: DualEncoder(cfg))
    return twin.to(next(model.parameters()).device).eval()


def _add_miner_knobs(sp):
    """Miner flags shared by `ance` and `ance-mine` (run_ann_data_gen.py's
    CLI surface)."""
    sp.add_argument("--search-method", default="auto",
                    choices=["auto", "pallas", "exact2", "fast", "blockmax",
                             "refined", "naive", "ivf"])
    sp.add_argument("--ivf-nprobe", type=int, default=32,
                    help="clusters probed a query with --search-method ivf "
                         "(the recall knob)")
    sp.add_argument("--emb-cache-dir", default="",
                    help="reuse corpus embeddings per checkpoint "
                         "(reference embedding_dir_exist/load_embedding)")
    sp.add_argument("--ann-chunk-factor", type=int, default=1,
                    help="mine 1/N of the train queries a round, rotating "
                         "(reference ann_chunk_factor)")
    sp.add_argument("--exact-fp32", action="store_true",
                    help="float32 sweep (FAISS-bit parity)")
    sp.add_argument("--emb-cache-keep", type=int, default=2,
                    help="keep the N newest cached corpus embeddings (0 = "
                         "keep all; reference "
                         "--only_keep_latest_embedding_file)")
    sp.add_argument("--int8-encode", action="store_true",
                    help="W8A8 int8 FFN blocks (K7) for the mining encodes; "
                         "training stays float")


def _mine_config(args, cfg):
    """MineConfig from the stage config and the miner's flags
    (run_ann_data_gen.py: --search-method, --emb-cache-dir :438-495,
    --ann-chunk-factor :332-386)."""
    from cocodr_tpu_torch.pipelines.ance import MineConfig

    return MineConfig(
        topk_training=cfg.topk_training,
        negative_sample=cfg.negative_sample,
        cluster_query=cfg.loss_kind != "nll",
        cluster_centroids=cfg.dro.n_groups,
        batch_size=cfg.eval_batch,
        length_buckets=_parse_buckets(getattr(args, "length_buckets", "")),
        search_method=getattr(args, "search_method", "auto") or "auto",
        ivf_nprobe=getattr(args, "ivf_nprobe", 32) or 32,
        emb_cache_dir=getattr(args, "emb_cache_dir", "") or "",
        emb_cache_keep=getattr(args, "emb_cache_keep", 2),
        ann_chunk_factor=getattr(args, "ann_chunk_factor", 1) or 1,
        exact_fp32=bool(getattr(args, "exact_fp32", False)),
    )


def _ance_config(args):
    """AnceStageConfig from --preset and the loss / DRO / schedule flags."""
    from cocodr_tpu_torch.core.configs import AnceStageConfig

    cfg = _preset(args, AnceStageConfig.base)
    if args.loss_kind:
        # the reference's --dro_type, its absence plain NLL
        # (ANCE/drivers/run_ann.py:903-906)
        cfg = dataclasses.replace(cfg, loss_kind=args.loss_kind)
    dro = cfg.dro
    if args.n_groups:
        dro = dataclasses.replace(dro, n_groups=args.n_groups)
    if args.weight_ema:
        # reference --weight_ema (run_ann.py:792,906)
        dro = dataclasses.replace(dro, weight_ema=True)
    for flag, field in (("dro_alpha", "alpha"), ("dro_eps", "eps"),
                        ("dro_rho", "rho"), ("dro_ema", "ema")):
        v = getattr(args, flag)
        if v is not None:
            dro = dataclasses.replace(dro, **{field: v})
    cfg = dataclasses.replace(cfg, dro=dro)
    if args.rewarmup:
        # per-episode LR re-warmup and cross-episode decay (reference
        # ANCE/drivers/run_ann.py:120-125,248-266)
        episode = args.steps_per_round or cfg.max_steps_per_episode
        cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(
            cfg.optimizer, schedule="episode-rewarmup",
            episode_steps=episode))
    return cfg


def _ance_setup(args):
    """What the ance / ance-mine / ance-train jobs share: the stage config,
    the model on the device, its train state (resumed from the newest DONE
    checkpoint unless --no-resume), the token caches and the qrels."""
    from cocodr_tpu_torch.data.native import open_token_cache
    from cocodr_tpu_torch.data.records import load_qrels
    from cocodr_tpu_torch.losses.dro import dro_greedy_init
    from cocodr_tpu_torch.utils.train_state import (
        latest_checkpoint,
        load_checkpoint,
    )

    cfg = _ance_config(args)
    dev = _device(args)
    mesh = _build_mesh(args, dev)
    model = _load_model(args.checkpoint, cfg.model_type, dev)
    extra = (dro_greedy_init(cfg.dro, device=dev)
             if cfg.loss_kind != "nll" else None)
    state, device_put = _train_state(
        mesh, model, cfg.optimizer.build(model.parameters()), extra)
    if not args.no_resume:
        ck = latest_checkpoint(args.ckpt_dir)
        if ck:
            load_checkpoint(ck, state)
            print(json.dumps({"resumed": ck, "step": int(state.step)}),
                  flush=True)
    d = args.data_dir
    caches = {name: open_token_cache(os.path.join(d, name))
              for name in ("passages", "train-query", "dev-query")}
    train_qrels = load_qrels(os.path.join(d, "train-qrel.tsv"))
    positives = {q: max(docs, key=docs.get) for q, docs in train_qrels.items()}
    dev_qrels = load_qrels(os.path.join(d, "dev-qrel.tsv"))
    return cfg, dev, state, caches, positives, dev_qrels, device_put


def _ance_step(cfg):
    from cocodr_tpu_torch.pipelines.train_step import (
        TrainStepConfig,
        build_train_step,
    )

    return build_train_step(TrainStepConfig(
        loss_kind=cfg.loss_kind, dro=cfg.dro,
        idro_last_k_layers=cfg.idro_last_k_layers,
        max_grad_norm=cfg.optimizer.max_grad_norm))


def cmd_ance(args):
    """Time-multiplexed ANCE (ance_round): each round mines negatives with
    the current weights, trains --steps-per-round steps on them and saves a
    checkpoint; a rerun resumes at the round after the newest ann file."""
    from cocodr_tpu_torch.data.streams import TripletBatcher
    from cocodr_tpu_torch.pipelines.ance import ance_round, get_latest_ann_data
    from cocodr_tpu_torch.utils.train_state import save_checkpoint

    cfg, dev, state, caches, positives, dev_qrels, device_put = \
        _ance_setup(args)
    step = _ance_step(cfg)
    batcher = TripletBatcher(caches["train-query"], caches["passages"])
    mine_cfg = _mine_config(args, cfg)
    mine_model = _int8_variant(state.model) if args.int8_encode else None
    logger = _metrics_logger(args, state.mesh)
    work_dir = os.path.join(args.ckpt_dir, "ann_data")
    # resume at the round after the newest ann file (the reference's
    # restarts find the newest checkpoint and ann data the same way,
    # run_ann.py:998-1002,263-287)
    start_round = 0
    if not args.no_resume:
        start_round = get_latest_ann_data(work_dir)[0] + 1
    for rnd in range(start_round, args.rounds):
        t0 = time.perf_counter()
        state, dev_metrics, steps = ance_round(
            state, step, batcher, caches["passages"], caches["train-query"],
            positives, caches["dev-query"], dev_qrels, work_dir, rnd,
            mine_cfg, batch_size=args.batch_size or cfg.per_device_batch,
            steps_per_round=args.steps_per_round,
            dropout_seed=None if args.no_dropout else args.seed,
            mesh=state.mesh, device_put=device_put, device=dev,
            mine_model=mine_model)
        rec = {"round": rnd, "steps": steps,
               **{k: float(v) for k, v in dev_metrics.items()},
               "seconds": time.perf_counter() - t0}
        print(json.dumps(rec), flush=True)
        if logger:
            logger.log(int(state.step), rec, prefix="ance/")
        save_checkpoint(args.ckpt_dir, state, keep=3)
    if logger:
        logger.close()


def cmd_ance_mine(args):
    """The async pair's producer (the reference's run_ann_data_gen.py):
    mines from each new checkpoint of --ckpt-dir, the first round from
    --checkpoint's weights."""
    from cocodr_tpu_torch.pipelines.ance import (
        checkpoint_params_loader,
        mine_loop,
    )

    cfg, dev, state, caches, positives, dev_qrels, _ = _ance_setup(args)
    model = _int8_variant(state.model) if args.int8_encode else state.model
    mine_loop(
        model, checkpoint_params_loader(args.ckpt_dir, state),
        os.path.join(args.ckpt_dir, "ann_data"), poll_secs=args.poll_secs,
        max_rounds=args.rounds if args.rounds > 0 else None,
        passage_cache=caches["passages"],
        train_query_cache=caches["train-query"], train_positives=positives,
        dev_query_cache=caches["dev-query"], dev_qrels=dev_qrels,
        cfg=_mine_config(args, cfg), mesh=state.mesh, device=dev)


def cmd_ance_train(args):
    """The async pair's consumer (the reference's run_ann.py): trains on
    each new ann file and checkpoints after it."""
    from cocodr_tpu_torch.data.streams import TripletBatcher
    from cocodr_tpu_torch.pipelines.ance import train_loop

    cfg, dev, state, caches, positives, dev_qrels, device_put = \
        _ance_setup(args)
    logger = _metrics_logger(args, state.mesh)
    saver = _saver(args)
    t0 = time.perf_counter()

    def metrics_cb(s, m):
        if s % 100 == 0:
            print(json.dumps({"step": s, "loss": float(m["loss"]),
                              "seconds": time.perf_counter() - t0}),
                  flush=True)

    train_loop(
        state, _ance_step(cfg),
        TripletBatcher(caches["train-query"], caches["passages"]),
        os.path.join(args.ckpt_dir, "ann_data"), args.ckpt_dir,
        batch_size=args.batch_size or cfg.per_device_batch,
        poll_secs=args.poll_secs,
        max_ann_files=args.rounds if args.rounds > 0 else None,
        steps_per_file=args.steps_per_round, metrics_cb=metrics_cb,
        resume=not args.no_resume,
        dropout_seed=None if args.no_dropout else args.seed,
        metrics_logger=logger, group_result_dir=args.result_dir,
        saver=saver, device_put=device_put)
    if saver:
        saver.close()
    if logger:
        logger.close()


def _hf_config(path: str):
    from cocodr_tpu_torch.models.hf import config_from_hf

    with open(os.path.join(path, "config.json")) as f:
        return config_from_hf(json.load(f))


def _train_checkpoint(path: str):
    """A training checkpoint of the port at path (a checkpoint-{step}
    directory with state.pt, or a root of them: the newest DONE one) ->
    its directory, or None (a HuggingFace directory)."""
    from cocodr_tpu_torch.utils.train_state import PAYLOAD, latest_checkpoint

    if os.path.exists(os.path.join(path, PAYLOAD)):
        return path
    return latest_checkpoint(path)


def _train_state_dict(ck: str):
    """The model's state dict of a training checkpoint (memory-mapped; the
    optimizer's moments are not read)."""
    import torch

    from cocodr_tpu_torch.utils.train_state import PAYLOAD

    return torch.load(os.path.join(ck, PAYLOAD), map_location="cpu",
                      weights_only=True, mmap=True)["model"]


def cmd_export_hf(args):
    """A checkpoint -> a HuggingFace directory (utils/train_state.py::
    export_hf_bert). The sources:
    - a HuggingFace dual-encoder directory: the backbone and the rdot_nll
      head under the reference's `embeddingHead.*`/`norm.*` names
      (ANCE/model/models.py:109-110), DPR's two towers under
      `question_model.`/`ctx_model.`; a source model.pt (a Condenser's
      c_head, unused on the embedding path) is copied as it is;
    - a warmup or ANCE checkpoint of the port (checkpoint-{step}/ or its
      root, the newest DONE one taken), a --model-type model whose
      backbone's config.json is in --config: the `warmup_ck/export`
      handoff the ANCE stage reads (docs/commands.md);
    - --from-orbax: a COCO checkpoint of the port, likewise -> the backbone
      and MLM head in pytorch_model.bin, the c_head in model.pt (reference
      COCO/modeling.py:123-131): the `coco_ck/export` handoff the warmup
      stage reads. The flag keeps the JAX CLI's name; the port reads its
      own state.pt, never orbax."""
    import torch

    from cocodr_tpu_torch.models.dual_encoder import (
        MODEL_REGISTRY,
        DualEncoder,
        DualEncoderConfig,
    )
    from cocodr_tpu_torch.utils.train_state import export_hf_bert

    ck = _train_checkpoint(args.checkpoint)
    if (args.from_orbax or ck) and not args.config:
        raise SystemExit("exporting a training checkpoint needs --config "
                         "(a directory with the backbone's config.json)")
    if args.from_orbax:
        from cocodr_tpu_torch.models.condenser import MLM_HEAD, split_state_dict

        ck = ck or args.checkpoint
        backbone, c_head = split_state_dict(_train_state_dict(ck))
        export_hf_bert(
            {"encoder." + k: v for k, v in backbone.items()
             if not k.startswith(MLM_HEAD)},
            DualEncoderConfig(bert=_hf_config(args.config)), args.out,
            head_params=c_head or None,
            extra_state={k: v for k, v in backbone.items()
                         if k.startswith(MLM_HEAD)})
        print(f"exported COCO checkpoint {ck} to {args.out}")
        return
    if ck:
        cfg = MODEL_REGISTRY[args.model_type](_hf_config(args.config))
        model = _uninitialised(lambda: DualEncoder(cfg))
        model.load_state_dict(_train_state_dict(ck))
    else:
        model = _load_model(args.checkpoint, args.model_type,
                            torch.device("cpu"))
    export_hf_bert(model.state_dict(), model.cfg, args.out)
    if model.cfg.two_tower:
        print(f"exported DPR BiEncoder checkpoint to {args.out}")
        return
    src_cpt = os.path.join(args.checkpoint, "model.pt")
    if os.path.exists(src_cpt):
        shutil.copy(src_cpt, os.path.join(args.out, "model.pt"))
    print(f"exported HF checkpoint {ck or args.checkpoint} to {args.out}"
          if ck else f"exported HF checkpoint to {args.out}")


def cmd_convert_hf(args):
    """A HuggingFace checkpoint directory -> the port's model of
    --model-type, and a report of its size."""
    import torch

    model = _load_model(args.hf_dir, args.model_type, torch.device("cpu"))
    cfg = model.cfg.bert
    n = sum(p.numel() for p in model.parameters())
    print(f"converted {args.hf_dir}: {n/1e6:.1f}M params, "
          f"{cfg.num_hidden_layers} layers, hidden {cfg.hidden_size}")


def cmd_preprocess_coco(args):
    """BEIR corpora -> span jsonl files (the 18-task COCO mix)."""
    from cocodr_tpu_torch.data.coco_spans import preprocess_corpus_to_spans

    tokenizer = _load_tokenizer(args.tokenizer)
    os.makedirs(args.out, exist_ok=True)
    for data_dir in args.data_dirs:
        task = os.path.basename(os.path.normpath(data_dir))
        out = os.path.join(args.out, f"{task}.spans.jsonl")
        t0 = time.perf_counter()
        n = preprocess_corpus_to_spans(os.path.join(data_dir, "corpus.jsonl"),
                                       out, tokenizer,
                                       target_len=args.target_len)
        dt = time.perf_counter() - t0
        print(f"{task}: {n} documents -> {out} ({dt:.2f} s, "
              f"{n / max(dt, 1e-9):.1f} docs/s)")


def _load_condenser(checkpoint: str, cfg, dev, seed: int):
    """A HuggingFace BERT MLM checkpoint directory (pytorch_model.bin or
    model.safetensors, backbone keys with or without `bert.`, the MLM head
    as `cls.predictions.*`; model.pt with the c_head when present) -> the
    stage's CoCondenserForPretraining on dev. Without model.pt the c_head
    keeps its fresh initialisation, drawn with the rest from a generator
    seeded `seed` (the from-scratch Condenser)."""
    import torch

    from cocodr_tpu_torch.models.condenser import (
        C_HEAD,
        CoCondenserForPretraining,
        join_state_dict,
    )
    from cocodr_tpu_torch.models.hf import load_torch_state_dict

    bert = _hf_config(checkpoint)
    bert = dataclasses.replace(
        bert, dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)
    weights = None
    for name in ("model.safetensors", "pytorch_model.bin"):
        path = os.path.join(checkpoint, name)
        if os.path.exists(path):
            weights = load_torch_state_dict(path)
            break
    if weights is None:
        raise FileNotFoundError(f"no weights in {checkpoint}")
    head_path = os.path.join(checkpoint, "model.pt")
    head = (load_torch_state_dict(head_path) if os.path.exists(head_path)
            else {})
    model = _uninitialised(lambda: CoCondenserForPretraining(
        bert, n_head_layers=cfg.n_head_layers, skip_from=cfg.skip_from,
        late_mlm=cfg.late_mlm, mlm_budget_frac=cfg.mlm_budget_frac))
    # the tied decoder (the word embeddings) and a pooler are not the
    # Condenser's parameters
    backbone = {k[len("bert."):] if k.startswith("bert.") else k: v
                for k, v in weights.items()}
    backbone = {k: v for k, v in backbone.items()
                if not k.startswith(("cls.predictions.decoder.", "pooler.",
                                     "embeddings.position_ids",
                                     "embeddings.token_type_ids"))}
    stale, unexpected = _assemble(model, join_state_dict(backbone, head),
                                  () if head else (C_HEAD,),
                                  bert.initializer_range, seed)
    if unexpected or stale:
        raise ValueError(f"{checkpoint}: keys the Condenser lacks "
                         f"{unexpected}, Condenser keys the checkpoint lacks "
                         f"{stale}")
    return model.to(dev).eval()


def cmd_coco(args):
    """COCO pretraining (coCondenser MLM + span contrastive, reference
    COCO/run_coco_pre_training.py) on span files, checkpoints in
    --ckpt-dir, resumed from the newest DONE one with the span stream
    fast-forwarded. --dropout-rng has no effect: the port's dropout
    generators are torch's, seeded from (--seed, step)."""
    from cocodr_tpu_torch.core.configs import CocoStageConfig
    from cocodr_tpu_torch.data.coco_collator import CoCondenserCollator
    from cocodr_tpu_torch.data.coco_spans import count_span_batches, span_batches
    from cocodr_tpu_torch.pipelines.coco import (
        CocoConfig,
        build_coco_train_step,
        run_coco_pretrain,
    )
    from cocodr_tpu_torch.utils.train_state import (
        latest_checkpoint,
        load_checkpoint,
    )

    cfg = _preset(args, CocoStageConfig.base)
    dev = _device(args)
    mesh = _build_mesh(args, dev)
    model = _load_condenser(args.checkpoint, cfg, dev, args.seed)
    tokenizer = _load_tokenizer(args.tokenizer or args.checkpoint)
    collator = CoCondenserCollator(
        tokenizer, mlm_probability=cfg.mlm_probability,
        max_seq_length=args.max_seq_length or cfg.max_seq_length)
    span_files = sorted(glob.glob(os.path.join(args.train_dir, "*.jsonl")))
    docs_per_batch = args.batch_docs or cfg.per_device_batch_docs
    # warmup_ratio -> warmup steps from the run's step budget (reference
    # COCO/trainer.py:66-70)
    total_steps = count_span_batches(span_files, docs_per_batch,
                                     cfg.num_epochs)
    if args.max_steps:
        total_steps = min(total_steps, args.max_steps) or args.max_steps
    opt_cfg = cfg.optimizer
    if cfg.warmup_ratio > 0 and total_steps > 0:
        opt_cfg = dataclasses.replace(
            opt_cfg, warmup_steps=cfg.warmup_steps_for(total_steps),
            total_steps=total_steps)
    state, device_put = _train_state(mesh, model,
                                     opt_cfg.build(model.parameters()))
    # resume from the newest DONE checkpoint (the reference resumes through
    # the HF Trainer's model_path, COCO/run_coco_pre_training.py:146-152)
    if not args.no_resume and args.ckpt_dir:
        ck = latest_checkpoint(args.ckpt_dir)
        if ck:
            load_checkpoint(ck, state)
            print(f"resumed from {ck} (step {state.step})", flush=True)
    batches = span_batches(span_files, collator,
                           docs_per_batch=docs_per_batch,
                           num_epochs=cfg.num_epochs, start_batch=state.step)
    step = build_coco_train_step(CocoConfig(
        cache_chunk_size=args.cache_chunk_size,
        max_grad_norm=opt_cfg.max_grad_norm))
    logger = _metrics_logger(args, mesh)
    saver = _saver(args)
    log_fn = _step_logger(logger, "coco/", "spans", 2 * docs_per_batch,
                          state.step)

    run_coco_pretrain(state, step, batches, args.seed,
                      max_steps=args.max_steps, log_fn=log_fn,
                      log_every=args.log_every, ckpt_dir=args.ckpt_dir,
                      save_steps=args.save_steps, saver=saver,
                      device_put=device_put)
    if saver:
        saver.close()
    if logger:
        logger.close()


def _add_dro_flags(sp):
    sp.add_argument("--loss-kind", default=None,
                    choices=["nll", "dro-greedy", "idro"],
                    help="override the preset's loss (reference --dro_type; "
                         "absent: plain NLL, run_ann.py:903-906)")
    sp.add_argument("--n-groups", type=int, default=0)
    sp.add_argument("--weight-ema", action="store_true",
                    help="EMA-blend the greedy h_fun update (reference "
                         "--weight_ema, run_ann.py:792,906)")
    sp.add_argument("--dro-alpha", type=float, default=None)
    sp.add_argument("--dro-eps", type=float, default=None)
    sp.add_argument("--dro-rho", type=float, default=None)
    sp.add_argument("--dro-ema", type=float, default=None)
    sp.add_argument("--length-buckets", default="")
    sp.add_argument("--no-dropout", action="store_true")
    sp.add_argument("--seed", type=int, default=0)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="cocodr_tpu_torch",
        description="COCO-DR on the card: the JAX CLI's subcommands "
                    "(pretraining, warmup, ANCE mining and training, "
                    "evaluation, export, preprocessing, encoding and "
                    "serving).")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("presets")
    sp.set_defaults(fn=cmd_presets)

    sp = sub.add_parser("eval-beir")
    _add_common(sp)
    sp.add_argument("--data-dir", required=True)
    sp.add_argument("--work-dir", required=True)
    sp.add_argument("--checkpoint", required=True)
    sp.add_argument("--tokenizer", default=None,
                    help="directory with tokenizer.json, vocab.json + "
                         "merges.txt or vocab.txt (default: --checkpoint)")
    sp.add_argument("--task", default=None)
    sp.add_argument("--model-type", default="rdot_nll_condenser")
    sp.add_argument("--batch-size", type=int, default=512)
    sp.add_argument("--top-k", type=int, default=1000)
    sp.add_argument("--query-len", type=int, default=0)
    sp.add_argument("--doc-len", type=int, default=0)
    sp.add_argument("--exact-fp32", action="store_true")
    sp.add_argument("--length-buckets", default="",
                    help="comma-separated ascending encode widths (last >= "
                         "the doc len), e.g. 64,128")
    sp.add_argument("--search-method", default="auto",
                    choices=["auto", "pallas", "exact2", "fast", "blockmax",
                             "refined", "naive", "ivf"])
    sp.add_argument("--ivf-nprobe", type=int, default=32,
                    help="clusters probed a query with --search-method ivf "
                         "(the recall knob)")
    sp.add_argument("--result-dir", default=None,
                    help="write ann_ndcg_group_{task}_{n} for the ANCE "
                         "trainer's per-task curves")
    sp.add_argument("--result-num", type=int, default=0)
    sp.add_argument("--int8-encode", action="store_true",
                    help="W8A8 int8 FFN blocks (K7) for the corpus and "
                         "query encodes")
    sp.set_defaults(fn=cmd_eval_beir)

    sp = sub.add_parser(
        "parity",
        help="a checkpoint's BEIR nDCG@10 against the published number "
             "(reference README.md:72-81)")
    _add_common(sp)
    sp.add_argument("--checkpoint", required=True,
                    help="HuggingFace checkpoint directory")
    sp.add_argument("--beir-dir", action="append", required=True,
                    help="BEIR task directory (corpus.jsonl, queries.jsonl, "
                         "qrels/); repeat for the average of several")
    sp.add_argument("--work-dir", default=None,
                    help="where the records go (default: cocodr_parity in "
                         "the temporary directory)")
    sp.add_argument("--tokenizer", default=None)
    sp.add_argument("--model-type", default="rdot_nll_condenser")
    sp.add_argument("--batch-size", type=int, default=512)
    sp.add_argument("--top-k", type=int, default=1000)
    sp.add_argument("--query-len", type=int, default=0)
    sp.add_argument("--doc-len", type=int, default=0)
    sp.add_argument("--exact-fp32", action="store_true")
    sp.add_argument("--expect-ndcg", type=float, default=None,
                    help="the target instead of the published number")
    sp.add_argument("--tolerance", type=float, default=0.005)
    sp.set_defaults(fn=cmd_parity)

    sp = sub.add_parser("encode")
    _add_common(sp)
    sp.add_argument("--checkpoint", required=True)
    sp.add_argument("--records", required=True,
                    help="token-record file (from preprocess-*)")
    sp.add_argument("--out", required=True, help=".npy output path")
    sp.add_argument("--model-type", default="rdot_nll_condenser")
    sp.add_argument("--batch-size", type=int, default=512)
    sp.add_argument("--queries", action="store_true",
                    help="encode with query_emb (default: body_emb)")
    sp.add_argument("--noise-level", type=float, default=0.0)
    sp.add_argument("--length-buckets", default="",
                    help="comma-separated ascending encode widths (last >= "
                         "the records' width), e.g. 64,128")
    sp.add_argument("--int8-encode", action="store_true",
                    help="W8A8 int8 FFN blocks (K7)")
    sp.set_defaults(fn=cmd_encode)

    sp = sub.add_parser("serve")
    _add_common(sp)
    sp.add_argument("--checkpoint", required=True)
    sp.add_argument("--tokenizer", default=None,
                    help="directory with tokenizer.json, vocab.json + "
                         "merges.txt or vocab.txt (default: --checkpoint)")
    sp.add_argument("--model-type", default="rdot_nll_condenser")
    sp.add_argument("--records", default=None)
    sp.add_argument("--emb", default=None, help=".npy corpus embeddings")
    sp.add_argument("--id-map", default=None,
                    help="docid2offset pickle for external ids")
    sp.add_argument("--batch-size", type=int, default=512)
    sp.add_argument("--top-k", type=int, default=10)
    sp.add_argument("--fast", action="store_true",
                    help="rescore-free block-argmax search (K2 packed + K3)")
    sp.add_argument("--int8", action="store_true",
                    help="int8 corpus and search (K6 + K3)")
    sp.add_argument("--int8-encode", action="store_true",
                    help="W8A8 int8 FFN blocks for query encoding (K7)")
    sp.add_argument("--exact-fp32", action="store_true")
    sp.add_argument("--search-method", default="auto",
                    choices=["auto", "ivf"],
                    help="ivf: clustered approximate search; only the "
                         "probed clusters' blocks are read a query")
    sp.add_argument("--ivf-nprobe", type=int, default=32,
                    help="--search-method ivf: clusters probed a query "
                         "(the recall knob)")
    sp.add_argument("--queries", default=None,
                    help="qid\\ttext TSV: bulk mode -> TREC run through the "
                         "pipelined search_stream (no REPL)")
    sp.add_argument("--output", default=None,
                    help="bulk mode: TREC run file (default stdout)")
    sp.add_argument("--stream-depth", type=int, default=8,
                    help="bulk mode: query batches kept in flight")
    sp.add_argument("--http", default=None, metavar="[HOST:]PORT",
                    help="serve over HTTP with dynamic batching "
                         "(GET /healthz, POST /search)")
    sp.add_argument("--batch-window-ms", type=float, default=2.0,
                    help="http mode: request-coalescing window")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("preprocess-msmarco")
    sp.add_argument("--collection", required=True)
    sp.add_argument("--train-queries")
    sp.add_argument("--train-qrels")
    sp.add_argument("--dev-queries")
    sp.add_argument("--dev-qrels")
    sp.add_argument("--out", required=True)
    sp.add_argument("--tokenizer", required=True,
                    help="directory with tokenizer.json, vocab.json + "
                         "merges.txt or vocab.txt (a BERT or RoBERTa "
                         "checkpoint)")
    sp.add_argument("--model-type", default="rdot_nll_condenser",
                    help="a condenser model type lowercases the text")
    sp.add_argument("--data-type", type=int, default=1,
                    help="1: passages (pid, text); 0: documents (D-prefixed "
                         "docid, url, title, body)")
    sp.add_argument("--max-seq-length", type=int, default=128)
    sp.add_argument("--max-query-length", type=int, default=64)
    sp.add_argument("--n-workers", type=int, default=1,
                    help="tokenizer processes (the reference uses 32, "
                         "ANCE/utils/util.py:420-436); the output is the "
                         "same byte for byte")
    sp.set_defaults(fn=cmd_preprocess_msmarco)

    sp = sub.add_parser("preprocess-beir")
    sp.add_argument("--data-dir", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--tokenizer", required=True,
                    help="directory with tokenizer.json, vocab.json + "
                         "merges.txt or vocab.txt (a BERT or RoBERTa "
                         "checkpoint)")
    sp.add_argument("--task", default=None)
    sp.add_argument("--n-workers", type=int, default=1)
    sp.add_argument("--query-len", type=int, default=0)
    sp.add_argument("--doc-len", type=int, default=0)
    sp.set_defaults(fn=cmd_preprocess_beir)

    sp = sub.add_parser("warmup")
    _add_common(sp)
    sp.add_argument("--triples", required=True,
                    help="query \\t positive \\t negative TSV")
    sp.add_argument("--checkpoint", required=True)
    sp.add_argument("--tokenizer", default=None)
    sp.add_argument("--ckpt-dir", required=True)
    sp.add_argument("--batch-size", type=int, default=0)
    sp.add_argument("--max-steps", type=int, default=0)
    sp.add_argument("--eval-data-dir", default=None,
                    help="records from preprocess-msmarco (passages, "
                         "dev-query, dev-qrel.tsv) for the dev MRR")
    sp.add_argument("--eval-top1000", default=None,
                    help="top1000.dev candidate file (qid\\tpid...): adds "
                         "the reranking MRR to the dev eval")
    sp.add_argument("--eval-every", type=int, default=0)
    sp.add_argument("--no-dropout", action="store_true")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--max-seq-len", type=int, default=0,
                    help="override the preset's sequence length")
    sp.add_argument("--log-every", type=int, default=100)
    sp.add_argument("--async-checkpoint", action="store_true",
                    help="checkpoints written on a background thread (the "
                         "DONE marker last)")
    sp.set_defaults(fn=cmd_warmup)

    sp = sub.add_parser("ance")
    _add_common(sp)
    sp.add_argument("--data-dir", required=True)
    sp.add_argument("--checkpoint", required=True)
    sp.add_argument("--ckpt-dir", required=True)
    sp.add_argument("--rounds", type=int, default=10)
    sp.add_argument("--steps-per-round", type=int, default=5000)
    sp.add_argument("--batch-size", type=int, default=0)
    sp.add_argument("--no-resume", action="store_true")
    sp.add_argument("--rewarmup", action="store_true",
                    help="episode-rewarmup schedule (the rate re-warms each "
                         "round)")
    _add_dro_flags(sp)
    _add_miner_knobs(sp)
    sp.set_defaults(fn=cmd_ance)

    for name, fn in (("ance-mine", cmd_ance_mine),
                     ("ance-train", cmd_ance_train)):
        sp = sub.add_parser(name)
        _add_common(sp)
        sp.add_argument("--data-dir", required=True)
        sp.add_argument("--checkpoint", required=True)
        sp.add_argument("--ckpt-dir", required=True)
        sp.add_argument("--rounds", type=int, default=0)
        sp.add_argument("--poll-secs", type=float, default=60.0)
        sp.add_argument("--batch-size", type=int, default=0)
        sp.add_argument("--steps-per-round", type=int, default=5000)
        sp.add_argument("--no-resume", action="store_true")
        sp.add_argument("--rewarmup", action="store_true")
        sp.add_argument("--result-dir", default=None,
                        help="per-BEIR-task group results for the curves")
        sp.add_argument("--async-checkpoint", action="store_true")
        _add_dro_flags(sp)
        if name == "ance-mine":
            _add_miner_knobs(sp)
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("export-hf")
    sp.add_argument("--checkpoint", required=True,
                    help="a HuggingFace directory, or a training checkpoint "
                         "of the port (checkpoint-{step}/ or its root)")
    sp.add_argument("--out", required=True)
    sp.add_argument("--model-type", default="rdot_nll_condenser")
    sp.add_argument("--from-orbax", action="store_true",
                    help="the checkpoint is a COCO checkpoint of the port "
                         "(checkpoint-{step}/ or its root); exports the "
                         "backbone and MLM head and the c_head's model.pt "
                         "(the JAX CLI's name; no orbax is read)")
    sp.add_argument("--config", default=None,
                    help="directory with the backbone's config.json "
                         "(required with --from-orbax and for a warmup or "
                         "ANCE checkpoint of the port)")
    sp.set_defaults(fn=cmd_export_hf)

    sp = sub.add_parser("preprocess-coco")
    sp.add_argument("--data-dirs", nargs="+", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--tokenizer", required=True)
    sp.add_argument("--target-len", type=int, default=30)
    sp.set_defaults(fn=cmd_preprocess_coco)

    sp = sub.add_parser("coco")
    _add_common(sp)
    sp.add_argument("--train-dir", required=True)
    sp.add_argument("--checkpoint", required=True)
    sp.add_argument("--tokenizer", default=None)
    sp.add_argument("--ckpt-dir", required=True)
    sp.add_argument("--batch-docs", type=int, default=0)
    sp.add_argument("--cache-chunk-size", type=int, default=0,
                    help="the grad cache's chunk of spans (0: off)")
    sp.add_argument("--max-seq-length", type=int, default=0)
    sp.add_argument("--max-steps", type=int, default=1000000)
    sp.add_argument("--save-steps", type=int, default=10000)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--dropout-rng", default="rbg",
                    choices=["rbg", "threefry2x32"],
                    help="accepted for the JAX command lines and ignored: "
                         "the port's dropout generators are torch's, seeded "
                         "from (--seed, step)")
    sp.add_argument("--no-resume", action="store_true")
    sp.add_argument("--async-checkpoint", action="store_true",
                    help="checkpoints written on a background thread")
    sp.add_argument("--log-every", type=int, default=50,
                    help="a JSON line of the step's losses and spans/s "
                         "every N steps")
    sp.set_defaults(fn=cmd_coco)

    sp = sub.add_parser("convert-hf")
    sp.add_argument("--hf-dir", required=True)
    sp.add_argument("--model-type", default="rdot_nll_condenser")
    sp.set_defaults(fn=cmd_convert_hf)

    args = p.parse_args(argv)
    if getattr(args, "distributed", False):
        from cocodr_tpu_torch.core.mesh import init_world

        init_world("gloo" if getattr(args, "cpu_devices", 0) else None)
    elif getattr(args, "cpu_devices", 0) > 1 and getattr(args, "mesh", None):
        import torch.distributed as dist

        if not dist.is_initialized():  # the launcher: spawn the ranks
            from cocodr_tpu_torch.core.mesh import spawn

            store = tempfile.mkdtemp(prefix="cocodr-world-")
            try:
                spawn(main, args.cpu_devices, store,
                      sys.argv[1:] if argv is None else list(argv),
                      timeout=_WORLD_TIMEOUT)
            finally:
                shutil.rmtree(store, ignore_errors=True)
            return 0
    if getattr(args, "profile_dir", None):
        from cocodr_tpu_torch.utils.logging import profile_trace

        with profile_trace(args.profile_dir):
            return args.fn(args)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
