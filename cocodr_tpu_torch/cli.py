"""Command-line interface of the port: the counterpart of cocodr_tpu/cli.py
for the deployment path (text corpus -> token records -> embeddings -> a
served index):

  python -m cocodr_tpu_torch.cli preprocess-beir --data-dir ... --out ... \\
      --tokenizer CHECKPOINT_DIR
  python -m cocodr_tpu_torch.cli encode --checkpoint ... --records ... \\
      --out emb.npy
  python -m cocodr_tpu_torch.cli serve --checkpoint ... --emb emb.npy \\
      [--id-map ...] [--queries q.tsv --output run.trec | --http PORT]

The flags and outputs are the JAX CLI's. Checkpoints are HuggingFace
directories (config.json with pytorch_model.bin or model.safetensors)
read through models/hf.py, and tokenizers the port's WordPiece
(data/tokenizer.py, from vocab.txt): transformers is never imported.
Commands run on the card; `--cpu-devices 1` runs them on the CPU through
the kernels' plain versions. The model computes in bf16 on the card (the
kernels' dtype) and in float32 on the CPU (the JAX CLI's dtype).

The JAX CLI's other twelve subcommands (presets, eval-beir, parity,
preprocess-msmarco, warmup, ance, ance-mine, ance-train, export-hf,
preprocess-coco, coco, convert-hf) are not registered yet: ROADMAP.md
Queue 1 item 11.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time


def _add_common(p):
    p.add_argument("--preset", default=None,
                   help="a stage preset; the training subcommands that read "
                        "it are not ported yet (ROADMAP.md Queue 1 item 11)")
    p.add_argument("--compile-cache", default=None,
                   help="accepted for the JAX CLI's command lines and "
                        "ignored: the port has no compile cache (its kernels "
                        "are built once per checkout by nvcc)")
    p.add_argument("--mesh", default=None,
                   help="a device mesh: not ported yet (ROADMAP.md Queue 1 "
                        "item 11)")
    p.add_argument("--cpu-devices", type=int, default=0,
                   help="1: run on the CPU through the kernels' plain "
                        "versions (default: the card); more than one device "
                        "is not ported yet (ROADMAP.md Queue 1 item 11)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host: not ported yet (ROADMAP.md Queue 1 "
                        "item 11)")
    p.add_argument("--log-dir", default=None,
                   help="TensorBoard + JSONL metrics directory")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the whole command "
                        "into this directory (Chrome trace JSON)")


def _device(args):
    """--cpu-devices / --mesh / --distributed -> the torch device."""
    import torch

    if args.mesh or args.distributed or args.cpu_devices > 1:
        raise NotImplementedError(
            "--mesh, --distributed and --cpu-devices > 1 are not ported "
            "yet: ROADMAP.md Queue 1 item 11 (parallel/*)"
        )
    if args.cpu_devices == 1:
        return torch.device("cpu")
    from cocodr_tpu_torch.ops._device import resolve_device

    return resolve_device("cuda")


def _parse_buckets(spec):
    """--length-buckets '64,128' -> (64, 128); '' -> () (single width)."""
    if not spec:
        return ()
    return tuple(int(x) for x in spec.split(","))


def _metrics_logger(args):
    if not getattr(args, "log_dir", None):
        return None
    from cocodr_tpu_torch.utils.logging import MetricsLogger

    os.makedirs(args.log_dir, exist_ok=True)
    return MetricsLogger(
        log_dir=args.log_dir,
        jsonl_path=os.path.join(args.log_dir, "metrics.jsonl"),
    )


def _log(args, metrics):
    logger = _metrics_logger(args)
    if logger is not None:
        logger.log(0, metrics, prefix=f"{args.cmd}/")
        logger.close()


def _load_tokenizer(path: str):
    from cocodr_tpu_torch.data.tokenizer import load_tokenizer

    return load_tokenizer(path)


# the parameters a bare backbone checkpoint lacks, initialised afresh
_FRESH = ("head.", "doc_head.", "encoder.pooler.", "doc_encoder.pooler.")


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

    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
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
    model = build_dual_encoder(model_type, bert, device="cpu",
                               generator=torch.Generator().manual_seed(seed))
    cfg = model.cfg
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
    missing, unexpected = model.load_state_dict(mapped, strict=False)
    stale = [k for k in missing if not k.startswith(_FRESH)]
    if unexpected or stale:
        raise ValueError(f"{checkpoint}: keys the model lacks {unexpected}, "
                         f"model keys the checkpoint lacks {stale}")
    return model.to(device)


def cmd_preprocess_beir(args):
    """Tokenize a BEIR task directory into record files (stage 1 of the
    reference's eval pipeline)."""
    from cocodr_tpu_torch.pipelines.eval_beir import (
        BeirEvalConfig,
        prepare_beir_task,
    )

    tokenizer = _load_tokenizer(args.tokenizer)
    kw = {}
    if args.query_len:
        kw["query_len"] = args.query_len
    if args.doc_len:
        kw["doc_len"] = args.doc_len
    cfg = BeirEvalConfig.for_task(args.task or os.path.basename(
        os.path.normpath(args.data_dir)), **kw)
    prepare_beir_task(args.data_dir, args.out, tokenizer, cfg,
                      n_workers=args.n_workers)
    print(f"tokenized {args.data_dir} -> {args.out}")


def cmd_encode(args):
    """Encode a token-record file to .npy embeddings (the reference's
    encode-only stage, evaluate/drivers/run_ann_data_gen.py:273-274
    --inference); a multi-chunk model over records wider than its chunk
    writes one row a chunk and the row -> record map as OUT.rows.npy."""
    import numpy as np

    from cocodr_tpu_torch.data.records import TokenCache
    from cocodr_tpu_torch.pipelines.encode import (
        EncodeConfig,
        Encoder,
        encode_cache,
        encode_cache_multivector,
    )

    dev = _device(args)
    model = _load_model(args.checkpoint, args.model_type, dev,
                        int8_encode=args.int8_encode)
    cache = TokenCache(args.records)
    enc = Encoder(model, is_query=args.queries,
                  noise_level=args.noise_level, device=dev)
    del model
    ecfg = EncodeConfig(batch_size=args.batch_size,
                        length_buckets=_parse_buckets(args.length_buckets))
    chunk_len = enc.model.cfg.chunk_len
    t0 = time.perf_counter()
    if chunk_len and cache.max_len > chunk_len:
        emb, row2doc = encode_cache_multivector(enc, cache, ecfg,
                                                chunk_len=chunk_len)
        np.save(args.out + ".rows.npy", row2doc)
    else:
        emb = encode_cache(enc, cache, ecfg)
    seconds = time.perf_counter() - t0
    np.save(args.out + ".tmp.npy", emb)
    os.replace(args.out + ".tmp.npy", args.out)
    _log(args, {"records": len(cache), "seconds": seconds,
                "records_per_s": len(cache) / max(seconds, 1e-9)})
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
        out = (stack.enter_context(open(args.output, "w")) if args.output
               else sys.stdout)
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

    from cocodr_tpu_torch.pipelines.serve import RetrievalService, ServeConfig

    dev = _device(args)
    model = _load_model(args.checkpoint, args.model_type, dev,
                        int8_encode=args.int8_encode)
    tokenizer = _load_tokenizer(args.tokenizer or args.checkpoint)
    if args.emb:
        corpus_emb = np.load(args.emb)
    else:
        from cocodr_tpu_torch.data.records import TokenCache
        from cocodr_tpu_torch.pipelines.encode import (
            EncodeConfig,
            Encoder,
            encode_cache,
        )

        corpus_emb = encode_cache(
            Encoder(model, is_query=False, device=dev),
            TokenCache(args.records), EncodeConfig(batch_size=args.batch_size))
    doc_ids = None
    if args.id_map:
        from cocodr_tpu_torch.data.records import load_id_map

        off2id = {v: k for k, v in load_id_map(args.id_map).items()}
        doc_ids = [off2id.get(i, i) for i in range(corpus_emb.shape[0])]
    service = RetrievalService(
        model, tokenizer, corpus_emb, doc_ids=doc_ids,
        cfg=ServeConfig(top_k=args.top_k, fast_search=args.fast,
                        quantize_int8=args.int8, exact_fp32=args.exact_fp32,
                        ivf=args.search_method == "ivf",
                        ivf_nprobe=args.ivf_nprobe),
        device=dev,
    )
    del model
    n_docs = int(corpus_emb.shape[0])
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


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="cocodr_tpu_torch",
        description="The port's deployment path; the JAX CLI's other "
                    "subcommands wait for ROADMAP.md Queue 1 item 11.")
    sub = p.add_subparsers(dest="cmd", required=True)

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
                    help="directory with vocab.txt (default: --checkpoint)")
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

    sp = sub.add_parser("preprocess-beir")
    sp.add_argument("--data-dir", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--tokenizer", required=True,
                    help="directory with vocab.txt (a BERT checkpoint)")
    sp.add_argument("--task", default=None)
    sp.add_argument("--n-workers", type=int, default=1)
    sp.add_argument("--query-len", type=int, default=0)
    sp.add_argument("--doc-len", type=int, default=0)
    sp.set_defaults(fn=cmd_preprocess_beir)

    args = p.parse_args(argv)
    if getattr(args, "profile_dir", None):
        from cocodr_tpu_torch.utils.logging import profile_trace

        with profile_trace(args.profile_dir):
            return args.fn(args)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
