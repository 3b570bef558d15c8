"""BEIR evaluation, tokenize -> encode -> exact search -> score: the
counterpart of cocodr_tpu/pipelines/eval_beir.py (reference
evaluate/commands/run_evaluate.sh:12-41: beir_data.py tokenization,
run_ann_data_gen.py --inference encode, evaluate_beir.py scoring) as one
pipeline with the search on the card.

Per-task sequence lengths follow the reference (evaluate/README.md):
query 64 (128 for ArguAna), doc 128 (256 for TREC-NEWS, Robust04 and
SciFact). ArguAna skips self-matches (evaluate_beir.py:143-145).

A multi-chunk model (chunk_len, records wider than one chunk) indexes one
row a real chunk (`encode_cache_multivector`); the search's row ids map
back to documents and each query's list keeps a document's best row
(`run_from_topk(dedupe=True)`, the reference's seen_pid handling,
evaluate_beir.py:132-134).

The functions take the port's model module where the JAX ones take
(model, params), and read records with data.records.TokenCache (the JAX
package's native reader only adds speed). Not ported yet, each raising
NotImplementedError: `search_method="ivf"` (ROADMAP.md Queue 1 item 7)
and a mesh (item 11).
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, Optional

import numpy as np

from cocodr_tpu_torch.data.preprocess import (
    load_beir_qrels,
    tokenize_beir_corpus,
    tokenize_beir_queries,
)
from cocodr_tpu_torch.data.records import TokenCache, load_id_map
from cocodr_tpu_torch.evals.metrics import evaluate_run, run_from_topk
from cocodr_tpu_torch.ops._device import resolve_device
from cocodr_tpu_torch.parallel.topk import search_topk
from cocodr_tpu_torch.pipelines.encode import (
    EncodeConfig,
    Encoder,
    encode_cache,
    encode_cache_multivector,
)

# Reference lengths: evaluate/README.md + evaluate_beir.py:62
LONG_DOC_TASKS = {"trec-news", "robust04", "scifact"}
LONG_QUERY_TASKS = {"arguana"}
SELF_SKIP_TASKS = {"arguana"}


@dataclasses.dataclass
class BeirEvalConfig:
    task: str = "scifact"
    query_len: int = 64
    doc_len: int = 128
    top_k: int = 1000
    batch_size: int = 512
    q_chunk: int = 4096
    mips_tile: int = 32768
    ndcg_k: int = 10
    recall_ks: tuple = (10, 100, 1000)
    exact_fp32: bool = False
    length_buckets: tuple = ()  # bucketed corpus encode
    # a method of ops/mips.py: 'auto' (= 'pallas', the exact kernel
    # search), 'pallas', 'exact2', 'fast', 'blockmax', 'refined', 'naive';
    # 'ivf' raises (ROADMAP.md Queue 1 item 7, which brings ivf_nprobe)
    search_method: str = "auto"

    @classmethod
    def for_task(cls, task: str, **kw) -> "BeirEvalConfig":
        t = task.lower()
        kw.setdefault("query_len", 128 if t in LONG_QUERY_TASKS else 64)
        kw.setdefault("doc_len", 256 if t in LONG_DOC_TASKS else 128)
        return cls(task=t, **kw)


def prepare_beir_task(data_dir: str, out_dir: str, tokenizer,
                      cfg: BeirEvalConfig, split: str = "test",
                      n_workers: int = 1):
    """Tokenize a BEIR task directory's corpus and queries into record files
    under out_dir; files already written are read back instead
    (idempotent). -> (corpus_path, query_path, docid2offset, qid2offset,
    qrels). n_workers > 1 tokenizes the corpus in fork workers (the output
    is byte-identical)."""
    os.makedirs(out_dir, exist_ok=True)
    corpus_path = os.path.join(out_dir, "passages")
    query_path = os.path.join(out_dir, "queries")
    qrels = load_beir_qrels(os.path.join(data_dir, "qrels", f"{split}.tsv"))
    clean = cfg.task == "robust04"
    if not os.path.exists(corpus_path + "_meta"):
        docid2off = tokenize_beir_corpus(
            os.path.join(data_dir, "corpus.jsonl"), corpus_path, tokenizer,
            cfg.doc_len, clean=clean, n_workers=n_workers)
    else:
        docid2off = load_id_map(corpus_path + ".docid2offset.pickle")
    if not os.path.exists(query_path + "_meta"):
        qid2off = tokenize_beir_queries(
            os.path.join(data_dir, "queries.jsonl"), query_path, tokenizer,
            cfg.query_len, keep=set(qrels), clean=clean)
    else:
        qid2off = load_id_map(query_path + ".qid2offset.pickle")
    return corpus_path, query_path, docid2off, qid2off, qrels


def evaluate_beir_task(model, corpus_path: str, query_path: str,
                       docid2off: Dict[str, int], qid2off: Dict[str, int],
                       qrels: Dict[str, Dict[str, int]], cfg: BeirEvalConfig,
                       mesh=None, device="cuda") -> Dict[str, float]:
    """Encode the task's records with `model` (a
    models.dual_encoder.DualEncoder, left as it is: the encoders work on
    their own copies), search the top cfg.top_k documents of every query
    on `device` and score the run -> evaluate_run's metrics."""
    if cfg.search_method == "ivf":
        raise NotImplementedError(
            "search_method='ivf' is not ported yet: ROADMAP.md Queue 1 "
            "item 7 (ops/ivf.py)"
        )
    dev = resolve_device(device)
    corpus_cache = TokenCache(corpus_path)
    query_cache = TokenCache(query_path)
    ecfg = EncodeConfig(batch_size=cfg.batch_size,
                        length_buckets=cfg.length_buckets)
    doc_encoder = Encoder(model, mesh=mesh, is_query=False, device=dev)
    chunk_len = model.cfg.chunk_len
    multivector = bool(chunk_len) and corpus_cache.max_len > chunk_len
    row2doc = None
    if multivector:
        if cfg.length_buckets:
            warnings.warn(
                "length_buckets is ignored for multi-chunk models: chunked "
                "records are fixed-width (C*chunk_len)", stacklevel=2,
            )
        corpus_emb, row2doc = encode_cache_multivector(
            doc_encoder, corpus_cache, ecfg, chunk_len=chunk_len)
    else:
        corpus_emb = encode_cache(doc_encoder, corpus_cache, ecfg)
    del doc_encoder
    query_emb = encode_cache(
        Encoder(model, mesh=mesh, is_query=True, device=dev), query_cache,
        ecfg)

    k = min(cfg.top_k, corpus_emb.shape[0])
    _, top_ids = search_topk(
        query_emb, corpus_emb, k, mesh=mesh, q_chunk=cfg.q_chunk,
        tile=cfg.mips_tile, exact_fp32=cfg.exact_fp32,
        method=cfg.search_method, device=dev,
    )
    if row2doc is not None:
        top_ids = np.where(top_ids >= 0, row2doc[top_ids], -1)
    off2docid = {v: k_ for k_, v in docid2off.items()}
    off2qid = {v: k_ for k_, v in qid2off.items()}
    query_ids = [off2qid[i] for i in range(len(query_cache))]
    run = run_from_topk(query_ids, top_ids, id_map=off2docid,
                        skip_self=cfg.task in SELF_SKIP_TASKS,
                        dedupe=multivector)
    return evaluate_run(run, qrels, ndcg_k=cfg.ndcg_k,
                        recall_ks=cfg.recall_ks)


def eval_beir(model, data_dir: str, work_dir: str, tokenizer,
              task: Optional[str] = None, mesh=None, device="cuda",
              **cfg_kw) -> Dict[str, float]:
    """One-call BEIR evaluation of a task directory (corpus.jsonl,
    queries.jsonl, qrels/test.tsv); cfg_kw are BeirEvalConfig fields."""
    task = task or os.path.basename(os.path.normpath(data_dir))
    cfg = BeirEvalConfig.for_task(task, **cfg_kw)
    corpus_path, query_path, d2o, q2o, qrels = prepare_beir_task(
        data_dir, work_dir, tokenizer, cfg)
    return evaluate_beir_task(model, corpus_path, query_path, d2o, q2o,
                              qrels, cfg, mesh=mesh, device=device)
