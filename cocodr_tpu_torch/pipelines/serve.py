"""Online retrieval serving: the counterpart of cocodr_tpu/pipelines/serve.py.

`RetrievalService` keeps the corpus embeddings resident on the device and
answers text queries: tokenize, encode with the query tower, top-k over
the corpus, then map row ids to external doc ids. The search mode follows
`ServeConfig`, with the JAX package's precedence:
  exact_fp32     float32 corpus, sort-per-tile search with float32
                 multiplies (`ops.mips.mips_topk`);
  quantize_int8  int8 corpus quantized at construction (half the bf16
                 memory), block-argmax search over it (K6 + K3,
                 `ops.mips_int8.mips_topk_int8`);
  fast_search    bf16 corpus, rescore-free block-argmax search (K2 packed
                 + K3, `ops.mips_hier.mips_topk_fast`);
  default        bf16 corpus (1.5 GiB per million 768-d docs), exact
                 hierarchical search (K2 + K3,
                 `ops.mips_hier.mips_topk_hierarchical`).
Query batches are padded to power-of-two buckets, as in the JAX package,
so a one-query call encodes 8 rows and not max_batch.

Except for exact_fp32, the corpus is replicate-padded once, at
construction, to the search's tile multiple, and the search is told the
real row count (`n_real`); the JAX service lets each search pad its own
copy. Results are the same.

PyTorch launches asynchronously: `dispatch` returns while the card works,
and `collect` / `collect_many` wait by copying the [batch, k] results to
the host, so `search_stream` keeps `depth` batches in flight.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from cocodr_tpu_torch.models.bert import cast_matmul_weights
from cocodr_tpu_torch.ops._device import resolve_device
from cocodr_tpu_torch.ops.mips import mips_topk
from cocodr_tpu_torch.ops.mips_hier import (
    _pad_replicate,
    mips_topk_fast,
    mips_topk_hierarchical,
)
from cocodr_tpu_torch.ops.mips_int8 import mips_topk_int8, quantize_corpus_int8

SEARCH_TILE = 2048  # corpus row multiple of the kernel searches' sweeps


@dataclasses.dataclass
class ServeConfig:
    top_k: int = 10
    max_query_len: int = 64
    # queries pad to a power-of-two bucket (min 8) capped at max_batch;
    # above max_batch, to the next multiple of max_batch
    max_batch: int = 64
    exact_fp32: bool = False
    # rescore-free block-argmax search; ignored with exact_fp32
    fast_search: bool = False
    # int8 corpus and search; ignored with exact_fp32, wins over fast_search
    quantize_int8: bool = False
    # IVF search (ops/ivf.py): not ported, raises unless exact_fp32
    ivf: bool = False


class RetrievalService:
    def __init__(
        self,
        model,
        tokenizer,
        corpus_emb,
        doc_ids: Optional[Sequence] = None,
        cfg: ServeConfig = ServeConfig(),
        mesh=None,
        device="cuda",
    ):
        """model: a models.dual_encoder.DualEncoder (moved to `device`, its
        matmul weights cast to the compute dtype in place);
        tokenizer: any callable with the HuggingFace call signature
        (texts, padding="max_length", truncation=True, max_length=...,
        return_tensors="np") -> {"input_ids", "attention_mask"};
        corpus_emb: [N, D] numpy array or tensor (a tensor already on the
        device is used without a host round trip)."""
        if cfg.ivf and not cfg.exact_fp32:
            raise NotImplementedError(
                "ServeConfig.ivf is not ported yet: ROADMAP.md Queue 1 "
                "item 7 (ops/ivf.py)"
            )
        if mesh is not None:
            raise NotImplementedError(
                "sharded serving is not ported yet: ROADMAP.md Queue 1 "
                "item 11 (parallel/*)"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.doc_ids = doc_ids
        corpus = torch.as_tensor(corpus_emb)
        self.n_docs = int(corpus.shape[0])
        self.dim_scale = None
        if cfg.exact_fp32:
            self.corpus = corpus.to(self.device, torch.float32).contiguous()
        elif cfg.quantize_int8:
            c_i8, self.dim_scale = quantize_corpus_int8(corpus.to(self.device))
            self.corpus = _pad_replicate(c_i8, SEARCH_TILE).contiguous()
        else:
            corpus = corpus.to(self.device, torch.bfloat16)
            self.corpus = _pad_replicate(corpus, SEARCH_TILE).contiguous()
        self.model = model.to(self.device).eval()
        cast_matmul_weights(self.model, model.cfg.bert.dtype)

    def _bucket(self, nq: int) -> int:
        """Static batch size for nq queries: next power of two >= nq
        (min 8), capped at max_batch; above max_batch, the next multiple
        of max_batch."""
        cap = self.cfg.max_batch
        if nq >= cap:
            return nq + ((-nq) % cap)
        b = 8
        while b < nq:
            b *= 2
        return min(b, cap)

    def _tokenize(self, texts: List[str]):
        out = self.tokenizer(
            texts,
            padding="max_length",
            truncation=True,
            max_length=self.cfg.max_query_len,
            return_tensors="np",
        )
        return (
            np.asarray(out["input_ids"]).astype(np.int64),
            np.asarray(out["attention_mask"]).astype(np.int64),
        )

    def dispatch(self, queries: List[str], k: int):
        """Enqueue one query batch; returns a pending handle without
        waiting for the card. Pass it to collect()."""
        nq = len(queries)
        pad = self._bucket(nq) - nq
        ids, mask = self._tokenize(list(queries) + [""] * pad)
        ids = torch.from_numpy(ids).to(self.device, non_blocking=True)
        mask = torch.from_numpy(mask).to(self.device, non_blocking=True)
        with torch.inference_mode():
            emb = self.model.query_emb(ids, mask)
            vals, idx = self._search(emb, k)
        return nq, (vals, idx)

    def _search(self, emb, k: int):
        """The configured search of query embeddings -> (scores, ids)."""
        cfg = self.cfg
        if cfg.exact_fp32:
            return mips_topk(emb, self.corpus, k, exact_fp32=True)
        if cfg.quantize_int8:
            return mips_topk_int8(emb, self.corpus, self.dim_scale, k,
                                  tile=SEARCH_TILE, n_real=self.n_docs)
        search = mips_topk_fast if cfg.fast_search else mips_topk_hierarchical
        return search(emb, self.corpus, k, tile=SEARCH_TILE,
                      n_real=self.n_docs)

    def _external(self, vals, idx, nq):
        vals, idx = vals[:nq], idx[:nq]
        if self.doc_ids is not None:
            ext = [[self.doc_ids[i] if i >= 0 else None for i in row]
                   for row in idx]
        else:
            ext = idx.tolist()
        return vals, ext

    def collect(self, pending) -> Tuple[np.ndarray, list]:
        """Wait for a dispatch() handle -> (scores [nq, k], ids)."""
        return self.collect_many([pending])[0]

    def collect_many(self, pendings) -> list:
        """Wait for several dispatch() handles (the first copy to the host
        waits for the card; the rest are ready by then)."""
        out = []
        for nq, (vals, idx) in pendings:
            out.append(self._external(vals.cpu().numpy(), idx.cpu().numpy(),
                                      nq))
        return out

    def search(self, queries: List[str], top_k: Optional[int] = None
               ) -> Tuple[np.ndarray, list]:
        """-> (scores [Q, k], ids [Q, k], external doc ids if provided)."""
        return self.collect(
            self.dispatch(list(queries), top_k or self.cfg.top_k)
        )

    def search_stream(self, query_batches, top_k: Optional[int] = None,
                      depth: int = 4):
        """Pipelined bulk serving: generator over (scores, ids) per batch,
        with up to `depth` batches dispatched before their results are
        collected. Same results as search() on each batch."""
        k = top_k or self.cfg.top_k
        inflight = []
        for queries in query_batches:
            inflight.append(self.dispatch(list(queries), k))
            if len(inflight) >= depth:
                yield from self.collect_many(inflight)
                inflight.clear()
        if inflight:
            yield from self.collect_many(inflight)
