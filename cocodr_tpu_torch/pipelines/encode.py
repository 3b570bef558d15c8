"""Corpus and query encoding: the counterpart of cocodr_tpu/pipelines/encode.py.

`encode_cache` reads batches of token records off a `data.records.TokenCache`
(gathered on a prefetch thread), encodes them with an `Encoder` (the query
or body tower of a models.dual_encoder.DualEncoder) and returns the
embeddings [N, D] as a host numpy array. With `EncodeConfig.length_buckets`
records are grouped by length and each group runs at its bucket's width.

PyTorch launches asynchronously, so the loop keeps one batch in flight: it
enqueues batch i + 1 before it reads batch i's embeddings back (a copy to
pinned host memory that waits on an event of batch i alone). The JAX
package's `to_host` field is not carried over: the JAX function ignores it
and always returns host arrays, as this one does.
`encode_cache_multivector` encodes multi-chunk documents (a
`rdot_nll_multi_chunk` model's body tower) into one row a real chunk and
the row -> document map. With a mesh (core/mesh.py) each rank encodes
its rows of every batch (the batch padded to a multiple of the data axis
by copies of its last row) and an all-gather gives every rank the whole
batch's embeddings in order: the outputs equal a single device's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from cocodr_tpu_torch.core.mesh import data_rank, data_size, gather_rows
from cocodr_tpu_torch.data.prefetch import prefetch
from cocodr_tpu_torch.models.bert import cast_matmul_weights
from cocodr_tpu_torch.ops._device import resolve_device
from cocodr_tpu_torch.parallel.tp import unsplit_copy
from cocodr_tpu_torch.utils.logging import span
from cocodr_tpu_torch.utils.misc import add_embedding_noise


@dataclasses.dataclass
class EncodeConfig:
    batch_size: int = 512
    emb_dtype: np.dtype = np.float32
    # e.g. (32, 64, 128): encode short records at narrower widths
    length_buckets: tuple = ()


def inference_copy(model, device):
    """A copy of a models.dual_encoder.DualEncoder to serve or encode from:
    on `device`, in eval mode, without .grad or requires_grad, its matmul
    weights cast to the compute dtype (`cast_matmul_weights`). The caller's
    model keeps its float32 Parameters, their values and its train/eval
    mode. A model split over a model axis (parallel/tp.py) is copied whole,
    its slices gathered (every model rank calls this together): inference
    replicates the weights, as the JAX package's does."""
    out = unsplit_copy(model)
    for p in out.parameters():
        p.grad = None
    out.requires_grad_(False)
    out.to(device).eval()
    cast_matmul_weights(out, model.cfg.bert.dtype)
    return out


class Encoder:
    """The embedding function of one tower on one device.

    Encodes from a copy of the model made once here: on `device`, in eval
    mode, without gradients, its matmul weights held in the compute dtype
    (`cast_matmul_weights`, which keeps a matmul_int8 model's FFN weights
    float32). An eval of a model under training leaves its float32
    parameters, their requires_grad and its train/eval mode untouched
    (`Module.to(dtype)` on the model itself would cast the Parameters an
    optimizer holds); weights the caller changes later are not seen, so
    build a new Encoder. noise_level > 0 adds the reference's Gaussian
    embedding perturbation, drawn fresh for every batch from one
    generator seeded `noise_seed` (the JAX package folds the batch number
    into one key).

    mesh: a DeviceMesh whose data axis shards every batch: this rank
    encodes rows [r * B' / W, (r + 1) * B' / W) of the batch padded to B'
    rows, a multiple of W, and the embeddings are all-gathered, the
    padding dropped; the noise is drawn after the gather, on the whole
    batch, so every rank holds the same embeddings. Every rank of the
    mesh calls the encoder with the same batches."""

    def __init__(self, model, mesh=None, is_query: bool = False,
                 noise_level: float = 0.0, noise_seed: int = 0,
                 device="cuda"):
        self.mesh = mesh
        self.device = resolve_device(device)
        self.model = inference_copy(model, self.device)
        self._method = (self.model.query_emb if is_query
                        else self.model.body_emb)
        self.noise_level = noise_level
        self._gen = None
        if noise_level > 0.0:
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(noise_seed)

    def __call__(self, ids, mask):
        """ids, mask [B, S] (numpy or tensors) -> embeddings [B, D] on the
        device, in the compute dtype; returns before the card finishes."""
        if self.mesh is not None:
            return self._sharded(ids, mask)
        ids = torch.as_tensor(ids).to(self.device, non_blocking=True)
        mask = torch.as_tensor(mask).to(self.device, non_blocking=True)
        with torch.inference_mode():
            emb = self._method(ids, mask)
            if self._gen is not None:
                emb = add_embedding_noise(emb, self._gen, self.noise_level)
        return emb

    def _sharded(self, ids, mask):
        W, r = data_size(self.mesh), data_rank(self.mesh)
        ids, mask = torch.as_tensor(ids), torch.as_tensor(mask)
        B = ids.shape[0]
        pad = (-B) % W
        if pad:
            ids = torch.cat([ids, ids[-1:].expand(pad, -1)])
            mask = torch.cat([mask, mask[-1:].expand(pad, -1)])
        n = (B + pad) // W
        ids = ids[r * n:(r + 1) * n].to(self.device, non_blocking=True)
        mask = mask[r * n:(r + 1) * n].to(self.device, non_blocking=True)
        with torch.inference_mode():
            emb = gather_rows(self._method(ids, mask), self.mesh)[:B]
            if self._gen is not None:
                emb = add_embedding_noise(emb, self._gen, self.noise_level)
        return emb

    def dispatch(self, ids, mask):
        """Enqueue one batch and the copy of its float32 embeddings to
        pinned host memory; -> a handle for collect(). Span
        `cocodr.encode.dispatch`: the host's time to issue the batch."""
        with span("cocodr.encode.dispatch"), torch.inference_mode():
            emb = self(ids, mask).float()
            if self.device.type != "cuda":
                return emb, None
            host = torch.empty(emb.shape, dtype=emb.dtype, pin_memory=True)
            host.copy_(emb, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return host, done

    @staticmethod
    def collect(handle) -> np.ndarray:
        """Wait for a dispatch() handle -> float32 numpy [B, D]. Span
        `cocodr.encode.collect`: the wait, which ends with the copy."""
        host, done = handle
        with span("cocodr.encode.collect"):
            if done is not None:
                done.synchronize()
        return host.numpy()


def _encode_stream(encoder, stream, emit):
    """emit(key, pad, embeddings) for every (key, pad, tokens, mask) of
    the stream, in order, with the next batch enqueued before the current
    one is read back."""
    pending = None
    for key, pad, tokens, mask in stream:
        handle = encoder.dispatch(tokens, mask)
        if pending is not None:
            emit(pending[0], pending[1], encoder.collect(pending[2]))
        pending = (key, pad, handle)
    if pending is not None:
        emit(pending[0], pending[1], encoder.collect(pending[2]))


def _padded_batches(cache, idx, bs, width=None):
    """(start, pad, tokens, mask) per batch of idx; the trailing batch is
    padded to bs by repeating its last index (one shape for every batch);
    width cuts the columns to a bucket's width."""
    for s in range(0, len(idx), bs):
        chunk = idx[s:s + bs]
        pad = bs - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad)])
        tokens, mask = cache.batch_with_mask(chunk)
        if width is not None:
            tokens = np.ascontiguousarray(tokens[:, :width])
            mask = np.ascontiguousarray(mask[:, :width])
        yield s, pad, tokens, mask


def _stream(batches, prefetch_depth):
    if prefetch_depth > 0:
        return prefetch(batches, depth=prefetch_depth, device_put=False)
    return batches


def encode_cache_multivector(
    encoder: Encoder,
    cache,
    cfg: EncodeConfig = EncodeConfig(),
    chunk_len: int = 512,
    prefetch_depth: int = 2,
):
    """Multi-chunk documents -> a flat multi-vector index (rows, row2doc).

    The encoder gives [B, C, D] a batch, one vector a chunk of chunk_len
    tokens (models/dual_encoder.py::_multi_chunk_emb); a chunk whose first
    mask slot is 0 has no real token and is dropped. -> (emb [R, D] in
    cfg.emb_dtype, row2doc [R] int64, the record offset of each row), the
    layout the reference searches over and dedupes downstream (reference
    ANCE/drivers/run_ann_data_gen.py:201-204). The trailing batch is padded
    by repeating its last index; cfg.length_buckets is not used (chunked
    records have one width)."""
    n = len(cache)
    bs = cfg.batch_size
    embs, row2doc = [], []

    def batches():
        for s, pad, tokens, mask in _padded_batches(cache, np.arange(n), bs):
            yield (s, mask[:, ::chunk_len]), pad, tokens, mask

    def emit(key, pad, emb):
        s, first = key
        real = bs - pad
        keep = first[:real].astype(bool).reshape(-1)
        emb = emb[:real]
        embs.append(emb.reshape(-1, emb.shape[-1])[keep]
                    .astype(cfg.emb_dtype))
        row2doc.append(np.repeat(np.arange(s, s + real), emb.shape[1])[keep])

    _encode_stream(encoder, _stream(batches(), prefetch_depth), emit)
    return np.concatenate(embs), np.concatenate(row2doc)


def encode_cache(
    encoder: Encoder,
    cache,
    cfg: EncodeConfig = EncodeConfig(),
    indices: Optional[np.ndarray] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    prefetch_depth: int = 2,
) -> np.ndarray:
    """Encode all (or the selected) records of a token cache -> [N, D]
    embeddings in cfg.emb_dtype, in the order of `indices`.

    The trailing partial batch is padded to the full batch size and trimmed
    on output. Record gathers run `prefetch_depth` batches ahead on a
    background thread. progress(done, total) is called after every batch
    (after every bucket with length_buckets)."""
    n = len(cache) if indices is None else len(indices)
    idx = np.arange(n) if indices is None else np.asarray(indices)
    if cfg.length_buckets:
        return _encode_bucketed(encoder, cache, cfg, idx, progress,
                                prefetch_depth)
    bs = cfg.batch_size
    out = None

    def emit(s, pad, emb):
        nonlocal out
        if pad:
            emb = emb[:bs - pad]
        if out is None:
            out = np.empty((n, emb.shape[-1]), cfg.emb_dtype)
        out[s:s + len(emb)] = emb
        if progress:
            progress(min(s + bs, n), n)

    _encode_stream(encoder,
                   _stream(_padded_batches(cache, idx, bs), prefetch_depth),
                   emit)
    return out


def _encode_bucketed(encoder, cache, cfg, idx, progress, prefetch_depth):
    """Length-bucketed encode: records are grouped by token length into
    cfg.length_buckets (ascending widths; the last must cover max_len), a
    record of length l going to the bucket (lo, width] that holds it, and
    each group runs at its bucket's width. Output order matches `idx`."""
    lengths = cache.lengths()[idx]
    buckets = sorted(cfg.length_buckets)
    assert buckets[-1] >= cache.max_len, (buckets, cache.max_len)
    bs = cfg.batch_size
    out = None

    for b, width in enumerate(buckets):
        lo = buckets[b - 1] if b else 0
        sel = np.nonzero((lengths > lo) & (lengths <= width))[0]
        if len(sel) == 0:
            continue

        def emit(s, pad, emb, sel=sel):
            nonlocal out
            if pad:
                emb = emb[:bs - pad]
            if out is None:
                out = np.empty((len(idx), emb.shape[-1]), cfg.emb_dtype)
            out[sel[s:s + len(emb)]] = emb

        batches = _padded_batches(cache, idx[sel], bs, width)
        _encode_stream(encoder, _stream(batches, prefetch_depth), emit)
        if progress:
            progress(width, buckets[-1])
    return out
