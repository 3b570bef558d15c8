"""Corpus encoding: pipelines/encode.py::encode_cache with a tower's Encoder
over a record file written by the port's RecordWriter, in a closed loop.

The window calls encode_cache on consecutive slices of `call_records`
records (wrapping around the file), as an encode of a large corpus does
slice by slice; encode_docs_per_s is the records encoded over the window's
seconds. From each call a sample of rows, drawn from the seed, is kept;
after the window the reference encodes those records in float32 and the
rows' relative errors are compared.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from portbench import program, roofline
from portbench.harness import Outcome
from portbench.reference import compare
from portbench.reference.bert import cls_embeddings
from portbench.weights import bert_layout, draw

PREFIX = "encoder."
PROBES = {"K1": ("cocodr_tpu_torch.ops.ffn", "fused_ffn_block")}


def make_records(ctx):
    """-> (ids [n, S] int32, lengths [n]): [CLS], ids drawn from the seed,
    [SEP], zeros past each record's length."""
    tr = ctx.traffic
    n, S = tr["records"], tr["max_len"]
    rng = ctx.rng("records")
    lengths = rng.integers(tr["min_len"], S + 1, n)
    ids = rng.integers(tr["id_low"], ctx.config["vocab_size"], (n, S),
                       dtype=np.int32)
    ids[:, 0] = tr["cls_id"]
    ids[np.arange(n), lengths - 1] = tr["sep_id"]
    ids[np.arange(S)[None, :] >= lengths[:, None]] = 0
    return ids, lengths


def write_records(path, ids, lengths):
    from cocodr_tpu_torch.data.records import RecordWriter

    with RecordWriter(path, ids.shape[1]) as w:
        for row, n in zip(ids, lengths):
            w.write(row[:n])


def draw_weights(ctx):
    return draw(bert_layout(ctx.config, PREFIX), ctx.gen("weights"),
                ctx.config["initializer_range"], ctx.device)


def build_encoder(ctx, weights, **kw):
    from cocodr_tpu_torch.pipelines.encode import Encoder

    model = program.dual_encoder(ctx.config, weights, **kw)
    return Encoder(model, device=ctx.device)


def reference_rows(ctx, weights, ids, lengths, rnd=None):
    """The reference's CLS vectors of records (ids [R, S], lengths [R])."""
    S = ids.shape[1]
    ids_t = torch.as_tensor(ids, device=ctx.device)
    mask = (torch.arange(S, device=ctx.device)[None, :]
            < torch.as_tensor(lengths, device=ctx.device)[:, None])
    return cls_embeddings(weights, ctx.config, ids_t, mask, PREFIX,
                          rnd=rnd).cpu().numpy()


def forward_flops(cfg, lengths) -> int:
    """roofline.encoder_forward_flops summed over records of these
    lengths."""
    return int(roofline.encoder_forward_flops(
        np.asarray(lengths, np.int64), cfg["hidden_size"],
        cfg["intermediate_size"], cfg["num_hidden_layers"]).sum())


class Session:
    """The cell's records on disk, its weights and an Encoder of them; one
    call() encodes the next `call_records` records and keeps a sample of
    their rows, drawn from the seed."""

    def __init__(self, ctx, **model_kw):
        from cocodr_tpu_torch.data.records import TokenCache
        from cocodr_tpu_torch.pipelines.encode import EncodeConfig

        tr = ctx.traffic
        self.ctx, self.tr = ctx, tr
        self.ids, self.lengths = make_records(ctx)
        path = os.path.join(ctx.tmpdir, "records")
        write_records(path, self.ids, self.lengths)
        self.cache = TokenCache(path)
        ctx.note("records written")
        self.weights = draw_weights(ctx)
        self.encoder = build_encoder(ctx, self.weights, **model_kw)
        ctx.note("encoder built")
        self.ecfg = EncodeConfig(batch_size=tr["batch"])
        self.sample_rng = ctx.rng("sample")
        self.cursor, self.flops, self.samples = 0, 0, []

    def encode(self, idx):
        from cocodr_tpu_torch.pipelines.encode import encode_cache

        return encode_cache(self.encoder, self.cache, self.ecfg, indices=idx)

    def call(self) -> int:
        tr = self.tr
        per_call = tr["call_records"]
        idx = (self.cursor + np.arange(per_call)) % tr["records"]
        out = self.encode(idx)
        pos = self.sample_rng.choice(per_call, tr["sample_per_call"],
                                     replace=False)
        self.samples.append((idx[pos], out[pos].copy()))
        self.cursor = (self.cursor + per_call) % tr["records"]
        self.flops += forward_flops(self.ctx.config, self.lengths[idx])
        return per_call

    def release(self):
        self.encoder = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check_rows(self):
        """-> (records, program rows) of the sample the check compares."""
        rows = np.concatenate([r for r, _ in self.samples])
        got = np.concatenate([e for _, e in self.samples])
        pick = np.sort(self.ctx.rng("check").choice(
            len(rows), min(self.tr["check_rows"], len(rows)), replace=False))
        return rows[pick], got[pick]

    def numbers(self, rnd=None) -> dict:
        """The sampled rows' widest and mean relative error against the
        float32 reference; rnd: the reference computed with its tensors
        rounded by rnd in place of the program's rows (the control)."""
        rows, got = self.check_rows()
        ref = reference_rows(self.ctx, self.weights, self.ids[rows],
                             self.lengths[rows])
        if rnd is not None:
            got = reference_rows(self.ctx, self.weights, self.ids[rows],
                                 self.lengths[rows], rnd=rnd)
        err = compare.row_rel_err(got, ref)
        return {"emb_rel_err_max": float(err.max()),
                "emb_rel_err_mean": float(err.mean())}


def run(ctx) -> Outcome:
    tr = ctx.traffic
    s = Session(ctx)
    s.encode(np.arange(tr["warmup_records"]))
    ctx.note("warm call done")
    _, records = ctx.window(s.call, PROBES)
    ctx.end_window(counts={
        "batches": records / tr["batch"], "records": records,
        "useful_flops": s.flops, "T": tr["batch"] * tr["max_len"]})
    s.release()
    got = s.numbers()
    return Outcome(e2e={"encode_docs_per_s": records / ctx.window_s},
                   checks=[(k, got[k], lim) for k, lim in ctx.limits.items()],
                   attempted=int(records))


def readings(ctx, variant: str, calls: int = 2) -> dict:
    """The compared numbers of `calls` calls at the cell's sizes, without a
    window: 'program' (the sound path), 'control_int8' (the program with
    its int8 FFN path, K7, switched on) or 'control_fp8' (the reference
    computed in float8 e4m3 in the program's place)."""
    from portbench.reference.bert import fp8_e4m3

    s = Session(ctx, matmul_int8=variant == "control_int8")
    for _ in range(calls):
        s.call()
    s.release()
    return s.numbers(fp8_e4m3 if variant == "control_fp8" else None)
