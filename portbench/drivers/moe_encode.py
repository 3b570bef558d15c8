"""Corpus encoding with a DeepSeek-V2 tower: pipelines/encode.py's
encode_cache with the Encoder of a DualEncoder whose tower is
models/deepseek_v2.py (the body tower, last-token pooling), length
buckets, over a record file written by the port's RecordWriter, in a
closed loop.

The records' lengths come from the traffic's `sizes_seed`, the same for
every --seed, so that every run encodes the same lengths in the same
order; the ids and the weights come from --seed. The window calls
encode_cache on consecutive slices of `call_records` records (wrapping
around the file); encode_docs_per_s is the records encoded over the
window's seconds. From each call a sample of rows, drawn from the seed, is
kept; after the window the float32 reference (reference/deepseek_v2.py)
encodes those records from the same weights, and the check compares:
- emb_rel_err_max, emb_rel_err_mean: the rows' relative errors;
- route_mismatch_share: the share of (real token, MoE layer) pairs of
  those records whose top-k set of experts in the program (the records
  encoded again after the window, at their bucket's width in a full batch,
  as the window encodes them) differs from the reference's own.
The model's expert counter (`expert_rows`) is zeroed when the window opens
and read once when it closes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from portbench import program, weights_deepseek_v2, work_moe
from portbench.drivers.encode import write_records
from portbench.harness import Outcome
from portbench.reference import compare
from portbench.reference.deepseek_v2 import last_token_embeddings

PROBES = {"experts": ("cocodr_tpu_torch.ops.moe", "expert_ffn")}
NUMBERS = ("emb_rel_err_max", "emb_rel_err_mean", "route_mismatch_share")


def make_records(ctx):
    """-> (ids [n, S] int32, lengths [n]): BOS, ids drawn from the seed in
    [id_low, id_high), EOS, zeros past each record's length; the lengths
    uniform over [min_len, max_len] from the traffic's sizes_seed."""
    tr = ctx.traffic
    n, S = tr["records"], tr["max_len"]
    lengths = np.random.default_rng(tr["sizes_seed"]).integers(
        tr["min_len"], S + 1, n)
    ids = ctx.rng("records").integers(tr["id_low"], tr["id_high"], (n, S),
                                      dtype=np.int32)
    ids[:, 0] = tr["bos_id"]
    ids[np.arange(n), lengths - 1] = tr["eos_id"]
    ids[np.arange(S)[None, :] >= lengths[:, None]] = 0
    return ids, lengths


def tower_config(cfg: dict):
    """The port's DeepseekV2Config from the configuration's HuggingFace
    keys, computing in its compute_dtype. A program without the tower
    raises ImportError here, before any input is made."""
    from cocodr_tpu_torch.models.deepseek_v2 import config_from_hf

    return dataclasses.replace(config_from_hf(cfg.get),
                               dtype=program.DTYPES[cfg["compute_dtype"]])


@contextlib.contextmanager
def recorded_routes():
    """Every ops.moe.route call's top-k experts [T, k], in call order (the
    tower's MoE layers, in turn); what the program computes is unchanged."""
    from cocodr_tpu_torch.ops import moe

    real, got = moe.route, []

    def route(*a, **kw):
        r = real(*a, **kw)
        got.append(r.topk)
        return r

    moe.route = route
    try:
        yield got
    finally:
        moe.route = real


class Session:
    """The cell's records on disk, its weights (by HuggingFace's names, the
    program's and the reference's alike), the Encoder of the tower; one
    call() encodes the next `call_records` records and keeps a sample of
    their rows, drawn from the seed."""

    def __init__(self, ctx):
        from cocodr_tpu_torch.data.records import TokenCache
        from cocodr_tpu_torch.models.dual_encoder import (
            DualEncoder,
            DualEncoderConfig,
        )
        from cocodr_tpu_torch.models.hf import state_dict_from_hf
        from cocodr_tpu_torch.pipelines.encode import EncodeConfig, Encoder

        tr, cfg = ctx.traffic, ctx.config
        self.ctx, self.tr, self.cfg = ctx, tr, cfg
        tower = tower_config(cfg)
        self.ids, self.lengths = make_records(ctx)
        path = os.path.join(ctx.tmpdir, "records")
        write_records(path, self.ids, self.lengths)
        self.cache = TokenCache(path)
        ctx.note("records written")
        self.weights = weights_deepseek_v2.draw(
            cfg, ctx.gen("weights"), cfg["initializer_range"], ctx.device)
        dcfg = DualEncoderConfig.rdot_nll_condenser(tower)
        model = program.with_weights(lambda: DualEncoder(dcfg),
                                     state_dict_from_hf(self.weights, dcfg))
        self.encoder = Encoder(model.eval(), device=ctx.device)
        self.tower = self.encoder.model.encoder
        ctx.note("encoder built")
        self.buckets = tuple(sorted(tr["length_buckets"]))
        self.ecfg = EncodeConfig(batch_size=tr["batch"],
                                 length_buckets=self.buckets)
        self.sample_rng = ctx.rng("sample")
        self.cursor, self.flops, self.batches, self.samples = 0, 0, 0, []

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
        self.flops += int(work_moe.tower_forward_flops(
            self.cfg, self.lengths[idx]).sum())
        self.batches += self.batch_count(self.lengths[idx])
        return per_call

    def batch_count(self, lengths) -> int:
        """The batches encode_cache runs for records of these lengths: each
        bucket's records in batches of `batch`, the last one padded."""
        edges = (0,) + self.buckets
        per = np.histogram(lengths, bins=np.asarray(edges) + 0.5)[0]
        return int(sum(-(-n // self.tr["batch"]) for n in per))

    def expert_rows(self):
        """The counter as nested lists [layers][experts] (waits for the
        card)."""
        return self.tower.expert_rows.tolist()

    def check_rows(self):
        """-> (records, program rows) of the sample the check compares, the
        records in increasing order."""
        rows = np.concatenate([r for r, _ in self.samples])
        got = np.concatenate([e for _, e in self.samples])
        pick = self.ctx.rng("check").choice(
            len(rows), min(self.tr["check_rows"], len(rows)), replace=False)
        order = np.argsort(rows[pick], kind="stable")
        return rows[pick][order], got[pick][order]

    def program_routes(self, rows):
        """Each record's top-k experts a MoE layer, the records encoded
        again by the program at their bucket's width in full batches (the
        window's shapes) -> {record: [[length, k] a MoE layer]}."""
        bs, k = self.tr["batch"], self.cfg["num_experts_per_tok"]
        lengths = self.lengths[rows]
        out = {}
        for b, width in enumerate(self.buckets):
            lo = self.buckets[b - 1] if b else 0
            sel = rows[(lengths > lo) & (lengths <= width)]
            for s in range(0, len(sel), bs):
                chunk = sel[s:s + bs]
                full = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], bs - len(chunk))])
                ids, mask = self.cache.batch_with_mask(full)
                with recorded_routes() as got:
                    self.encoder(ids[:, :width], mask[:, :width])
                tops = [t.view(bs, width, k).cpu() for t in got]
                for j, r in enumerate(chunk):
                    n = int(self.lengths[r])
                    out[int(r)] = [t[j, :n] for t in tops]
        return out

    def reference(self, rows, rnd=None):
        """-> (float32 rows [R, H], the reference's own top-k experts a MoE
        layer [tokens, k], packed record by record)."""
        ids = torch.as_tensor(self.ids[rows], device=self.ctx.device)
        routes = []
        emb = last_token_embeddings(self.weights, self.cfg, ids,
                                    self.lengths[rows].tolist(), rnd=rnd,
                                    routes=routes)
        return emb.cpu().numpy(), [t.cpu() for _, t, _ in routes]

    def numbers(self, rnd=None) -> dict:
        """The compared numbers of the sampled rows against the float32
        reference; rnd: the reference computed with its tensors rounded by
        rnd in place of the program (the control)."""
        rows, got = self.check_rows()
        ref, ref_routes = self.reference(rows)
        if rnd is None:
            by_row = self.program_routes(rows)
            routes = [torch.cat([by_row[int(r)][i] for r in rows])
                      for i in range(len(ref_routes))]
        else:
            got, routes = self.reference(rows, rnd)
        err = compare.row_rel_err(got, ref)
        differ = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1)
                         .sum()) for a, b in zip(routes, ref_routes))
        pairs = sum(len(t) for t in ref_routes)
        return {"emb_rel_err_max": float(err.max()),
                "emb_rel_err_mean": float(err.mean()),
                "route_mismatch_share": differ / max(pairs, 1),
                "rows": int(len(rows))}

    def release(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def run(ctx) -> Outcome:
    tr = ctx.traffic
    s = Session(ctx)
    s.encode(np.arange(tr["warmup_records"]))
    ctx.note("warm call done")
    s.tower.expert_rows.zero_()
    _, records = ctx.window(s.call, PROBES)
    ctx.end_window(counts={
        "batches": s.batches, "records": records,
        "useful_flops": s.flops, "expert_rows": s.expert_rows()})
    s.release()
    got = s.numbers()
    return Outcome(e2e={"encode_docs_per_s": records / ctx.window_s},
                   checks=[(k, got[k], ctx.limits[k]) for k in NUMBERS
                           if k in ctx.limits],
                   attempted=int(records))


def readings(ctx, variant: str) -> dict:
    """The compared numbers of check_rows records sampled from one call at
    the cell's sizes, without a window: 'program' (the sound path) or
    'control_fp8' (the reference computed in float8 e4m3 in the program's
    place)."""
    from portbench.reference.bert import fp8_e4m3

    s = Session(ctx)
    s.tr = dict(ctx.traffic, sample_per_call=ctx.traffic["check_rows"])
    s.call()
    s.release()
    if variant not in ("program", "control_fp8"):
        raise ValueError(variant)
    return s.numbers(fp8_e4m3 if variant == "control_fp8" else None)
