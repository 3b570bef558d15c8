"""Mining's exact search: parallel/topk.py::search_topk over a corpus placed
once by pipelines/ance.py::place_corpus, queries in chunks, closed loop.

Corpus rows and queries are drawn on the device from the seed around
planted centres (each row its centre plus noise of the same norm, unit
length), so that a query's top k holds its cluster's rows and a tail, not
only near-ties. The window searches the queries chunk after chunk,
wrapping around; search_qps is the queries answered over the window's
seconds. From each chunk a sample of answers, drawn from the seed, is
kept; after the window the corpus is drawn again and the reference's
exact float32 search judges the sampled answers.
"""
from __future__ import annotations

import math

import torch

from portbench import roofline
from portbench.harness import Outcome
from portbench.reference import compare
from portbench.reference.search import exact_topk, scores_of

PROBES = {"K2": ("cocodr_tpu_torch.ops.mips_hier", "dual_sweep"),
          "K3": ("cocodr_tpu_torch.ops.mips_hier", "topk")}


def draw_centres(ctx):
    tr, D = ctx.traffic, ctx.config["hidden_size"]
    c = torch.randn(tr["centres"], D, generator=ctx.gen("centres"),
                    device=ctx.device)
    return c / c.norm(dim=1, keepdim=True)


def draw_rows(ctx, centres, tag: str, n: int):
    """n unit rows in bf16: a centre drawn for each, plus noise of norm
    ~spread, normalised; drawn in blocks of gen_rows."""
    tr = ctx.traffic
    D = centres.shape[1]
    g = ctx.gen(tag)
    out = torch.empty((n, D), dtype=torch.bfloat16, device=ctx.device)
    for s in range(0, n, tr["gen_rows"]):
        b = min(tr["gen_rows"], n - s)
        a = torch.randint(centres.shape[0], (b,), generator=g,
                          device=ctx.device)
        x = centres[a] + torch.randn(b, D, generator=g, device=ctx.device) * (
            tr["spread"] / math.sqrt(D))
        out[s:s + b] = (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    return out


class Session:
    """The placed corpus, the queries and a cursor over their chunks; one
    call() answers the next chunk and keeps a sample of its answers."""

    def __init__(self, ctx):
        from cocodr_tpu_torch.pipelines.ance import place_corpus

        tr = ctx.traffic
        self.ctx, self.tr = ctx, tr
        self.centres = draw_centres(ctx)
        corpus = draw_rows(ctx, self.centres, "corpus", tr["corpus_rows"])
        self.queries = draw_rows(ctx, self.centres, "queries", tr["queries"])
        self.corpus, self.n_real = place_corpus(corpus, method=tr["method"],
                                                device=ctx.device)
        del corpus
        ctx.note("corpus and queries drawn, corpus placed")
        Q, q = tr["queries"], tr["q_chunk"]
        self.chunks = [(s, min(s + q, Q)) for s in range(0, Q, q)]
        self.sample_rng = ctx.rng("sample")
        self.j, self.samples = 0, []

    def search(self, s, e):
        from cocodr_tpu_torch.parallel.topk import search_topk

        tr = self.tr
        return search_topk(self.queries[s:e], self.corpus, tr["k"],
                           q_chunk=tr["q_chunk"], method=tr["method"],
                           n_real=self.n_real, device=self.ctx.device)

    def warm(self):
        """Both chunk shapes of the cycle: a full one and the last."""
        for s, e in {self.chunks[0], self.chunks[-1]}:
            self.search(s, e)

    def call(self) -> int:
        s, e = self.chunks[self.j % len(self.chunks)]
        self.j += 1
        scores, ids = self.search(s, e)
        pos = self.sample_rng.choice(e - s, min(self.tr["sample_per_chunk"],
                                                e - s), replace=False)
        self.samples.append((s + pos, scores[pos], ids[pos]))
        return e - s

    def release(self):
        self.corpus = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def gaps(self, int8: bool = False):
        """(score gap, id gap) of the sampled answers against the exact
        search over the corpus drawn again; int8: the control's answers in
        the program's place."""
        import numpy as np

        rows = np.concatenate([r for r, _, _ in self.samples])
        got_v = np.concatenate([v for _, v, _ in self.samples])
        got_i = np.concatenate([i for _, _, i in self.samples])
        pick = np.sort(self.ctx.rng("check").choice(
            len(rows), min(self.tr["check_queries"], len(rows)),
            replace=False))
        n = self.tr["corpus_rows"]
        corpus = draw_rows(self.ctx, self.centres, "corpus", n)
        qs = self.queries[torch.as_tensor(rows[pick], device=self.ctx.device)]
        k = self.tr["k"]
        ref_v, _ = exact_topk(qs, corpus, n, k)
        if int8:
            v, i = exact_topk(qs, corpus, n, k, int8=True)
            got_v, got_i = v.cpu().numpy(), i.cpu().numpy()
        else:
            got_v, got_i = got_v[pick], got_i[pick]
        id_v = scores_of(qs, corpus, torch.as_tensor(got_i,
                                                     device=qs.device))
        return compare.topk_gaps(got_v, got_i, ref_v.cpu().numpy(),
                                 id_v.cpu().numpy(), n)


def run(ctx) -> Outcome:
    s = Session(ctx)
    s.warm()
    ctx.note("warm chunks done")
    _, queries = ctx.window(s.call, PROBES)
    D = ctx.config["hidden_size"]
    ctx.end_window(counts={"queries": queries,
                           "useful_flops": roofline.search_flops(
                               queries, s.n_real, D)})
    s.release()
    score_gap, id_gap = s.gaps()
    lim = ctx.limits
    return Outcome(e2e={"search_qps": queries / ctx.window_s},
                   checks=[("score_gap", score_gap, lim["score_gap"]),
                           ("id_gap", id_gap, lim["id_gap"])],
                   attempted=int(queries))


def readings(ctx, variant: str, chunks: int = 4) -> dict:
    """The compared numbers of `chunks` chunks at the cell's sizes, without
    a window: 'program' or 'control_int8' (the reference's search over
    int8 rows and queries in the program's place)."""
    s = Session(ctx)
    for _ in range(chunks):
        s.call()
    s.release()
    score_gap, id_gap = s.gaps(int8=variant == "control_int8")
    return {"score_gap": score_gap, "id_gap": id_gap}
