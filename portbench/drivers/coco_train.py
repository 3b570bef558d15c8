"""COCO pretraining: pipelines/coco.py::run_coco_pretrain with the direct
coCondenser step, its batches collated by data/coco_collator.py's
CoCondenserCollator on the prefetch thread over a span corpus written from
the seed through COCO's span packing.

One run_coco_pretrain call drives the state from the seed: its first
`check_steps` steps are set-up, then the window opens and the same call
trains until --seconds have passed and the compared window step k has
been fed; the feed then ends and the steps already queued finish inside
the window. train_tokens_per_s is the span positions the window's steps
took in (spans x max_seq_length) over its seconds.

What the check compares, once the window has closed:
- the first check_steps steps, which the float32 reference follows from
  the seed's weights with the same batches and dropout masks: each
  step's loss, the first clipped gradient, the weights' change;
- step k, drawn from the seed among the window's first
  window_check_steps: the reference takes the program's weights and Adam
  moments from just before it and follows that one step (its loss, its
  clipped gradient as the optimizer got it, the weights' change);
- that every leaf the reference moves changed over the whole window;
- that every compared batch is a collation of the corpus.
"""
from __future__ import annotations

import json
import os
from typing import List

import numpy as np
import torch

from portbench import program, roofline
from portbench.harness import Outcome, sub_seed
from portbench.reference import compare
from portbench.reference.coco import IGNORE, reference_steps
from portbench.weights import condenser_layout, draw

PROBES = {"K5": ("cocodr_tpu_torch.ops.ffn", "fused_ffn")}
WORD = 1000  # the first word-initial id; ids below are special or unused


class SpanTokenizer:
    """The collator's tokenizer: BERT's special ids ([PAD] 0, [UNK] 100,
    [CLS] 101, [SEP] 102, [MASK] 103), ids from 1000 word-initial pieces,
    the last third of the vocabulary continuation pieces ('##'), so that
    the whole-word mask groups a word's pieces."""

    pad_token_id, cls_token_id, sep_token_id, mask_token_id = 0, 101, 102, 103
    SPECIAL = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]",
               103: "[MASK]"}
    all_special_tokens = list(SPECIAL.values())

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self.continuation = WORD + 2 * (vocab_size - WORD) // 3

    def convert_ids_to_tokens(self, ids):
        return [self.SPECIAL.get(i) or (f"##{i}" if i >= self.continuation
                                        else str(i)) for i in ids]

    def num_special_tokens_to_add(self, pair=False):
        return 3 if pair else 2


class Corpus:
    """The span corpus as written: {span as a tuple: its documents}, and
    the spans longer than a row holds (the collator keeps a window of
    them)."""

    def __init__(self, row_tokens: int):
        self.row_tokens = row_tokens
        self.owner: dict = {}
        self.long: list = []

    def add(self, span: tuple, doc: int):
        self.owner.setdefault(span, set()).add(doc)
        if len(span) > self.row_tokens:
            self.long.append((span, doc))

    def docs_of(self, row_span: tuple) -> set:
        """The documents a row's span can come from: the span itself, or a
        full row's window of a longer span."""
        docs = self.owner.get(row_span)
        if docs is not None or len(row_span) != self.row_tokens:
            return docs or set()
        n = len(row_span)
        return {d for t, d in self.long
                if any(t[i:i + n] == row_span for i in range(len(t) - n + 1))}


def corpus_sizes(tr: dict):
    """The corpus's sizes from the traffic's `sizes_seed`, the same for
    every --seed -> (pieces a word, tokens kept a sentence, each sentence's
    document, each sentence's break draw). Documents are drawn from the
    corpora by their sizes, their words from their corpus's mean; the word
    stream is cut into sentences, and at each document's end; a word is one
    word-initial piece and 0-2 continuations; a sentence keeps its first
    max_sentence_tokens pieces, as coco_spans.doc_to_spans does."""
    sizes = np.random.default_rng(tr["sizes_seed"])
    _, n_docs, mean_words = zip(*tr["corpora"])
    n_docs = np.asarray(n_docs, np.float64)
    which = sizes.choice(len(n_docs), tr["docs"], p=n_docs / n_docs.sum())
    k = tr["doc_words_shape"]
    doc_words = np.maximum(1, np.rint(sizes.gamma(
        k, np.asarray(mean_words)[which] / k))).astype(np.int64)
    W = int(doc_words.sum())
    ks, ms = tr["sentence_words_shape"], tr["sentence_words_mean"]
    drawn = np.maximum(1, np.rint(sizes.gamma(
        ks, ms / ks, 2 * W // int(ms) + 64))).astype(np.int64)
    ends = np.cumsum(drawn)
    assert ends[-1] >= W
    doc_ends = np.cumsum(doc_words)
    cuts = np.union1d(ends[ends < W], doc_ends)
    sent_words = np.diff(np.concatenate([[0], cuts]))
    sent_doc = np.searchsorted(doc_ends, cuts, side="left")
    p = np.asarray(tr["continuations_p"], np.float64)
    pieces = 1 + sizes.choice(len(p), W, p=p / p.sum())
    sent_tokens = np.add.reduceat(
        pieces, np.concatenate([[0], np.cumsum(sent_words)[:-1]]))
    breaks = sizes.random(len(sent_words)) < tr["break_prob"]
    return pieces, sent_tokens, sent_doc, breaks


def pack(kept, sent_doc, breaks, target_len: int):
    """Sentences greedily packed into spans of about target_len tokens, a
    document at a time, with a random break (COCO's
    helper/create_train_co_short.py, as coco_collator.greedy_pack_spans
    does it) -> (tokens a span, each span's document)."""
    span_tokens, span_doc = [], []
    cur, cur_doc = 0, -1
    for n, d, brk in zip(kept.tolist(), sent_doc.tolist(), breaks.tolist()):
        if d != cur_doc:
            if cur:
                span_tokens.append(cur)
                span_doc.append(cur_doc)
            cur, cur_doc = 0, d
        elif cur and (cur + n > target_len or brk):
            span_tokens.append(cur)
            span_doc.append(d)
            cur = 0
        cur += n
    span_tokens.append(cur)
    span_doc.append(cur_doc)
    return np.asarray(span_tokens), span_doc


def write_spans(ctx, path) -> Corpus:
    """The span corpus, one {"spans": [[ids], ...]} line a document, as
    data/coco_spans.py writes it from a tokenized corpus. The sizes come
    from corpus_sizes (the same for every --seed); the ids, the order of
    the documents and the masks come from --seed, so that every seed does
    the same work in another order."""
    tr, V = ctx.traffic, ctx.config["vocab_size"]
    cont_id = SpanTokenizer(V).continuation
    pieces, sent_tokens, sent_doc, breaks = corpus_sizes(tr)
    rng = ctx.rng("spans")
    flat = rng.integers(cont_id, V, int(pieces.sum()))
    flat[np.concatenate([[0], np.cumsum(pieces)[:-1]])] = rng.integers(
        WORD, cont_id, len(pieces))
    cap = tr["max_sentence_tokens"]
    starts = np.concatenate([[0], np.cumsum(sent_tokens)[:-1]])
    offset = np.arange(len(flat)) - np.repeat(starts, sent_tokens)
    flat = flat[offset < cap]
    span_tokens, span_doc = pack(np.minimum(sent_tokens, cap), sent_doc,
                                 breaks, tr["target_len"])
    corpus = Corpus(tr["max_seq_length"] - 2)
    docs: List[list] = [[] for _ in range(tr["docs"])]
    for d, span in zip(span_doc,
                       np.split(flat, np.cumsum(span_tokens)[:-1])):
        ids = span.tolist()
        docs[d].append(ids)
        corpus.add(tuple(ids), d)
    with open(path, "w", encoding="utf8") as f:
        for doc in docs:
            f.write(json.dumps({"spans": doc}) + "\n")
    return corpus


def bad_rows(batch, corpus: Corpus, mlm_probability: float) -> int:
    """Rows of a collated batch that break the collation's guarantees: with
    the masked positions given back their labels, a row is [CLS] + a span
    of the corpus (or a full row's window of a longer one) + [SEP] +
    padding, rows 2i and 2i + 1 hold spans of one document, and a row has
    at most round(len * mlm_probability) labels (at least 1)."""
    ids, mask, labels = (np.asarray(batch[k]) for k in
                         ("input_ids", "attention_mask", "labels"))
    rows = np.where(labels != IGNORE, labels, ids)
    bad, docs = 0, []
    for r, m, lab in zip(rows, mask, labels):
        n = int(m.sum())
        span = tuple(int(x) for x in r[1:n - 1])
        owners = corpus.docs_of(span)
        ok = (r[0] == SpanTokenizer.cls_token_id
              and r[n - 1] == SpanTokenizer.sep_token_id
              and not r[n:].any() and bool(owners)
              and (lab != IGNORE).sum() <= max(
                  1, round(len(span) * mlm_probability)))
        docs.append(owners)
        bad += not ok
    for a, b in zip(docs[0::2], docs[1::2]):
        bad += not (a & b)
    return bad


NUMBERS = ("loss_gap", "grad_gap", "change_gap", "window_loss_gap",
           "window_grad_gap", "window_change_gap", "window_unmoved_leaves",
           "collate_bad_rows")


class Session:
    """The span corpus, the collated stream, the weights, (built on demand)
    the program's train state, and the compared window step `k`: a step
    number drawn from the seed among the window's first
    `window_check_steps`."""

    def __init__(self, ctx):
        from cocodr_tpu_torch.data.coco_collator import CoCondenserCollator
        from cocodr_tpu_torch.data.coco_spans import span_batches

        tr, cfg = ctx.traffic, ctx.config
        self.ctx, self.tr, self.cfg = ctx, tr, cfg
        path = os.path.join(ctx.tmpdir, "spans.jsonl")
        self.corpus = write_spans(ctx, path)
        ctx.note("span corpus written")
        coll = CoCondenserCollator(SpanTokenizer(cfg["vocab_size"]),
                                   tr["mlm_probability"],
                                   tr["max_seq_length"],
                                   seed=sub_seed(ctx.seed, "collator"))
        self.stream = span_batches([path], coll, tr["docs_per_batch"],
                                   seed=sub_seed(ctx.seed, "order"),
                                   num_epochs=1 << 30)
        self.dropout_seed = (sub_seed(ctx.seed, "dropout") if tr["dropout"]
                             else None)
        self.layout = condenser_layout(cfg, tr["n_head_layers"])
        self.head = {k: tr[k] for k in ("n_head_layers", "skip_from",
                                         "late_mlm")}
        self.k = tr["check_steps"] + int(ctx.rng("window step").integers(
            1, tr["window_check_steps"] + 1))
        self.label_counts = []  # labels a batch, in the order fed

    def weights(self):
        return draw(self.layout, self.ctx.gen("weights"),
                    self.cfg["initializer_range"], self.ctx.device)

    def feed(self, stop):
        """The stream, counting each batch's labels, until stop() is
        true."""
        for batch in self.stream:
            if stop():
                return
            self.label_counts.append(int((batch["labels"] != IGNORE).sum()))
            yield batch

    def train(self, on_step, stop):
        """run_coco_pretrain over feed(stop) with on_step(state, metrics,
        batch) after each step."""
        from cocodr_tpu_torch.core.configs import OptimizerConfig
        from cocodr_tpu_torch.pipelines.coco import (
            CocoConfig,
            build_coco_train_step,
            run_coco_pretrain,
        )
        from cocodr_tpu_torch.utils.train_state import TrainState

        opt = dict(self.tr["optimizer"])
        model = program.condenser(self.cfg, self.weights(), self.tr)
        optimizer = OptimizerConfig(schedule="linear", **opt).build(
            model.parameters())
        self.state = TrainState(model, optimizer)
        step = build_coco_train_step(CocoConfig(
            cache_chunk_size=0, max_grad_norm=opt["max_grad_norm"]))
        self.ctx.note("train state built")

        def wrapped(state, batch, dropout_seed):
            metrics = step(state, batch, dropout_seed)
            on_step(state, metrics, batch)
            return metrics

        run_coco_pretrain(self.state, wrapped, self.feed(stop),
                          self.dropout_seed, max_steps=1 << 62)

    def setup_numbers(self, state, metrics, batch, rec):
        """After each of the first check_steps steps (set-up; it may wait
        for the card): the loss, the batch, the first gradient's norms
        (Adam's first moment after step 1 over 1 - beta1) and, after the
        last, the weights' change."""
        k = state.step
        rec["losses"].append(float(metrics["loss"]))
        self.ctx.note(f"step {k} done")
        rec["batches"].append({n: v.cpu().numpy() for n, v in batch.items()})
        named = dict(state.model.named_parameters())
        if k == 1:
            opt = state.optimizer
            b1 = opt.param_groups[0]["betas"][0]
            # a parameter the step left without a moment reads 0
            rec["grad1"] = {
                n: float(opt.state[p]["exp_avg"].norm()) / (1 - b1)
                if "exp_avg" in opt.state.get(p, {}) else 0.0
                for n, p in named.items()}
        if k == self.tr["check_steps"]:
            w0 = self.weights()
            rec["change"] = {n: float((p.detach() - w0[n]).norm())
                             for n, p in named.items()}
            del w0
            rec["open"] = [p.detach().clone() for p in named.values()]

    @staticmethod
    def _moment(state, p, key):
        st = state.optimizer.state.get(p, {})
        return st[key] if key in st else torch.zeros_like(p)

    def window_numbers(self, state, metrics, batch, rec):
        """After each step: past step k - 1, a copy of the weights and the
        Adam moments; past step k, its loss, its batch and, per leaf, the
        norms of its clipped gradient (from the first moment: (m_k - beta1
        m_{k-1}) / (1 - beta1)) and of the weights' change. Copies and
        norms stay on the card: nothing here waits for it."""
        if state.step not in (self.k - 1, self.k):
            return
        named = dict(state.model.named_parameters())
        ps = [p.detach() for p in named.values()]
        ms = [self._moment(state, p, "exp_avg") for p in named.values()]
        if state.step == self.k - 1:
            vs = [self._moment(state, p, "exp_avg_sq")
                  for p in named.values()]
            rec["before"] = {n: (p.clone(), m.clone(), v.clone())
                             for n, p, m, v in zip(named, ps, ms, vs)}
            return
        b1 = state.optimizer.param_groups[0]["betas"][0]
        before = [rec["before"][n] for n in named]
        rec["k_names"] = list(named)
        rec["k_loss"] = metrics["loss"].detach().clone()
        rec["k_batch"] = {n: v.clone() for n, v in batch.items()}
        rec["k_change"] = torch.stack(torch._foreach_norm(
            torch._foreach_sub(ps, [b[0] for b in before])))
        rec["k_grad"] = torch.stack(torch._foreach_norm(torch._foreach_sub(
            ms, torch._foreach_mul([b[1] for b in before], b1)))) / (1 - b1)

    def window_moves(self, rec):
        """Once the window has closed: each leaf's change over the whole
        window (from the end of set-up), as norms."""
        named = dict(self.state.model.named_parameters())
        moved = torch._foreach_norm(torch._foreach_sub(
            [p.detach() for p in named.values()], rec.pop("open")))
        rec["window_moves"] = dict(zip(named, torch.stack(moved).tolist()))

    def release(self):
        self.state = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def _device_batch(self, b):
        return tuple(torch.as_tensor(np.asarray(b[k]), device=self.ctx.device)
                     for k in ("input_ids", "attention_mask", "labels"))

    def check(self, rec, variant: str = "program"):
        """The compared numbers of rec (the program's, or a variant's
        computed here by the reference in its place): the first
        check_steps steps from the seed's weights, and step k from the
        program's weights and moments before it."""
        steps, k = self.tr["check_steps"], self.k
        rec = dict(rec, k_batch={n: v.cpu().numpy()
                                 for n, v in rec["k_batch"].items()})
        w0 = self.weights()
        opt = self.tr["optimizer"]
        w_k = {n: b[0] for n, b in rec["before"].items()}
        moments = {n: (b[1], b[2]) for n, b in rec["before"].items()}

        def follow(collated, rnd=None, half=False):
            """The reference over collated batches (the first steps', then
            step k's)."""
            cut = ((lambda b: tuple(t[:t.shape[0] // 2] for t in b))
                   if half else (lambda b: b))
            bs = [cut(self._device_batch(b)) for b in collated]
            first = reference_steps(
                w0, self.cfg, self.head, opt, bs[:-1], list(range(steps)),
                self.dropout_seed, rnd)
            window = reference_steps(
                w_k, self.cfg, self.head, opt, bs[-1:], [k - 1],
                self.dropout_seed, rnd, moments=moments, count0=k - 1)
            return first, window

        collated = rec["batches"] + [rec["k_batch"]]
        ref, ref_k = follow(collated)
        if variant == "program":
            got = (rec["losses"], rec["grad1"], rec["change"])
            got_k = ([float(rec["k_loss"])],
                     dict(zip(rec["k_names"], rec["k_grad"].tolist())),
                     dict(zip(rec["k_names"], rec["k_change"].tolist())))
        elif variant == "control_fp8":
            from portbench.reference.bert import fp8_e4m3

            got, got_k = follow(collated, rnd=fp8_e4m3)
        elif variant == "fault_half":
            got, got_k = follow(collated, half=True)
        elif variant == "fault_token":
            # one token of each batch altered where the collator produced
            # it: the steps and the collation check see it
            def alter(b):
                b = {n: np.array(v) for n, v in b.items()}
                b["input_ids"][0, 1] = (b["input_ids"][0, 1] + 1) % (
                    self.cfg["vocab_size"])
                return b

            collated = [alter(b) for b in collated]
            got, got_k = follow(collated)
        else:
            raise ValueError(variant)
        med = float(np.median(list(ref[1].values())))
        keep = [n for n, g in ref[1].items()
                if g >= self.tr["keep_ratio"] * med]
        med_k = float(np.median(list(ref_k[1].values())))
        keep_k = [n for n, g in ref_k[1].items()
                  if g >= self.tr["keep_ratio"] * med_k]
        return {
            "loss_gap": compare.rel_gap(got[0], ref[0]),
            "grad_gap": compare.norm_gap(got[1], ref[1], keep),
            "change_gap": compare.norm_gap(got[2], ref[2], keep),
            "window_loss_gap": compare.rel_gap(got_k[0], ref_k[0]),
            "window_grad_gap": compare.norm_gap(got_k[1], ref_k[1], keep_k),
            "window_change_gap": compare.norm_gap(got_k[2], ref_k[2],
                                                  keep_k),
            "window_unmoved_leaves": float(sum(
                not rec["window_moves"][n] > 0 for n in keep_k)),
            "collate_bad_rows": float(sum(
                bad_rows(b, self.corpus, self.tr["mlm_probability"])
                for b in collated)),
            "window_step": k - steps,
            "leaves_left_out": sorted(set(ref[1]) - set(keep)),
            "worst_leaves": [max(g, key=g.get) for g in (
                compare.leaf_gaps(got[1], ref[1], keep),
                compare.leaf_gaps(got[2], ref[2], keep),
                compare.leaf_gaps(got_k[1], ref_k[1], keep_k),
                compare.leaf_gaps(got_k[2], ref_k[2], keep_k))],
        }


def _record():
    return {"losses": [], "batches": [], "grad1": {}, "change": {}}


def run(ctx) -> Outcome:
    tr = ctx.traffic
    s = Session(ctx)
    rec = _record()
    first = tr["check_steps"]
    win = {"open": False, "steps": 0}

    def on_step(state, metrics, batch):
        if win["open"]:
            win["steps"] += 1
        else:
            s.setup_numbers(state, metrics, batch, rec)
        s.window_numbers(state, metrics, batch, rec)
        if state.step == first:
            win["open"] = True
            ctx.begin_window(PROBES)

    # the window closes once --seconds have passed and step k was fed
    s.train(on_step, lambda: win["open"] and ctx.window_over()
            and len(s.label_counts) >= s.k)
    n = win["steps"]
    cfg = ctx.config
    spans = 2 * tr["docs_per_batch"]
    # the head's and the late loss's rows: twice a batch's labels
    flops = sum(roofline.coco_step_flops(
        cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"],
        cfg["num_hidden_layers"], tr["n_head_layers"], spans,
        tr["max_seq_length"], 2 * labels)
        for labels in s.label_counts[first:first + n])
    ctx.end_window(counts={"steps": n, "useful_flops": flops})
    s.window_moves(rec)
    s.release()
    got = s.check(rec)
    lim = ctx.limits
    return Outcome(
        e2e={"train_tokens_per_s": n * spans * tr["max_seq_length"]
             / ctx.window_s},
        checks=[(k, got[k], lim[k]) for k in NUMBERS if k in lim],
        attempted=n)


def readings(ctx, variant: str) -> dict:
    """The compared numbers of the first check_steps steps and of the
    window step k at the cell's sizes, the program run through step k
    without a window: 'program', or the reference in the program's place
    as 'control_fp8' (float8 e4m3), 'fault_half' (half of each batch left
    out) or 'fault_token' (one token of each batch altered)."""
    s = Session(ctx)
    steps = ctx.traffic["check_steps"]
    rec = _record()

    def on_step(state, metrics, batch):
        if state.step <= steps:
            s.setup_numbers(state, metrics, batch, rec)
        s.window_numbers(state, metrics, batch, rec)

    s.train(on_step, lambda: len(s.label_counts) >= s.k)
    s.window_moves(rec)
    s.release()
    return s.check(rec, variant)
