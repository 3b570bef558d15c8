"""BM25 warmup: pipelines/warmup.py::run_warmup with the 'nll' train step of
pipelines/train_step.py over a triples file written from the seed,
tokenized by TripleTextBatcher on the prefetch thread with a stand-in
tokenizer.

NOT YET A CELL: BENCHMARK.json lists no `bert-base.warmup_train`, so no
check of the benchmark runs this driver, its reference
(reference/warmup.py), traffic/warmup_train.json or
limits/bert-base.warmup_train.json; portbench/tests runs them on the CPU
at tiny size. The step is host-bound on an H100 (144.6 ms of card time
against ~250 ms of host issue a step, ~9,500 launches; 71-74% idle
traced), and its rate spread 24.0% over six runs (94,412-126,287
tokens/s) against the 4% a new cell of train_tokens_per_s must meet. The
limits come from 21 program seeds against the float8 control: the
program's widest loss gap 0.0196, grad 0.0089, change 0.0141, window grad
0.0107, window change 0.0059; float8's least loss 0.083, grad 0.076,
window grad 0.079. List the cell once the step is bound by the card
(ROADMAP item 31.1).

One run_warmup call drives the state from the seed: its first
`check_steps` steps are set-up, then the window opens and the same call
trains until --seconds have passed and the compared window step k has
been taken; then its max_steps is set to that step, and the loop ends
there. No checkpoint is written (a saver that saves nothing) and no eval
runs. train_tokens_per_s is the positions the window's steps took in
(three texts of max_seq_len a triple) over its seconds.

What the check compares, once the window has closed (as
drivers/coco_train.py does for COCO):
- the first check_steps steps, which the float32 reference
  (reference/warmup.py) follows from the seed's weights with the same
  batches and dropout masks: each step's loss, the first clipped
  gradient, the weights' change;
- step k, drawn from the seed among the window's first
  window_check_steps: the reference takes the program's weights and LAMB
  moments from just before it and follows that one step (its loss, its
  clipped gradient as the optimizer got it, the weights' change);
- that every leaf the reference moves changed over the whole window;
- that every compared batch is the tokenization of the file's triples.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from portbench import program, roofline
from portbench.harness import Outcome, sub_seed
from portbench.reference import compare
from portbench.reference.warmup import reference_steps
from portbench.weights import bert_layout, draw

PROBES = {"K5": ("cocodr_tpu_torch.ops.ffn", "fused_ffn")}
NAMES = ("q_ids", "q_mask", "pos_ids", "pos_mask", "neg_ids", "neg_mask")
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "window_loss_gap",
           "window_grad_gap", "window_change_gap", "window_unmoved_leaves",
           "batch_bad_rows")


class IdTokenizer:
    """The batcher's tokenizer: a text is its token ids in decimal,
    separated by spaces; -> [CLS] ids [SEP], cut to max_length (the last
    slot [SEP]) and padded with [PAD] 0, with its attention mask (the
    HuggingFace call signature run_warmup uses)."""

    cls_id, sep_id = 101, 102

    def __call__(self, texts, padding="max_length", truncation=True,
                 max_length=128, return_tensors="np"):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for r, text in enumerate(texts):
            body = [int(t) for t in text.split()][:max_length - 2]
            row = [self.cls_id] + body + [self.sep_id]
            ids[r, :len(row)] = row
            mask[r, :len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class NoSave:
    """run_warmup's saver: writes nothing (no checkpoint in the cell)."""

    def save(self, *args, **kwargs):
        pass

    def wait(self):
        pass


def write_triples(ctx, path):
    """`triples` lines of query \\t positive \\t negative, each text the
    decimal ids of its tokens: a query of q_len tokens, uniform over
    [q_min, q_max], passages over [p_min, p_max] (counting [CLS] and
    [SEP]), ids drawn from the seed in [id_low, vocab) -> the texts'
    tokenized rows ({text: (ids, mask)} is rebuilt by `bad_rows`)."""
    tr, V = ctx.traffic, ctx.config["vocab_size"]
    rng = ctx.rng("triples")
    n = tr["triples"]
    q_len = rng.integers(tr["q_min"], tr["q_max"] + 1, n)
    p_len = rng.integers(tr["p_min"], tr["p_max"] + 1, (n, 2))
    texts = []
    with open(path, "w", encoding="utf8") as f:
        for i in range(n):
            parts = [" ".join(map(str, rng.integers(tr["id_low"], V, L - 2)))
                     for L in (q_len[i], *p_len[i])]
            texts.append(parts)
            f.write("\t".join(parts) + "\n")
    return texts, np.stack([q_len, p_len[:, 0], p_len[:, 1]], 1)


def bad_rows(batch, texts, first: int, width: int) -> int:
    """Rows of a batch (the triples first.. first + B - 1 of the file,
    cycling) that are not the tokenization of their triple's text at
    `width`."""
    tok = IdTokenizer()
    B = batch["q_ids"].shape[0]
    bad = 0
    for t, (ids, mask) in enumerate((("q_ids", "q_mask"),
                                     ("pos_ids", "pos_mask"),
                                     ("neg_ids", "neg_mask"))):
        want = tok([texts[(first + r) % len(texts)][t] for r in range(B)],
                   max_length=width)
        got_ids, got_mask = np.asarray(batch[ids]), np.asarray(batch[mask])
        bad += int(((got_ids != want["input_ids"]).any(1)
                    | (got_mask != want["attention_mask"]).any(1)).sum())
    return bad


class Session:
    """The triples file, the weights, (built on demand) the program's train
    state, and the compared window step `k`: a step number drawn from the
    seed among the window's first `window_check_steps`."""

    def __init__(self, ctx):
        tr, cfg = ctx.traffic, ctx.config
        self.ctx, self.tr, self.cfg = ctx, tr, cfg
        self.path = os.path.join(ctx.tmpdir, "triples.tsv")
        self.texts, self.lengths = write_triples(ctx, self.path)
        ctx.note("triples written")
        self.dropout_seed = (sub_seed(ctx.seed, "dropout") if tr["dropout"]
                             else None)
        self.layout = bert_layout(cfg, "encoder.")
        self.k = tr["check_steps"] + int(ctx.rng("window step").integers(
            1, tr["window_check_steps"] + 1))
        self.steps_taken = 0

    def weights(self):
        return draw(self.layout, self.ctx.gen("weights"),
                    self.cfg["initializer_range"], self.ctx.device)

    def train(self, on_step, stop):
        """run_warmup over the triples with on_step(state, loss, batch)
        after each step, until stop() is true after a step."""
        from cocodr_tpu_torch.core.configs import OptimizerConfig
        from cocodr_tpu_torch.pipelines.train_step import build_train_step
        from cocodr_tpu_torch.pipelines.warmup import WarmupConfig, run_warmup
        from cocodr_tpu_torch.utils.train_state import TrainState

        tr = self.tr
        opt = dict(tr["optimizer"])
        model = program.dual_encoder(self.cfg, self.weights())
        optimizer = OptimizerConfig(schedule="linear", **opt).build(
            model.parameters())
        self.state = TrainState(model, optimizer)
        step = build_train_step()
        wcfg = WarmupConfig(max_seq_len=tr["max_seq_len"],
                            batch_size=tr["batch"], num_epochs=1 << 30,
                            save_steps=0, log_every=1 << 30)
        self.ctx.note("train state built")

        def wrapped(state, batch, gens):
            loss, acc = step(state, batch, gens)
            self.steps_taken = state.step
            on_step(state, loss, batch)
            if stop():
                wcfg.max_steps = state.step
            return loss, acc

        run_warmup(self.state, wrapped, self.path, IdTokenizer(), wcfg,
                   os.path.join(self.ctx.tmpdir, "ckpt"), resume=False,
                   dropout_seed=self.dropout_seed, saver=NoSave())

    def setup_numbers(self, state, loss, batch, rec):
        """After each of the first check_steps steps: the loss, the batch,
        the first gradient's norms (LAMB's first moment after step 1 over
        1 - beta1) and, after the last, the weights' change."""
        k = state.step
        rec["losses"].append(float(loss))
        self.ctx.note(f"step {k} done")
        rec["batches"].append({n: batch[n].cpu().numpy() for n in NAMES})
        named = dict(state.model.named_parameters())
        if k == 1:
            opt = state.optimizer
            b1 = opt.param_groups[0]["betas"][0]
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

    def window_numbers(self, state, loss, batch, rec):
        """After each step: past step k - 1, a copy of the weights and the
        LAMB moments; past step k, its loss, its batch and, per leaf, the
        norms of its clipped gradient ((m_k - beta1 m_{k-1}) / (1 - beta1))
        and of the weights' change. Copies and norms stay on the card."""
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
        rec["k_loss"] = loss.detach().clone()
        rec["k_batch"] = {n: batch[n].clone() for n in NAMES}
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

    def _device_batch(self, b, half=False):
        out = {n: torch.as_tensor(np.asarray(b[n]), device=self.ctx.device)
               for n in NAMES}
        if half:
            out = {n: t[:t.shape[0] // 2] for n, t in out.items()}
        return out

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

        def follow(collated, rnd=None, half=False, drop_neg=False):
            """The reference over batches (the first steps', then step
            k's)."""
            bs = [self._device_batch(b, half) for b in collated]
            if drop_neg:  # each negative replaced by the batch's positive
                bs = [dict(b, neg_ids=b["pos_ids"], neg_mask=b["pos_mask"])
                      for b in bs]
            first = reference_steps(w0, self.cfg, opt, bs[:-1],
                                    list(range(steps)), self.dropout_seed,
                                    rnd)
            window = reference_steps(w_k, self.cfg, opt, bs[-1:], [k - 1],
                                     self.dropout_seed, rnd, moments=moments,
                                     count0=k - 1)
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
        elif variant == "fault_negative":
            got, got_k = follow(collated, drop_neg=True)
        else:
            raise ValueError(variant)
        med = float(np.median(list(ref[1].values())))
        keep = [n for n, g in ref[1].items()
                if g >= self.tr["keep_ratio"] * med]
        med_k = float(np.median(list(ref_k[1].values())))
        keep_k = [n for n, g in ref_k[1].items()
                  if g >= self.tr["keep_ratio"] * med_k]
        B = self.tr["batch"]
        firsts = [i * B for i in range(steps)] + [(k - 1) * B]
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
            "batch_bad_rows": float(sum(
                bad_rows(b, self.texts, f, self.tr["max_seq_len"])
                for b, f in zip(collated, firsts))),
            "window_step": k - steps,
            "leaves_left_out": sorted(set(ref[1]) - set(keep)),
            "worst_leaves": [max(g, key=g.get) for g in (
                compare.leaf_gaps(got[1], ref[1], keep),
                compare.leaf_gaps(got[2], ref[2], keep),
                compare.leaf_gaps(got_k[1], ref_k[1], keep_k),
                compare.leaf_gaps(got_k[2], ref_k[2], keep_k))],
        }

    def step_flops(self, step: int) -> int:
        """Step `step`'s useful operations (1-based): each text's encoder
        forward at its own length, three times for the forward and the
        backward."""
        B, n = self.tr["batch"], len(self.lengths)
        rows = (np.arange(B) + (step - 1) * B) % n
        cfg = self.cfg
        return 3 * int(roofline.encoder_forward_flops(
            self.lengths[rows].astype(np.int64), cfg["hidden_size"],
            cfg["intermediate_size"], cfg["num_hidden_layers"]).sum())


def _record():
    return {"losses": [], "batches": [], "grad1": {}, "change": {}}


def run(ctx) -> Outcome:
    tr = ctx.traffic
    s = Session(ctx)
    rec = _record()
    first = tr["check_steps"]
    win = {"open": False, "steps": 0}

    def on_step(state, loss, batch):
        if win["open"]:
            win["steps"] += 1
        else:
            s.setup_numbers(state, loss, batch, rec)
        s.window_numbers(state, loss, batch, rec)
        if state.step == first:
            win["open"] = True
            ctx.begin_window(PROBES)

    # the window closes once --seconds have passed and step k was taken
    s.train(on_step, lambda: win["open"] and ctx.window_over()
            and s.steps_taken >= s.k)
    n = win["steps"]
    flops = sum(s.step_flops(first + i + 1) for i in range(n))
    ctx.end_window(counts={"steps": n, "useful_flops": flops})
    s.window_moves(rec)
    s.release()
    got = s.check(rec)
    positions = 3 * tr["batch"] * tr["max_seq_len"]
    return Outcome(
        e2e={"train_tokens_per_s": n * positions / ctx.window_s},
        checks=[(k, got[k], ctx.limits[k]) for k in NUMBERS
                if k in ctx.limits],
        attempted=n)


def readings(ctx, variant: str) -> dict:
    """The compared numbers of the first check_steps steps and of the
    window step k at the cell's sizes, the program run through step k
    without a window: 'program', or the reference in the program's place
    as 'control_fp8' (float8 e4m3), 'fault_half' (half of each batch left
    out) or 'fault_negative' (each negative replaced by its positive)."""
    s = Session(ctx)
    steps = ctx.traffic["check_steps"]
    rec = _record()

    def on_step(state, loss, batch):
        if state.step <= steps:
            s.setup_numbers(state, loss, batch, rec)
        s.window_numbers(state, loss, batch, rec)

    s.train(on_step, lambda: s.steps_taken >= s.k)
    s.window_moves(rec)
    s.release()
    return s.check(rec, variant)
