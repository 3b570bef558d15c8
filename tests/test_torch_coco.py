"""The port's COCO stage (data/coco_collator.py, data/coco_spans.py,
pipelines/coco.py, CocoStageConfig, optim/adamw.py, utils/train_state.py::
AsyncSaver) against the JAX package's: the data plane array for array from
the same seed, the steps against the JAX steps in float32 on the CPU with
dropout off (their random bits cannot match), and the grad cache, resume
and checkpoints of the port with dropout on."""
import dataclasses
import json
import os
import sys
import threading

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.core import configs as jax_configs
from cocodr_tpu.data import coco_collator as jax_collator
from cocodr_tpu.data import coco_spans as jax_spans
from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.condenser import CoCondenserForPretraining as JaxModel
from cocodr_tpu.pipelines import coco as jax_coco
from cocodr_tpu.utils.train_state import TrainState as JaxTrainState
from cocodr_tpu_torch.core import configs
from cocodr_tpu_torch.data import coco_collator, coco_spans
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig
from cocodr_tpu_torch.models.condenser import (
    CoCondenserForPretraining,
    build_condenser,
)
from cocodr_tpu_torch.optim import AdamW
from cocodr_tpu_torch.pipelines import coco
from cocodr_tpu_torch.utils import train_state as ts

transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)  # float32, sums in another order
HEADS, SKIP = 1, 1
WORDS = ("the quick brown fox jump ##s ##ed ##ing over lazy dog hello "
         "world run walk ##er talk sun moon star ##light sea")


@pytest.fixture()
def tokenizer(tmp_path):
    vocab = "[PAD] [UNK] [CLS] [SEP] [MASK] . ! ?".split() + WORDS.split()
    vp = tmp_path / "vocab.txt"
    vp.write_text("\n".join(vocab))
    return transformers.BertTokenizerFast(vocab_file=str(vp),
                                          do_lower_case=True)


def word_ids(tokenizer, rng, n):
    """n token ids of whole words and continuation pieces."""
    toks = [t for t in WORDS.split()]
    return tokenizer.convert_tokens_to_ids(list(rng.choice(toks, n)))


def assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --- the data plane ---------------------------------------------------------

@pytest.mark.parametrize("p,L", [(0.15, 16), (0.5, 12), (0.3, 6)])
def test_wwm_collator_arrays_equal_jax(tokenizer, p, L):
    """CondenserWWMCollator: the same arrays as the JAX collator from the
    same seed, over three batches with reseed(batch_index) between them
    (whole-word masks, the random-offset truncation at L = 6, the 80/10/10
    corruption)."""
    rng = np.random.default_rng(0)
    examples = [{"text": word_ids(tokenizer, rng, n)}
                for n in (3, 7, 11, 20, 1)]
    mine = coco_collator.CondenserWWMCollator(tokenizer, p, L, seed=5)
    theirs = jax_collator.CondenserWWMCollator(tokenizer, p, L, seed=5)
    for i in range(3):
        mine.reseed(i)
        theirs.reseed(i)
        assert_batches_equal(mine(examples), theirs(examples))
    assert_batches_equal(mine(examples), theirs(examples))  # no reseed


def test_wwm_collator_keeps_whole_words(tokenizer):
    """'jump' and '##s' masked together or not at all; labels only at
    masked positions, holding the original ids (tests/test_coco.py)."""
    coll = coco_collator.CondenserWWMCollator(tokenizer, 0.5, 12)
    ids = tokenizer.convert_tokens_to_ids(
        ["the", "quick", "jump", "##s", "over", "lazy", "dog"])
    batch = coll([{"text": ids}, {"text": ids}])
    assert batch["input_ids"].shape == batch["labels"].shape == (2, 12)
    jump, s = tokenizer.convert_tokens_to_ids(["jump", "##s"])
    for row in batch["labels"]:
        pos = set(row[row != -100].tolist())
        assert (jump in pos) == (s in pos)
    assert batch["attention_mask"][0].sum() == 9


def test_co_collator_pairs_equal_jax(tokenizer):
    """CoCondenserCollator.collate_spans: two spans a document (a lone
    span duplicated), rows equal to the JAX collator's."""
    rng = np.random.default_rng(1)
    docs = [{"spans": [word_ids(tokenizer, rng, 4)]},
            {"spans": [word_ids(tokenizer, rng, n) for n in (2, 5, 9)]},
            {"spans": [word_ids(tokenizer, rng, n) for n in (6, 3)]}]
    mine = coco_collator.CoCondenserCollator(tokenizer, max_seq_length=10)
    theirs = jax_collator.CoCondenserCollator(tokenizer, max_seq_length=10)
    got, want = mine.collate_spans(docs), theirs.collate_spans(docs)
    assert got["input_ids"].shape == (6, 10)
    assert_batches_equal(got, want)
    np.testing.assert_array_equal(got["attention_mask"][0],
                                  got["attention_mask"][1])


@pytest.mark.parametrize("target,brk", [(5, 0.0), (8, 0.3), (30, 0.1)])
def test_greedy_pack_spans_equal_jax(target, brk):
    import random

    rng = np.random.default_rng(2)
    sents = [list(range(i, i + rng.integers(1, 9))) for i in range(40)]
    got = coco_collator.greedy_pack_spans(sents, target, brk,
                                          random.Random(3))
    assert got == jax_collator.greedy_pack_spans(sents, target, brk,
                                                 random.Random(3))
    assert sum(map(len, got)) == sum(map(len, sents))


def write_corpus(path, n_docs=12, seed=0):
    """A BEIR-style corpus.jsonl: titles on some docs, sentences ending in
    . ! or ?, an empty doc."""
    rng = np.random.default_rng(seed)
    words = [w for w in WORDS.split() if not w.startswith("##")]
    with open(path, "w", encoding="utf8") as f:
        for i in range(n_docs):
            sents = [" ".join(rng.choice(words, rng.integers(2, 9)))
                     + rng.choice([".", "!", "?"])
                     for _ in range(rng.integers(1, 7))]
            doc = {"_id": str(i), "title": "Sun Moon" if i % 3 == 0 else "",
                   "text": "" if i == 5 else "  ".join(sents)}
            f.write(json.dumps(doc) + "\n")
    return path


def test_doc_to_spans_and_corpus_preprocessing_equal_jax(tmp_path, tokenizer,
                                                         monkeypatch):
    """The regex sentence split (nltk made unimportable, the path the card
    takes), doc_to_spans and preprocess_corpus_to_spans: the same spans
    and a byte-identical span file; COCO_CORPORA the JAX list."""
    import random

    monkeypatch.setitem(sys.modules, "nltk", None)
    text = "the fox ran!  over the dog. hello world? sun"
    assert coco_spans.split_sentences(text) == jax_spans.split_sentences(
        text) == ["the fox ran!", "over the dog.", "hello world?", "sun"]
    for brk in (0.0, 0.5):
        args = (text, tokenizer, 4, brk)
        assert coco_spans.doc_to_spans(*args, random.Random(1)) == \
            jax_spans.doc_to_spans(*args, random.Random(1))
    assert coco_spans.doc_to_spans("", tokenizer) == []
    corpus = write_corpus(tmp_path / "corpus.jsonl")
    n = coco_spans.preprocess_corpus_to_spans(
        str(corpus), str(tmp_path / "a.jsonl"), tokenizer, target_len=6,
        min_spans=1)
    m = jax_spans.preprocess_corpus_to_spans(
        str(corpus), str(tmp_path / "b.jsonl"), tokenizer, target_len=6,
        min_spans=1)
    assert n == m == 11  # the empty doc is dropped
    assert (tmp_path / "a.jsonl").read_bytes() == (
        tmp_path / "b.jsonl").read_bytes()
    assert coco_spans.COCO_CORPORA == jax_spans.COCO_CORPORA


def write_span_corpus(path, n_docs=16, seed=0):
    """The span corpus of tests/test_coco.py: 1-3 spans of 3-7 ids a doc."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(n_docs):
            spans = [[int(x) for x in
                      rng.randint(5, 17, size=rng.randint(3, 8))]
                     for _ in range(rng.randint(1, 4))]
            f.write(json.dumps({"spans": spans}) + "\n")
    return str(path)


@pytest.mark.parametrize("start", [0, 3, 7])
def test_span_batches_equal_jax_and_resume_from_start_batch(tmp_path,
                                                            tokenizer, start):
    """span_batches over two corpora, two epochs: the JAX stream's arrays
    batch for batch, and start_batch=N gives the uninterrupted stream's
    batches after N (per-batch keyed masks); count_span_batches counts
    them."""
    paths = [write_span_corpus(tmp_path / "a.jsonl"),
             write_span_corpus(tmp_path / "b.jsonl", n_docs=9, seed=1)]

    def stream(spans, collator, start_batch):
        coll = collator.CoCondenserCollator(tokenizer, mlm_probability=0.3,
                                            max_seq_length=12, seed=4)
        return list(spans.span_batches(paths, coll, 4, seed=2, num_epochs=2,
                                       start_batch=start_batch))

    full = stream(coco_spans, coco_collator, 0)
    assert len(full) == coco_spans.count_span_batches(paths, 4, 2) == \
        jax_spans.count_span_batches(paths, 4, 2) == 12
    got = stream(coco_spans, coco_collator, start)
    want = stream(jax_spans, jax_collator, start)
    assert len(got) == len(want) == 12 - start
    for a, b, c in zip(got, want, full[start:]):
        assert_batches_equal(a, b)
        assert_batches_equal(a, c)


# --- configuration and optimizer -------------------------------------------

@pytest.mark.parametrize("preset", ["base", "large"])
def test_coco_stage_presets_and_warmup_ratio_match_jax(preset):
    """Every field of CocoStageConfig and its OptimizerConfig equals the
    JAX preset's, the BERT widths too; warmup_steps_for: ratio x total,
    at least 1, and the optimizer's warmup_steps when the ratio is 0
    (tests/test_coco.py::test_warmup_ratio_to_steps)."""
    got = getattr(configs.CocoStageConfig, preset)()
    want = getattr(jax_configs.CocoStageConfig, preset)()
    assert dataclasses.asdict(got.optimizer) == dataclasses.asdict(
        want.optimizer)
    for f in dataclasses.fields(want):
        if f.name not in ("bert", "optimizer"):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    for f in ("hidden_size", "num_hidden_layers", "num_attention_heads",
              "intermediate_size", "vocab_size", "hidden_dropout_prob",
              "attention_probs_dropout_prob"):
        assert getattr(got.bert, f) == getattr(want.bert, f), f
    for total in (10_000, 5, 0, 37):
        assert got.warmup_steps_for(total) == want.warmup_steps_for(total)
    assert configs.CocoStageConfig.base().warmup_steps_for(10_000) == 1_000
    assert configs.CocoStageConfig.base().warmup_steps_for(5) == 1
    off = dataclasses.replace(got, warmup_ratio=0.0)
    assert off.warmup_steps_for(10_000) == off.optimizer.warmup_steps


@pytest.mark.parametrize("kw", [
    dict(lr=1e-3),
    dict(lr=optax.linear_schedule(0.0, 1e-2, 3), weight_decay=0.05, eps=1e-6),
])
def test_adamw_steps_match_optax(kw):
    """Six AdamW updates against optax.adamw's on the same parameters and
    gradients (random, of mixed scales): the defaults (eps 1e-8, decay
    1e-4) at a constant rate, and a warmup schedule with decay 0.05;
    parameters and moments 1e-6 relative (float32)."""
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.integers(-3, 2)).astype(
        np.float32) for s in shapes] for _ in range(6)]
    tx = optax.adamw(kw["lr"], **{k: v for k, v in kw.items() if k != "lr"})
    jp = [jnp.asarray(p) for p in p0]
    jstate = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    lr = kw["lr"]
    opt = AdamW(params, (lambda c: float(lr(c))) if callable(lr) else lr,
                **{k: v for k, v in kw.items() if k != "lr"})
    for g in grads:
        upd, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x)
        opt.step()
    for p, q in zip(params, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(q),
                                   rtol=1e-6, atol=1e-7)
    for p, m, v in zip(params, jstate[0].mu, jstate[0].nu):
        np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(),
                                   np.asarray(m), rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(opt.state[p]["exp_avg_sq"].numpy(),
                                   np.asarray(v), rtol=1e-6, atol=1e-12)
    assert opt.state_dict()["param_groups"][0]["count"] == 6


# --- the training step ------------------------------------------------------

B, S, CHUNK = 8, 12, 4


def step_batch(seed=0, unbalanced=True):
    """B spans of S tokens, ~30% labelled; the second chunk's labels wiped
    but for its last two columns, so the chunks' masked counts differ
    (tests/test_coco.py::test_grad_cache_matches_full_batch)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, 100, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[3, 9:] = 0
    labels = np.where(rng.rand(B, S) < 0.3, ids, -100).astype(np.int32)
    labels[mask == 0] = -100
    if unbalanced:
        labels[CHUNK:, :S - 2] = -100
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


def tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_stage(late_mlm=True):
    """A tiny JAX coCondenser without dropout (the JAX step always trains
    with deterministic=False) and its float32 params."""
    cfg = JaxBertConfig.tiny(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    model = JaxModel(cfg, n_head_layers=HEADS, skip_from=SKIP,
                     late_mlm=late_mlm)
    b = step_batch()
    params = model.init(jax.random.PRNGKey(0), b["input_ids"][:2],
                        b["attention_mask"][:2], b["labels"][:2])["params"]
    return model, params


def port_model(jax_params=None, late_mlm=True, seed=1):
    cfg = BertConfig.tiny()
    if jax_params is None:
        return build_condenser(cfg, "cpu", torch.Generator().manual_seed(seed),
                               n_head_layers=HEADS, skip_from=SKIP,
                               late_mlm=late_mlm)
    model = CoCondenserForPretraining(cfg, HEADS, SKIP, late_mlm)
    model.load_state_dict(convert.condenser_state_dict_from_jax(
        jax.device_get(jax_params), cfg, HEADS))
    return model


@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["direct", "grad_cache"])
def test_coco_steps_match_jax(chunk):
    """Three steps of the port's direct and grad-cache steps against the
    JAX build_coco_train_step from the same weights, dropout off: AdamW
    with a linear warmup and decay 0.01 built by both packages'
    OptimizerConfig, clipping at norm 1; each step's loss, mlm_loss and
    co_loss and the final parameters, float32, 1e-5 (the cache's chunked
    sums in another order)."""
    ocfg = dict(name="adamw", lr=1e-3, warmup_steps=2, total_steps=10,
                weight_decay=0.01)
    jmodel, params = jax_stage()
    tx = jax_configs.OptimizerConfig(**ocfg).build()
    ccfg = dict(cache_chunk_size=chunk, max_grad_norm=1.0)
    jstep = jax_coco.build_coco_train_step(
        jmodel, tx, jax_coco.CocoConfig(batch_size=B, **ccfg))
    jstate = JaxTrainState.create(params, tx)
    model = port_model(params)
    state = ts.TrainState(model, configs.OptimizerConfig(**ocfg).build(
        model.parameters()))
    step = coco.build_coco_train_step(coco.CocoConfig(**ccfg))
    for i in range(3):
        b = step_batch(seed=i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.PRNGKey(i))
        m = step(state, tensors(b))
        for k in ("loss", "mlm_loss", "co_loss"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), **TOL,
                                       err_msg=f"step {i} {k}")
    assert state.step == int(jstate.step) == 3
    want = convert.condenser_state_dict_from_jax(
        jax.device_get(jstate.params), model.cfg, HEADS)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)


class NoUpdate(torch.optim.Optimizer):
    """Leaves the parameters and their .grad as the step made them."""

    def __init__(self, params):
        super().__init__(params, {})

    def step(self, closure=None):
        pass


def step_grads(model, batch, chunk, seed):
    state = ts.TrainState(model, NoUpdate(model.parameters()))
    step = coco.build_coco_train_step(coco.CocoConfig(
        cache_chunk_size=chunk, max_grad_norm=0))
    metrics = step(state, tensors(batch), seed)
    return metrics, {k: p.grad for k, p in model.named_parameters()}


def test_grad_cache_equals_full_batch_gradient_with_dropout():
    """With dropout on (seed 7) and chunks of unequal masked counts, the
    cache step's gradient equals the full batch's: each chunk's
    token-weighted MLM loss and the contrastive loss over all the chunks'
    CLS, differentiated at once, every chunk drawing from the generator
    of (seed, step, chunk) (tests/test_coco.py:82, slow there). Float32,
    2e-5 absolute and 1e-4 relative: the cotangents reach the backbone
    through another sum order."""
    batch = step_batch()
    model = port_model(seed=3)
    ref = port_model(seed=3)
    metrics, got = step_grads(model, batch, CHUNK, 7)
    ref.train()
    t = tensors(batch)
    n_masked = (t["labels"] != -100).sum()
    total, cls = 0.0, []
    gens = [coco.coco_generator(7, 0, "cpu", c) for c in range(B // CHUNK)]
    for c, g in enumerate(gens):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        mlm, aux = ref(t["input_ids"][sl], t["attention_mask"][sl],
                       t["labels"][sl], generator=g)
        total = total + mlm * (t["labels"][sl] != -100).sum() / n_masked
        cls.append(aux["cls"])
    from cocodr_tpu_torch.losses.contrastive import co_contrastive_loss

    co = co_contrastive_loss(torch.cat(cls))
    (total + co).backward()
    np.testing.assert_allclose(metrics["loss"].item(), (total + co).item(),
                               rtol=1e-6)
    for name, p in ref.named_parameters():
        np.testing.assert_allclose(got[name].numpy(), p.grad.numpy(),
                                   rtol=1e-4, atol=2e-5, err_msg=name)
    # another dropout draw moves the gradient: the generators are in play
    _, other = step_grads(port_model(seed=3), batch, CHUNK, 8)
    name = "bert.encoder.layer.0.output.dense.weight"
    assert not torch.allclose(other[name], got[name])


def test_grad_cache_pass_two_replays_pass_one_cls_bit_for_bit():
    """Pass 2 starts each chunk's generator from the state pass 1 started
    from, and the backbone draws first, so every chunk's CLS in pass 2
    equals its pass-1 CLS bit for bit with dropout on; a pass 2 that went
    on from pass 1's generators would not."""
    model = port_model(seed=3)
    seen = {"cls_emb": [], "forward": []}
    cls_emb, forward = model.cls_emb, model.forward

    def rec_cls(*a, **k):
        out = cls_emb(*a, **k)
        seen["cls_emb"].append(out.detach().clone())
        return out

    def rec_fwd(*a, **k):
        loss, aux = forward(*a, **k)
        seen["forward"].append(aux["cls"].detach().clone())
        return loss, aux

    model.cls_emb, model.forward = rec_cls, rec_fwd
    step_grads(model, step_batch(), CHUNK, 7)
    assert len(seen["cls_emb"]) == len(seen["forward"]) == B // CHUNK
    for a, b in zip(seen["cls_emb"], seen["forward"]):
        assert torch.equal(a, b)
    # the generators after pass 1 draw other masks
    model = port_model(seed=3).train()
    t = tensors(step_batch())
    g = coco.coco_generator(7, 0, "cpu", 0)
    first = model.cls_emb(t["input_ids"][:CHUNK], t["attention_mask"][:CHUNK],
                          generator=g)
    again = model.cls_emb(t["input_ids"][:CHUNK], t["attention_mask"][:CHUNK],
                          generator=g)
    assert torch.equal(first, seen["cls_emb"][0])
    assert not torch.equal(first, again)


@pytest.mark.parametrize("late", [True, False], ids=["late_mlm", "no_late"])
@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["direct", "grad_cache"])
def test_every_parameter_gets_a_gradient(late, chunk):
    """The direct and the cache step reach every parameter of
    CoCondenserForPretraining, late_mlm on and off, so the port's Lamb
    (which skips a None gradient where optax decays the moments) updates
    every one, as optax does; nearly all gradients are nonzero."""
    model = port_model(late_mlm=late, seed=2)
    _, grads = step_grads(model, step_batch(), chunk, 5)
    missing = [k for k, g in grads.items() if g is None]
    assert not missing, missing
    zero = [k for k, g in grads.items() if not g.abs().sum() > 0]
    # a key projection's bias has a zero gradient (a softmax ignores a
    # constant added to its row)
    assert all(k.endswith("attention.self.key.bias") for k in zero), zero


def test_direct_step_draws_masks_from_seed_and_step():
    """The direct step's dropout generator comes from (seed, step): the
    same seed and step draw the same masks (equal losses), another step
    other ones; without a seed the model runs in eval mode."""
    batch = tensors(step_batch())
    out = []
    for seed, step_no in ((7, 0), (7, 0), (7, 1), (None, 0)):
        model = port_model(seed=4)
        state = ts.TrainState(model, NoUpdate(model.parameters()),
                              step=step_no)
        m = coco.build_coco_train_step(coco.CocoConfig())(
            state, batch, seed)
        out.append(m["loss"].item())
        assert model.training == (seed is not None)
    assert out[0] == out[1] != out[2] != out[3]


def test_cache_chunk_must_divide_the_batch():
    """A cache step raises on a batch its chunk does not divide (10 spans,
    chunks of 4) before it runs the model."""
    step = coco.build_coco_train_step(coco.CocoConfig(cache_chunk_size=4))
    batch = tensors(step_batch())
    batch = {k: torch.cat([v, v[:2]]) for k, v in batch.items()}
    state = ts.TrainState(port_model(seed=4), None)
    with pytest.raises(ValueError, match="not a multiple of the cache chunk"):
        step(state, batch)


# --- the loop, resume and checkpoints ----------------------------------------

def coco_run(tmp_path, tokenizer, ckpt, stop, start=0, saver=None,
             state=None):
    """run_coco_pretrain of a tiny model with dropout, AdamW(1e-3), batches
    of 4 docs from span_batches(start_batch=start), saving every 2 steps
    -> (state, the batches it trained on)."""
    sf = write_span_corpus(tmp_path / "spans.jsonl")
    collator = coco_collator.CoCondenserCollator(
        tokenizer, mlm_probability=0.3, max_seq_length=12)
    if state is None:
        model = port_model(seed=6)
        state = ts.TrainState(model, AdamW(model.parameters(), 1e-3))
    seen = []
    step = coco.build_coco_train_step(coco.CocoConfig())

    def recorded(st, batch, seed):
        seen.append({k: v.numpy().copy() for k, v in batch.items()})
        return step(st, batch, seed)

    batches = coco_spans.span_batches([sf], collator, docs_per_batch=4,
                                      num_epochs=3, start_batch=start)
    coco.run_coco_pretrain(state, recorded, batches, 7, max_steps=stop,
                           ckpt_dir=str(tmp_path / ckpt), save_steps=2,
                           saver=saver, keep_checkpoints=2)
    return state, seen


def test_killed_coco_run_resumes_bit_for_bit_through_async_saver(
        tmp_path, tokenizer):
    """A run to step 4 against one that stops at 2 (its checkpoints written
    by AsyncSaver) and a fresh process that loads checkpoint-2 and resumes
    through span_batches(start_batch=2): the same batches, parameters and
    optimizer moments bit for bit (tests/test_coco.py:221, slow there)."""
    full, seen_a = coco_run(tmp_path, tokenizer, "ck_a", 4)
    saver = ts.AsyncSaver()
    coco_run(tmp_path, tokenizer, "ck_b", 2, saver=saver)
    ck = ts.latest_checkpoint(str(tmp_path / "ck_b"))
    assert ck.endswith("checkpoint-2")
    model = port_model(seed=99)
    state = ts.TrainState(model, AdamW(model.parameters(), 1e-3))
    ts.load_checkpoint(ck, state)
    assert state.step == 2
    resumed, seen_b = coco_run(tmp_path, tokenizer, "ck_b", 4, start=2,
                               saver=saver, state=state)
    saver.close()
    assert resumed.step == full.step == 4
    assert len(seen_a) == 4 and len(seen_b) == 2
    for a, b in zip(seen_a[2:], seen_b):
        assert_batches_equal(a, b)
    for (k, a), b in zip(full.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    for p, q in zip(full.model.parameters(), resumed.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(full.optimizer.state[p][key],
                               resumed.optimizer.state[q][key])
    names = sorted(os.listdir(tmp_path / "ck_b"))
    assert names == ["checkpoint-2", "checkpoint-4"]


def test_run_coco_pretrain_logs_saves_and_names_what_waits(tmp_path,
                                                           tokenizer):
    """log_fn every log_every steps with float metrics; a save every
    save_steps and at the end, keep_checkpoints kept; device_put (which
    raised naming ROADMAP item 11 until the multi-device slice): a state
    of shard_train_init over a world of one process and its put_batch
    train to the same parameters bit for bit (the ranks at W = 2 and 4:
    tests/test_torch_sharded_train.py)."""
    sf = write_span_corpus(tmp_path / "spans.jsonl")
    collator = coco_collator.CoCondenserCollator(tokenizer,
                                                 max_seq_length=12)
    model = port_model(seed=6)
    state = ts.TrainState(model, AdamW(model.parameters(), 1e-3))
    logged = []
    coco.run_coco_pretrain(
        state, coco.build_coco_train_step(coco.CocoConfig()),
        coco_spans.span_batches([sf], collator, 4, num_epochs=2), None,
        max_steps=5, log_fn=lambda s, m: logged.append((s, sorted(m))),
        log_every=2, ckpt_dir=str(tmp_path / "ck"), save_steps=2,
        keep_checkpoints=2)
    assert state.step == 5
    assert logged == [(2, ["co_loss", "loss", "mlm_loss"]),
                      (4, ["co_loss", "loss", "mlm_loss"])]
    assert [os.path.basename(p) for p in ts.list_checkpoints(
        str(tmp_path / "ck"))] == ["checkpoint-4", "checkpoint-5"]
    from cocodr_tpu_torch.parallel.sharded_train import shard_train_init
    import torch_mesh_workers as workers

    model2 = port_model(seed=6)
    with workers.world_of_one() as mesh:
        dp, put = shard_train_init(mesh, model2,
                                   AdamW(model2.parameters(), 1e-3))
        coco.run_coco_pretrain(
            dp, coco.build_coco_train_step(coco.CocoConfig()),
            coco_spans.span_batches([sf], collator, 4, num_epochs=2), None,
            max_steps=5, device_put=put)
    assert dp.step == 5
    for a, b in zip(model2.parameters(), model.parameters()):
        assert torch.equal(a, b)


def small_state(seed=0):
    model = port_model(seed=seed)
    opt = AdamW(model.parameters(), 1e-3)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    return ts.TrainState(model, opt, step=3)


def test_async_saver_writes_what_save_checkpoint_writes(tmp_path):
    """The payload is a snapshot taken at save(): changing the model after
    it returns does not reach the checkpoint, which loads back equal to
    the synchronous save of the same state; the DONE marker exists before
    on_complete runs; at most one save in flight."""
    state = small_state()
    ts.save_checkpoint(str(tmp_path / "sync"), state)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    saver = ts.AsyncSaver()
    done_seen = []
    path = saver.save(str(tmp_path / "async"), state, on_complete=lambda: (
        done_seen.append(os.path.exists(os.path.join(path, "DONE")))))
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    saver.wait()
    assert done_seen == [True]
    for root in ("sync", "async"):
        check = small_state(seed=5)
        ts.load_checkpoint(ts.latest_checkpoint(str(tmp_path / root)), check)
        assert check.step == 3
        for k, v in check.model.state_dict().items():
            assert torch.equal(v, before[k]), (root, k)
    gate = threading.Event()
    saver.save(str(tmp_path / "two"), state, on_complete=gate.wait)
    state.step = 4
    threading.Timer(0.2, gate.set).start()
    saver.save(str(tmp_path / "two"), state)  # waits for the first
    saver.close()
    assert [os.path.basename(p) for p in ts.list_checkpoints(
        str(tmp_path / "two"))] == ["checkpoint-3", "checkpoint-4"]


def test_async_saver_raises_a_failed_commit_at_wait(tmp_path):
    saver = ts.AsyncSaver()

    def fail():
        raise OSError("disk full")

    saver.save(str(tmp_path), small_state(), on_complete=fail)
    with pytest.raises(RuntimeError, match="commit failed"):
        saver.wait()
    saver.wait()  # raised once


def test_train_loop_takes_the_saver(tmp_path):
    """train_loop(saver=AsyncSaver()) writes its ann-progress record after
    the checkpoint's DONE marker (run_warmup's saver: test_torch_warmup.py::
    test_async_saver_is_not_ported_yet)."""
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder
    from cocodr_tpu_torch.pipelines import ance

    order = []
    real_progress = ance._write_progress

    def progress(ckpt_dir, n):
        order.append(os.path.exists(os.path.join(
            ts.latest_checkpoint(ckpt_dir), "DONE")))
        real_progress(ckpt_dir, n)

    ann = tmp_path / "ann"
    ann.mkdir()
    (ann / "ann_training_data_0").write_text("")
    (ann / "ann_ndcg_0").write_text("{}")
    model = build_dual_encoder("rdot_nll_condenser", BertConfig.tiny(),
                               device="cpu")
    state = ts.TrainState(model, AdamW(model.parameters(), 1e-3))
    saver = ts.AsyncSaver()
    orig = ance.train_on_ann_file
    try:
        ance._write_progress = progress
        ance.train_on_ann_file = lambda state, *a, **k: (state, 0)
        ance.train_loop(state, None, None, str(ann), str(tmp_path / "ck"),
                        4, max_ann_files=1, saver=saver)
    finally:
        ance._write_progress = real_progress
        ance.train_on_ann_file = orig
    assert order == [True]
    assert ance._read_progress(str(tmp_path / "ck")) == 0


def test_chip_smoke_piece_tokenizer_feeds_the_whole_word_mask():
    """chip_smoke.PieceTokenizer, the card's stand-in: 1-3 pieces a word
    (a word-initial id, then `##` pieces), BERT's special ids, and the
    collator masks a word's pieces together."""
    import chip_smoke

    tok = chip_smoke.PieceTokenizer()
    text = " ".join(f"w{i}" for i in range(40))
    ids = tok.encode(text, add_special_tokens=False)
    toks = tok.convert_ids_to_tokens(ids)
    starts = [i for i, t in enumerate(toks) if not t.startswith("##")]
    assert len(starts) == 40 and 60 < len(ids) <= 126  # not truncated
    assert all(0 <= i < tok.vocab_size for i in ids)
    assert tok.encode("a b")[0] == tok.cls_token_id == 101
    assert tok.convert_ids_to_tokens([103, 0]) == ["[MASK]", "[PAD]"]
    coll = coco_collator.CondenserWWMCollator(tok, 0.3, 128, seed=1)
    batch = coll([{"text": ids}])
    masked = set(np.flatnonzero(batch["labels"][0] != -100) - 1)
    assert masked
    for s, e in zip(starts, starts[1:] + [len(ids)]):
        word = set(range(s, e))
        assert word <= masked or not (word & masked)


def test_chip_smoke_cache_bounds_pass_a_cache_and_fail_wrong_cotangents(
        monkeypatch):
    """chip_smoke.py's leg (c) bounds on the CPU (float32, dropout off):
    the cache step (2 chunks of 4) against the direct step from the same
    weights passes them; with each chunk given the next chunk's
    cotangents (chip_smoke.wrong_cache_cotangents) it fails them, and the
    plant is taken out after."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "COCO_CHUNK", CHUNK)
    bounds = (chip_smoke.COCO_CACHE_LOSS_RTOL,
              chip_smoke.COCO_CACHE_GLOBAL_COSINE,
              chip_smoke.COCO_CACHE_TENSOR_COSINE)
    model = port_model(seed=8)
    batch = tensors(step_batch())

    def run(chunk):
        return chip_smoke.coco_grads(model, batch, coco.CocoConfig(
            cache_chunk_size=chunk, max_grad_norm=0))

    direct, cache = run(0), run(CHUNK)
    _, ok = chip_smoke.coco_agreement("cache", cache, direct, bounds)
    assert ok
    real = coco.contrastive_cotangents
    remove = chip_smoke.wrong_cache_cotangents()
    try:
        planted = run(CHUNK)
    finally:
        remove()
    assert coco.contrastive_cotangents is real
    what, ok = chip_smoke.coco_agreement("planted", planted, direct, bounds)
    assert not ok, what
