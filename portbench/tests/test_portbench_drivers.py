"""Each driver's entry run on the CPU at tiny sizes against the reference:
sound runs come out correct, and runs with the timed path broken
underneath come out not correct, one fault at a time."""
import numpy as np
import pytest
import torch

from portbench.tests import helpers


def test_encode_is_correct():
    line = helpers.run_tiny("tiny.encode")
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0


def test_search_is_correct():
    line = helpers.run_tiny("tiny.search")
    assert line["correct"], line["checks"]
    assert line["checks"]["score_gap"]["value"] < 1e-6


def test_coco_is_correct():
    line = helpers.run_tiny("tiny.coco", seconds=0.5)
    assert line["correct"], line["checks"]
    assert line["checks"]["collate_bad_rows"]["value"] == 0


def _encode_half(monkeypatch):
    from cocodr_tpu_torch.pipelines.encode import Encoder

    real = Encoder.__call__

    def half(self, ids, mask):
        emb = real(self, ids, mask)
        return torch.cat([emb[:len(emb) // 2],
                          torch.zeros_like(emb[len(emb) // 2:])])

    monkeypatch.setattr(Encoder, "__call__", half)


def _encode_altered(monkeypatch):
    from cocodr_tpu_torch.pipelines.encode import Encoder

    real = Encoder.collect

    def altered(handle):
        out = real(handle).copy()
        out[:, 0] += 1.0  # every row's first element moved where produced
        return out

    monkeypatch.setattr(Encoder, "collect", staticmethod(altered))


def _search_half(monkeypatch):
    from cocodr_tpu_torch.parallel import topk

    real = topk.search_topk

    def half(queries, *a, **kw):
        v, i = real(queries, *a, **kw)
        v, i = v.copy(), i.copy()
        n = len(v) // 2
        v[n:], i[n:] = v[:len(v) - n], i[:len(v) - n]
        return v, i

    monkeypatch.setattr(topk, "search_topk", half)


def _search_altered(monkeypatch):
    from cocodr_tpu_torch.ops import mips_hier

    real = mips_hier.mips_topk_hierarchical

    def altered(*a, **kw):
        v, i = real(*a, **kw)
        i = i.clone()
        i[:, -1] = (i[:, -1] + 1) % 5000  # the last id of every answer
        return v, i

    monkeypatch.setattr(mips_hier, "mips_topk_hierarchical", altered)
    from cocodr_tpu_torch.ops import mips

    monkeypatch.setattr(mips, "mips_topk_hierarchical", altered)


def _coco_unchanged(monkeypatch):
    from cocodr_tpu_torch.pipelines import coco

    def no_update(state, max_grad_norm):
        state.step += 1  # the step counts, the state stays as it was

    monkeypatch.setattr(coco, "apply_gradients", no_update)


def _coco_half(monkeypatch):
    from cocodr_tpu_torch.pipelines import coco

    real = coco.build_coco_train_step

    def build(cfg):
        step = real(cfg)

        def half(state, batch, seed=None):
            n = batch["input_ids"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()}, seed)

        return half

    monkeypatch.setattr(coco, "build_coco_train_step", build)


def _coco_unchanged_in_window(monkeypatch):
    from cocodr_tpu_torch.pipelines import coco

    real = coco.apply_gradients

    def late(state, max_grad_norm):
        if state.step < 3:  # set-up's steps are sound
            return real(state, max_grad_norm)
        state.step += 1  # the window's steps leave the state as it was

    monkeypatch.setattr(coco, "apply_gradients", late)


def _coco_stale_in_window(monkeypatch):
    from cocodr_tpu_torch.pipelines import coco

    real = coco.build_coco_train_step

    def build(cfg):
        step = real(cfg)
        last = {}

        def stale(state, batch, seed=None):
            # from the window on, each step trains on the batch before
            use = last.get("batch", batch) if state.step >= 3 else batch
            last["batch"] = batch
            return step(state, use, seed)

        return stale

    monkeypatch.setattr(coco, "build_coco_train_step", build)


def _coco_token(monkeypatch):
    from cocodr_tpu_torch.data.coco_collator import CoCondenserCollator

    real = CoCondenserCollator.collate_spans

    def altered(self, docs):
        out = real(self, docs)
        out["input_ids"] = np.array(out["input_ids"])
        out["input_ids"][0, 1] += 1  # one token altered where produced
        return out

    monkeypatch.setattr(CoCondenserCollator, "collate_spans", altered)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.encode", _encode_half), ("tiny.encode", _encode_altered),
    ("tiny.search", _search_half), ("tiny.search", _search_altered),
    ("tiny.coco", _coco_unchanged), ("tiny.coco", _coco_half),
    ("tiny.coco", _coco_token), ("tiny.coco", _coco_unchanged_in_window),
    ("tiny.coco", _coco_stale_in_window),
], ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    line = helpers.run_tiny(cell, seconds=0.3)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell,variant", [
    ("tiny.encode", "control_fp8"), ("tiny.search", "control_int8"),
    ("tiny.coco", "control_fp8"), ("tiny.coco", "fault_half")])
def test_controls_read_above_the_sound_path(tmp_path, cell, variant):
    import portbench.harness as harness

    ctx = helpers.tiny_ctx(cell, tmp_path)
    driver = harness.load_driver(ctx.traffic["driver"])
    sound = driver.readings(helpers.tiny_ctx(cell, tmp_path), "program")
    control = driver.readings(ctx, variant)
    assert any(control[k] > 3 * sound[k] + 1e-9 for k in sound
               if k in ctx.limits), (sound, control)


def test_span_packing_is_coco_s():
    """Per document, the harness's packing gives the spans of the
    program's greedy_pack_spans: with no random break, and with a break
    before every sentence that fits."""
    from cocodr_tpu_torch.data.coco_collator import greedy_pack_spans

    from portbench.drivers.coco_train import pack

    rng = np.random.default_rng(3)
    lengths = rng.integers(1, 40, 60)
    doc = np.sort(rng.integers(0, 8, 60))
    for brk, prob in ((np.zeros(60, bool), 0.0), (np.ones(60, bool), 1.0)):
        tokens, owner = pack(lengths, doc, brk, 30)
        for d in np.unique(doc):
            sents = [[0] * n for n in lengths[doc == d]]
            want = [len(s) for s in greedy_pack_spans(sents, 30, prob)]
            got = [n for n, o in zip(tokens.tolist(), owner) if o == d]
            assert got == want, (d, got, want)


def test_every_seed_gets_the_same_corpus_sizes(tmp_path):
    """The ids differ from seed to seed; the documents' span lengths do
    not."""
    import json

    from portbench.drivers.coco_train import write_spans

    sizes = []
    for seed in (7, 2 ** 31 + 11):
        ctx = helpers.tiny_ctx("tiny.coco", tmp_path, seed=seed)
        path = tmp_path / f"spans{seed}.jsonl"
        write_spans(ctx, path)
        docs = [json.loads(line)["spans"] for line in open(path)]
        sizes.append(([[len(s) for s in d] for d in docs], docs))
    assert sizes[0][0] == sizes[1][0]
    assert sizes[0][1] != sizes[1][1]
    assert max(n for d in sizes[0][0] for n in d) <= 512
