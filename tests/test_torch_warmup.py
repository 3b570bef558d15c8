"""The port's BM25 warmup (pipelines/warmup.py, utils/train_state.py,
data/streams.py, models/convert.py::load_jax_train_state) against the JAX
package's, on the same triples file, tokenizer and weights: float32 on the
CPU, dropout off where the two are compared (their random bits cannot
match)."""
import functools
import json
import os
import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.data.streams import parse_triples_tsv_line as jax_parse
from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu.optim import lamb as jax_lamb
from cocodr_tpu.optim import warmup_linear as jax_warmup_linear
from cocodr_tpu.pipelines import warmup as jax_warmup
from cocodr_tpu.pipelines.train_step import TrainStepConfig as JaxStepConfig
from cocodr_tpu.pipelines.train_step import build_train_step as jax_step
from cocodr_tpu.utils.train_state import TrainState as JaxTrainState
from cocodr_tpu_torch.data.streams import parse_triples_tsv_line
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig
from cocodr_tpu_torch.models.dual_encoder import (
    MODEL_REGISTRY,
    DualEncoder,
    build_dual_encoder,
)
from cocodr_tpu_torch.optim import Lamb, warmup_linear
from cocodr_tpu_torch.pipelines import warmup
from cocodr_tpu_torch.pipelines.train_step import build_train_step
from cocodr_tpu_torch.utils import train_state as ts

torch.set_num_threads(1)

B, S = 8, 16  # batch and max_seq_len of every comparison here
LR, WARMUP, TOTAL = 1e-3, 2, 10
TOL = dict(rtol=1e-5, atol=1e-5)  # float32, sums in another order


class WordHashTokenizer:
    """Duck-typed tokenizer with the HuggingFace call signature: [CLS]=1,
    words hashed into 5..127, [SEP]=2, padding 0."""

    def __call__(self, texts, padding="max_length", truncation=True,
                 max_length=16, return_tensors="np"):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros_like(ids)
        for i, text in enumerate(texts):
            words = [5 + zlib.crc32(w.encode()) % 123 for w in text.split()]
            toks = [1] + words[:max_length - 2] + [2]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def write_triples(path, n, seed=0):
    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(300)]
    with open(path, "w", encoding="utf8") as f:
        for i in range(n):
            q, p, ng = (" ".join(rng.choice(words, rng.randint(2, 20)))
                        for _ in range(3))
            f.write(f"{q}\t{p}\t{ng}\n")
            if i == 3:
                f.write("a line without tabs\n")  # skipped by both
    return path


@functools.lru_cache(maxsize=None)
def jax_rdot_nll():
    """The JAX model, optimizer and jitted step, compiled once for B x S."""
    model = jax_build("rdot_nll", JaxBertConfig.tiny(), head_dim=16)
    tx = jax_lamb(jax_warmup_linear(LR, WARMUP, TOTAL), eps=1e-6)
    return model, tx, jax_step(model, tx, JaxStepConfig(max_grad_norm=1.0))


def jax_init(seed):
    model, tx, step = jax_rdot_nll()
    ids = jnp.ones((2, S), jnp.int32)
    params = model.init(jax.random.PRNGKey(seed), ids, ids)["params"]
    return JaxTrainState.create(params, tx), step


def port_state(jax_params=None):
    """A port TrainState on the JAX weights, or on BERT's init drawn from
    a fixed torch.Generator."""
    cfg = MODEL_REGISTRY["rdot_nll"](BertConfig.tiny(), head_dim=16)
    if jax_params is None:
        model = build_dual_encoder("rdot_nll", cfg.bert, device="cpu",
                                   generator=torch.Generator().manual_seed(5),
                                   head_dim=16)
    else:
        model = DualEncoder(cfg)
        model.load_state_dict(convert.params_from_jax(
            jax.device_get(jax_params), cfg))
    opt = Lamb(model.parameters(), warmup_linear(LR, WARMUP, TOTAL),
               eps=1e-6)
    return ts.TrainState(model, opt), cfg


def assert_params_match(jax_params, model, cfg):
    want = convert.params_from_jax(jax.device_get(jax_params), cfg)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)


def test_parse_triples_line_matches_jax():
    for line in ("q one\tp two\tn three\n", "q\tp\tn\textra\tfields",
                 "q\tp\tn"):
        assert parse_triples_tsv_line(line) == jax_parse(line)
    for bad in ("no tabs\n", "q\tp\n"):
        with pytest.raises(ValueError):
            jax_parse(bad)
        with pytest.raises(ValueError):
            parse_triples_tsv_line(bad)


@pytest.mark.parametrize("world", [1, 3])
def test_stream_triples_shards_by_line_like_jax(tmp_path, world):
    """Every rank's share of the lines (i % world == rank), malformed lines
    skipped, equal to the JAX stream's; the ranks cover the file."""
    path = write_triples(str(tmp_path / "t.tsv"), 11)
    seen = []
    for rank in range(world):
        got = list(warmup.stream_triples(path, rank, world))
        assert got == list(jax_warmup.stream_triples(path, rank, world))
        seen += got
    assert len(seen) == 11


def test_batcher_arrays_equal_jax(tmp_path):
    """TripleTextBatcher under one duck-typed tokenizer: the same int32
    arrays as the JAX batcher's, key for key."""
    path = write_triples(str(tmp_path / "t.tsv"), 5)
    triples = list(warmup.stream_triples(path))
    tok = WordHashTokenizer()
    got = warmup.TripleTextBatcher(tok, S).collate(triples)
    want = jax_warmup.TripleTextBatcher(tok, S).collate(triples)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_run_warmup_resumes_and_matches_jax_steps(tmp_path):
    """run_warmup 3 steps (save every step, keep 2), then a second call
    with resume to step 5: it loads checkpoint-3 and skips its 3 batches.
    The logged losses equal the JAX train step's over the same batches
    (collated by the JAX batcher), 1e-5; the final params agree to 1e-4
    (LAMB divides each moment by its own root, so a gradient element near
    zero turns float32 sums in another order into steps of another size).
    Checkpoints: DONE markers, pruned to the newest two, an unfinished
    directory ignored."""
    path = write_triples(str(tmp_path / "t.tsv"), 6 * B, seed=1)
    tok = WordHashTokenizer()
    jstate, jstep = jax_init(seed=3)
    state, cfg = port_state(jstate.params)
    batcher = jax_warmup.TripleTextBatcher(tok, S)
    triples = list(jax_warmup.stream_triples(path))
    j_losses = []
    for i in range(5):
        b = batcher.collate(triples[i * B:(i + 1) * B])
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        j_losses.append(float(m["loss"]))

    ckpt = str(tmp_path / "ckpt")
    logged = {}
    wcfg = warmup.WarmupConfig(max_seq_len=S, batch_size=B, num_epochs=1,
                               save_steps=1, max_steps=3, log_every=1,
                               keep_checkpoints=2)
    step = build_train_step()
    log = lambda s, m: logged.__setitem__(s, m["loss"])  # noqa: E731
    warmup.run_warmup(state, step, path, tok, wcfg, ckpt, log_fn=log,
                      dropout_seed=None)
    assert state.step == 3
    os.makedirs(os.path.join(ckpt, "checkpoint-9"))  # no DONE marker
    assert ts.latest_checkpoint(ckpt).endswith("checkpoint-3")

    fresh, _ = port_state(jax_init(seed=4)[0].params)  # other weights
    wcfg.max_steps = 5
    warmup.run_warmup(fresh, step, path, tok, wcfg, ckpt, log_fn=log,
                      dropout_seed=None)
    assert fresh.step == 5
    np.testing.assert_allclose([logged[s] for s in range(1, 6)], j_losses,
                               **TOL)
    want = convert.params_from_jax(jax.device_get(jstate.params), cfg)
    for name, p in fresh.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    assert [os.path.basename(p) for p in ts.list_checkpoints(ckpt)] == [
        "checkpoint-4", "checkpoint-5"]
    with open(os.path.join(ckpt, "checkpoint-5", ts.DONE_MARKER)) as f:
        assert json.load(f) == {"step": 5}


def test_jax_state_carried_into_port_continues_the_run():
    """JAX runs 5 steps; `load_jax_train_state` takes its TrainState
    (params, LAMB mu and nu split per layer, step, schedule count) into
    the port, which runs the other 5. Losses and final params equal JAX's
    own 10 steps, 1e-5."""
    rng = np.random.RandomState(11)
    data = []
    for _ in range(10):
        b = {}
        for k in ("q", "pos", "neg"):
            ids = rng.randint(1, 128, size=(B, S)).astype(np.int32)
            lens = rng.randint(S // 2, S + 1, size=B)
            mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
            b[f"{k}_ids"], b[f"{k}_mask"] = ids * mask, mask
        data.append(b)
    init, jstep = jax_init(seed=1)
    jstate, j_losses = init, []
    for b in data:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        j_losses.append(float(m["loss"]))
    half = init
    for b in data[:5]:
        half, _ = jstep(half, {k: jnp.asarray(v) for k, v in b.items()})
    state, cfg = port_state(init.params)
    convert.load_jax_train_state(state, jax.device_get(half), cfg)
    assert state.step == 5
    assert state.optimizer.param_groups[0]["count"] == 5
    step = build_train_step()
    losses = [float(step(state, {k: torch.from_numpy(v)
                                 for k, v in b.items()})[0])
              for b in data[5:]]
    np.testing.assert_allclose(losses, j_losses[5:], **TOL)
    assert_params_match(jstate.params, state.model, cfg)


def test_dropout_run_resumes_with_the_same_masks(tmp_path):
    """With dropout (seed 7) a run of 4 steps and a run of 2 steps resumed
    to 4 give the same losses and params bit for bit: each step's
    generators are seeded from (seed, step). Another seed gives other
    losses."""
    path = write_triples(str(tmp_path / "t.tsv"), 4 * B, seed=2)
    tok = WordHashTokenizer()
    step = build_train_step()

    def run(ckpt, stops, seed=7):
        state, _ = port_state()
        losses = {}
        for stop in stops:
            wcfg = warmup.WarmupConfig(max_seq_len=S, batch_size=B,
                                       num_epochs=1, save_steps=0,
                                       max_steps=stop, log_every=1)
            warmup.run_warmup(state, step, path, tok, wcfg,
                              str(tmp_path / ckpt),
                              log_fn=lambda s, m: losses.__setitem__(
                                  s, m["loss"]),
                              dropout_seed=seed)
        return losses, state.model.state_dict()

    straight, p1 = run("a", [4])
    resumed, p2 = run("b", [2, 4])
    assert straight == resumed
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
    other, _ = run("c", [4], seed=8)
    assert other[4] != straight[4]


def test_async_saver_is_not_ported_yet(tmp_path):
    state, _ = port_state()
    with pytest.raises(NotImplementedError, match="item 13"):
        warmup.run_warmup(state, build_train_step(), "unused", None,
                          warmup.WarmupConfig(), str(tmp_path),
                          saver=object())
