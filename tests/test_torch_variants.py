"""The port's model variants against the JAX package on the CPU, float32:
RoBERTa (its configs, its position ids, on records padded with 0 too), the
tanh pooler, and the DPR two-tower model through its towers, the 'nll'
trajectory under run_warmup, the two-tower iDRO step (the JAX package's
lane step), `load_jax_train_state`, checkpoints and RetrievalService.
Tolerances: 2e-5 in a forward, 1e-5 in trajectories (losses, params,
h_fun): float32 sums in another order."""
import dataclasses
import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.losses import DroConfig as JaxDroConfig
from cocodr_tpu.losses import idro_init as jax_idro_init
from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.bert import BertModel as JaxBertModel
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu.models.hf import bert_params_from_torch
from cocodr_tpu.models.hf import config_from_hf as jax_config_from_hf
from cocodr_tpu.optim import lamb as jax_lamb
from cocodr_tpu.optim import warmup_linear as jax_warmup_linear
from cocodr_tpu.pipelines import warmup as jax_warmup
from cocodr_tpu.pipelines.serve import RetrievalService as JaxService
from cocodr_tpu.pipelines.serve import ServeConfig as JaxServeConfig
from cocodr_tpu.pipelines.train_step import TrainStepConfig as JaxStepConfig
from cocodr_tpu.pipelines.train_step import build_train_step as jax_step
from cocodr_tpu.utils.train_state import TrainState as JaxTrainState
from cocodr_tpu_torch.losses.dro import DroConfig, idro_init
from cocodr_tpu_torch.models import convert, hf
from cocodr_tpu_torch.models.bert import BertConfig, BertModel
from cocodr_tpu_torch.models.bert import position_ids_for
from cocodr_tpu_torch.models.dual_encoder import MODEL_REGISTRY, DualEncoder
from cocodr_tpu_torch.optim import Lamb, warmup_linear
from cocodr_tpu_torch.pipelines import train_step as ts
from cocodr_tpu_torch.pipelines import warmup
from cocodr_tpu_torch.pipelines.serve import RetrievalService, ServeConfig
from cocodr_tpu_torch.utils import train_state as tstate

transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)

FWD = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-5, atol=1e-5)
G, B, SQ, SD, VOCAB = 4, 8, 6, 12, 128
LR, WARMUP, TOTAL = 1e-3, 2, 10


def tiny_roberta(**kw):
    """JAX and port configs of a 2-layer RoBERTa at the tiny widths."""
    rob = dict(position_style="roberta", pad_token_id=1, type_vocab_size=1,
               layer_norm_eps=1e-5, max_position_embeddings=40)
    return (dataclasses.replace(JaxBertConfig.tiny(**kw), **rob),
            dataclasses.replace(BertConfig.tiny(**kw), **rob))


@pytest.fixture(scope="module")
def hf_roberta():
    torch.manual_seed(0)
    cfg = transformers.RobertaConfig(
        vocab_size=101, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=40, type_vocab_size=1,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        pad_token_id=1)
    return transformers.RobertaModel(cfg, add_pooling_layer=False).eval()


def port_backbone(cfg, hf_state, with_pooler=False):
    """A port BertModel holding a HuggingFace backbone's weights (the
    port's names are HuggingFace's)."""
    model = BertModel(cfg, with_pooler=with_pooler).eval()
    sd = model.state_dict()
    model.load_state_dict({k: hf_state[k].float() for k in sd})
    return model


@pytest.mark.parametrize("name", ["roberta_base", "roberta_large"])
def test_roberta_configs_equal_jax(name):
    """Every field the two BertConfigs share is equal: vocab 50,265, 514
    positions, one token type, eps 1e-5, pad 1, roberta positions."""
    want = getattr(JaxBertConfig, name)()
    got = getattr(BertConfig, name)()
    shared = ({f.name for f in dataclasses.fields(got)}
              & {f.name for f in dataclasses.fields(want)}) - {"dtype"}
    assert len(shared) >= 17
    for f in shared:
        assert getattr(got, f) == getattr(want, f), f
    assert (got.vocab_size, got.max_position_embeddings, got.pad_token_id,
            got.layer_norm_eps, got.position_style) == (
        50265, 514, 1, 1e-5, "roberta")


def test_roberta_forward_matches_flax_and_hf(hf_roberta):
    """tests/test_roberta_parity.py's case (ids padded with the pad id 1):
    the port's last hidden state equals flax's (2e-5) and HuggingFace's
    RobertaModel's (that test's 3e-5 / 1e-4, HF's own float32 sums)."""
    jcfg = jax_config_from_hf(hf_roberta.config)
    cfg = hf.config_from_hf(hf_roberta.config)
    assert cfg.position_style == "roberta" and cfg.pad_token_id == 1
    rng = np.random.RandomState(1)
    ids = rng.randint(4, 101, size=(3, 10)).astype(np.int32)
    ids[0, 7:] = 1
    mask = (ids != 1).astype(np.int32)
    params = bert_params_from_torch(hf_roberta.state_dict(), jcfg)
    want, _, _ = JaxBertModel(jcfg).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    model = port_backbone(cfg, hf_roberta.state_dict())
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        ref = hf_roberta(input_ids=torch.from_numpy(ids).long(),
                         attention_mask=torch.from_numpy(mask).long()
                         ).last_hidden_state
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=3e-5,
                               rtol=1e-4)


def test_roberta_positions_on_records_padded_with_zero():
    """Records pad with 0, RoBERTa's <s>, not its pad id 1: the JAX rule
    gives the padded slots positions past the record's length, up to
    S + 1 (here 39 of 40 positions, 513 of 514 at S = 512). The port
    gives the same ids and the same masked forward as flax; positions
    from arange (the BERT rule) give another forward."""
    jcfg, cfg = tiny_roberta()
    S = cfg.max_position_embeddings - 2
    rng = np.random.RandomState(2)
    lens = np.array([S, 5, 17])
    ids = rng.randint(3, VOCAB, size=(3, S)).astype(np.int32)
    ids[:, 0] = 0  # <s>
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    ids = ids * mask  # the records' padding
    ids[1, 2] = 1  # one real pad id inside a record
    pos = position_ids_for(torch.from_numpy(ids).long(), cfg).numpy()
    not_pad = (ids != 1).astype(np.int64)
    np.testing.assert_array_equal(pos, np.cumsum(not_pad, 1) * not_pad + 1)
    assert pos.max() == S + 1 < cfg.max_position_embeddings
    assert pos[1, 2] == 1 and pos[1, -1] == S  # padded slots count on
    params = JaxBertModel(jcfg).init(jax.random.PRNGKey(0),
                                     jnp.asarray(ids), jnp.asarray(mask))
    want, _, _ = JaxBertModel(jcfg).apply(params, jnp.asarray(ids),
                                          jnp.asarray(mask))
    model = BertModel(cfg).eval()
    model.load_state_dict(convert.bert_state_dict_from_jax(
        jax.device_get(params["params"]), cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        bert_rule = BertModel(dataclasses.replace(cfg, position_style="bert"))
        bert_rule.load_state_dict(model.state_dict())
        wrong = bert_rule.eval()(torch.from_numpy(ids).long(),
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    assert np.abs(wrong.numpy() - np.asarray(want)).max() > 1e-2


def test_pooler_matches_flax_and_hf():
    """tests/test_bert_parity.py:60-88's case (token types, padding): the
    pooled output and the hidden states of a BertModel built with_pooler
    equal flax's BertModel(with_pooler=True) (2e-5) and HuggingFace's
    pooler_output (that test's 2e-5 / 1e-4); a model without a pooler
    returns the last hidden state alone, as before."""
    torch.manual_seed(0)
    hcfg = transformers.BertConfig(
        vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    hmodel = transformers.BertModel(hcfg).eval()
    cfg = hf.config_from_hf(hcfg.to_dict())
    jcfg = JaxBertConfig.tiny()
    rng = np.random.RandomState(0)
    Bn, S = 3, 12
    ids = rng.randint(1, VOCAB, size=(Bn, S)).astype(np.int32)
    mask = np.ones((Bn, S), np.int32)
    mask[0, S // 2:] = 0
    mask[2, 3:] = 0
    types = np.zeros((Bn, S), np.int32)
    types[:, S // 2:] = 1
    params = bert_params_from_torch(hmodel.state_dict(), jcfg)
    last_j, hidden_j, pooled_j = JaxBertModel(jcfg, with_pooler=True).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(types), output_hidden_states=True)
    model = port_backbone(cfg, hmodel.state_dict(), with_pooler=True)
    t = [torch.from_numpy(a).long() for a in (ids, mask, types)]
    with torch.no_grad():
        last, pooled = model(*t)
        last2, hidden, pooled2 = model(*t, output_hidden_states=True)
        ref = hmodel(input_ids=t[0], attention_mask=t[1], token_type_ids=t[2])
        plain = port_backbone(cfg, hmodel.state_dict())(*t)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(pooled_j), **FWD)
    np.testing.assert_allclose(last.numpy(), np.asarray(last_j), **FWD)
    for i, h in enumerate(hidden):
        np.testing.assert_allclose(h.numpy(), np.asarray(hidden_j[i]), **FWD)
    assert torch.equal(pooled, pooled2) and torch.equal(last, last2)
    assert torch.equal(plain, last)
    np.testing.assert_allclose(pooled.numpy(), ref.pooler_output.numpy(),
                               atol=2e-5, rtol=1e-4)


def jax_dpr(seed=0, jcfg=None):
    """The JAX DPR model and params with both towers and poolers."""
    jmodel = jax_build("dpr", jcfg or JaxBertConfig.tiny())
    ones = jnp.ones((2, SD), jnp.int32)
    params = jmodel.init(
        jax.random.PRNGKey(seed), ones, ones,
        method=lambda m, i, a: (m.query_emb(i, a), m.body_emb(i, a)),
    )["params"]
    return jmodel, params


def port_model(model_type, params, bert=None, **kw):
    cfg = MODEL_REGISTRY[model_type](bert or BertConfig.tiny(), **kw)
    model = DualEncoder(cfg)
    model.load_state_dict(convert.params_from_jax(jax.device_get(params),
                                                  cfg))
    return model, cfg


def test_dpr_towers_match_flax():
    """query_emb runs `encoder` and its pooler, body_emb `doc_encoder` and
    its own: each equals flax's (2e-5), the two towers differ, and the
    state dict holds both towers' poolers and no head."""
    jmodel, params = jax_dpr()
    model, cfg = port_model("dpr", params)
    assert cfg.two_tower and cfg.pooling == "pooler" and not cfg.use_head
    names = set(model.state_dict())
    assert {"encoder.pooler.dense.weight",
            "doc_encoder.pooler.dense.weight"} <= names
    assert not any(n.startswith(("head.", "doc_head.")) for n in names)
    rng = np.random.RandomState(4)
    ids = rng.randint(1, VOCAB, size=(3, SD)).astype(np.int32)
    mask = (np.arange(SD)[None, :] < np.array([[SD], [5], [9]])).astype(
        np.int32)
    t = (torch.from_numpy(ids * mask).long(), torch.from_numpy(mask))
    outs = {}
    for tower in ("query_emb", "body_emb"):
        want = jmodel.apply({"params": params}, jnp.asarray(ids * mask),
                            jnp.asarray(mask), method=getattr(jmodel, tower))
        with torch.no_grad():
            outs[tower] = getattr(model.eval(), tower)(*t)
        assert outs[tower].shape == (3, 32)
        np.testing.assert_allclose(outs[tower].numpy(), np.asarray(want),
                                   **FWD)
    assert (outs["query_emb"] - outs["body_emb"]).abs().max() > 1e-3


def batches(n, seed=0, groups=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = {}
        for k, S in (("q", SQ), ("pos", SD), ("neg", SD)):
            ids = rng.randint(1, VOCAB, size=(B, S)).astype(np.int32)
            lens = rng.randint(S // 2, S + 1, size=B)
            mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
            b[f"{k}_ids"], b[f"{k}_mask"] = ids * mask, mask
        if groups:
            b["groups"] = rng.randint(0, G, size=B).astype(np.int32)
        out.append(b)
    return out


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def assert_params_match(jax_params, model, cfg, **tol):
    want = convert.params_from_jax(jax.device_get(jax_params), cfg)
    got = model.state_dict()
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   **(tol or TOL), err_msg=name)


def states(model_type, kind, params, jmodel, dro=False, **step_kw):
    """(JAX state and step, port state and step) on the same weights."""
    tx = jax_lamb(jax_warmup_linear(LR, WARMUP, TOTAL), eps=1e-6)
    extra = jax_idro_init(JaxDroConfig(n_groups=G)) if dro else None
    jstate = JaxTrainState.create(params, tx, extra=extra)
    jstep = jax_step(jmodel, tx, JaxStepConfig(
        loss_kind=kind, dro=JaxDroConfig(n_groups=G) if dro else None,
        **step_kw))
    model, cfg = port_model(model_type, params)
    state = tstate.TrainState(
        model, Lamb(model.parameters(), warmup_linear(LR, WARMUP, TOTAL),
                    eps=1e-6),
        extra=idro_init(DroConfig(n_groups=G), device="cpu") if dro else None)
    step = ts.build_train_step(ts.TrainStepConfig(
        loss_kind=kind, dro=DroConfig(n_groups=G) if dro else None,
        **step_kw))
    return jstate, jstep, state, step, cfg


class WordHashTokenizer:
    """The HuggingFace call signature: [CLS]=1, words hashed into 5..127,
    [SEP]=2, padding 0."""

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


def test_dpr_run_warmup_matches_jax_steps(tmp_path):
    """run_warmup trains the DPR model 4 steps (dropout off) over a triples
    file: the logged losses equal the JAX 'nll' step's over the JAX
    batcher's batches (1e-5), the params of both towers and both poolers
    1e-4 (tests/test_torch_warmup.py's bound: LAMB divides each moment
    by its own root), and they moved."""
    rng = np.random.RandomState(1)
    words = [f"w{i}" for i in range(300)]
    path = tmp_path / "t.tsv"
    path.write_text("".join(
        "\t".join(" ".join(rng.choice(words, rng.randint(2, 14)))
                  for _ in range(3)) + "\n" for _ in range(4 * B)))
    jmodel, params = jax_dpr(seed=3)
    jstate, jstep, state, step, cfg = states("dpr", "nll", params, jmodel)
    tok = WordHashTokenizer()
    batcher = jax_warmup.TripleTextBatcher(tok, SD)
    triples = list(jax_warmup.stream_triples(str(path)))
    j_losses = []
    for i in range(4):
        jstate, m = jstep(jstate, to_jax(
            batcher.collate(triples[i * B:(i + 1) * B])))
        j_losses.append(float(m["loss"]))
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    logged = {}
    warmup.run_warmup(
        state, step, str(path), tok,
        warmup.WarmupConfig(max_seq_len=SD, batch_size=B, num_epochs=1,
                            save_steps=0, max_steps=4, log_every=1),
        str(tmp_path / "ck"), log_fn=lambda s, m: logged.__setitem__(
            s, m["loss"]), dropout_seed=None)
    np.testing.assert_allclose([logged[s] for s in range(1, 5)], j_losses,
                               **TOL)
    assert_params_match(jstate.params, state.model, cfg, rtol=1e-4,
                        atol=1e-4)
    for tower in ("encoder", "doc_encoder"):
        k = f"{tower}.pooler.dense.weight"
        assert (state.model.state_dict()[k] - start[k]).abs().max() > 1e-4


@pytest.mark.parametrize("kind", ["nll", "dro-greedy", "idro"])
def test_dpr_every_parameter_gets_a_gradient(kind):
    """Every parameter of both towers and both poolers gets a gradient and
    LAMB moments from one step of each loss kind (the port's Lamb skips
    a None gradient, where optax would decay the moments)."""
    jmodel, params = jax_dpr()
    _, _, state, step, _ = states("dpr", kind, params, jmodel,
                                  dro=kind != "nll")
    step(state, to_torch(batches(1, groups=True)[0]))
    named = list(state.model.named_parameters())
    assert any(n.startswith("doc_encoder.pooler") for n, _ in named)
    for n, p in named:
        assert p.grad is not None, n
        assert state.optimizer.state[p], n


def test_two_tower_idro_matches_jax_lane_step(monkeypatch):
    """The JAX package sends a two-tower, pooler model to its lane step
    (bf16 group rows over both towers' last K layers); the port routes it
    the same way (`lane_group_pass`) and its group pass covers
    doc_encoder's last K layers too (`last_k_layers`). 3 steps at K = 1
    of 2: robust losses, group statistics, h_fun and the final params
    (1e-5). A group pass over the query tower alone (the JAX lane step's
    diff without diff["d"]) moves h_fun past ten times that bound."""
    jmodel, params = jax_dpr(seed=1)
    data = batches(3, seed=5, groups=True)
    jstate, jstep, state, step, cfg = states("dpr", "idro", params, jmodel,
                                             dro=True, idro_last_k_layers=1)
    assert ts.lane_group_pass(state.model, ts.TrainStepConfig())
    lk = ts.last_k_layers(state.model, 1)
    assert lk == (list(state.model.encoder.encoder.layer[-1].parameters())
                  + list(state.model.doc_encoder.encoder.layer[-1]
                         .parameters()))
    first_h = None
    for b in data:
        jstate, jm = jstep(jstate, to_jax(b))
        m = step(state, to_torch(b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **TOL)
        for k in ("group_losses", "group_counts"):
            np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                       **TOL)
        np.testing.assert_allclose(state.extra.h_fun.numpy(),
                                   np.asarray(jstate.extra.h_fun), **TOL)
        if first_h is None:
            first_h = np.asarray(jstate.extra.h_fun)
    assert_params_match(jstate.params, state.model, cfg)

    wrong = states("dpr", "idro", params, jmodel, dro=True,
                   idro_last_k_layers=1)[2]
    monkeypatch.setattr(ts, "last_k_layers", lambda model, k: [
        p for layer in model.encoder.encoder.layer[-k:]
        for p in layer.parameters()])
    step(wrong, to_torch(data[0]))
    assert np.abs(wrong.extra.h_fun.numpy() - first_h).max() > 10 * TOL["atol"]


def test_dpr_jax_state_carried_into_port_and_checkpointed(tmp_path):
    """JAX trains DPR 3 steps; `load_jax_train_state` carries both towers'
    params and LAMB moments into the port, which runs 2 more: losses and
    params equal JAX's own 5 steps (1e-5). A checkpoint of the port's
    state loads back into a fresh two-tower state, tensor for tensor."""
    jmodel, params = jax_dpr(seed=2)
    data = batches(5, seed=6)
    init, jstep, state, step, cfg = states("dpr", "nll", params, jmodel)
    full, losses = init, []
    for b in data:
        full, m = jstep(full, to_jax(b))
        losses.append(float(m["loss"]))
    half = init
    for b in data[:3]:
        half, _ = jstep(half, to_jax(b))
    convert.load_jax_train_state(state, jax.device_get(half), cfg)
    assert state.step == 3
    mu = convert.params_from_jax(jax.device_get(half.opt_state[0].mu), cfg)
    p = state.model.doc_encoder.pooler.dense.weight
    assert torch.equal(state.optimizer.state[p]["exp_avg"],
                       mu["doc_encoder.pooler.dense.weight"])
    got = [float(step(state, to_torch(b))[0]) for b in data[3:]]
    np.testing.assert_allclose(got, losses[3:], **TOL)
    assert_params_match(full.params, state.model, cfg)
    tstate.save_checkpoint(str(tmp_path), state)
    fresh, _, other, _, _ = states("dpr", "nll", jax_dpr(seed=9)[1], jmodel)
    tstate.load_checkpoint(tstate.latest_checkpoint(str(tmp_path)), other)
    assert other.step == 5
    for k, v in state.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k


def test_dpr_service_searches_with_the_query_tower():
    """RetrievalService over a DPR model embeds queries by the query tower
    (encoder and its pooler), as the JAX service does: the same external
    ids, scores 1e-3 (both score bf16 operands)."""
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]

    def tokenizer(texts, padding="max_length", truncation=True,
                  max_length=8, return_tensors="np"):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros_like(ids)
        for i, text in enumerate(texts):
            toks = [2] + [5 + words.index(w) for w in text.split()] + [3]
            ids[i, :len(toks)] = toks[:max_length]
            mask[i, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    jmodel, params = jax_dpr(seed=4, jcfg=dataclasses.replace(
        JaxBertConfig.tiny(), initializer_range=0.2))
    model, _ = port_model("dpr", params)
    rng = np.random.RandomState(0)
    corpus = rng.randn(200, 32).astype(np.float32)
    doc_ids = [f"d{i}" for i in range(200)]
    queries = [" ".join(words[(i + j) % 6] for j in range(1 + i % 4))
               for i in range(9)]
    jsvc = JaxService(jmodel, params, tokenizer, corpus, doc_ids=doc_ids,
                      cfg=JaxServeConfig(top_k=5, max_query_len=8,
                                         max_batch=8))
    tsvc = RetrievalService(model, tokenizer, corpus, doc_ids=doc_ids,
                            cfg=ServeConfig(top_k=5, max_query_len=8,
                                            max_batch=8), device="cpu")
    jv, ji = jsvc.search(queries)
    tv, ti = tsvc.search(queries)
    assert ti == ji
    np.testing.assert_allclose(tv, jv, atol=1e-3, rtol=1e-3)
