"""The four COCO-DR stages chained through the port, the counterpart of
tests/test_full_recipe.py: COCO pretraining of a coCondenser from random
init -> the handoff of its backbone to a dual encoder
(models/condenser.py::split_state_dict, then models/hf.py::
state_dict_from_hf) -> the BM25-style warmup on text triples -> three
ANCE rounds with DRO-greedy -> a BEIR-style eval after each stage, on the
JAX test's synthetic world (10 topics, 40 documents, a WordPiece vocab
file in tmp_path). One test chains all four stages through the port with
its own random streams; the other holds the port's handoff, warmup, ANCE
rounds and evals to the JAX test's three nDCG inequalities from the JAX
test's COCO output and k-means draws (its docstring says why).

The handoff test holds the port's handoff against the JAX package's on
one set of COCO weights: JAX coCondenser parameters from a seed, taken
into the port's Condenser by models/convert.py::
condenser_state_dict_from_jax, give a DualEncoder whose query and
document embeddings equal the JAX dual encoder's on {"encoder":
coco_params["bert"]} (float32 on the CPU, 2e-5: sums in another order).
"""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.condenser import CoCondenserForPretraining as JaxCoco
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu_torch.data.coco_collator import CoCondenserCollator
from cocodr_tpu_torch.data.coco_spans import (
    preprocess_corpus_to_spans,
    span_batches,
)
from cocodr_tpu_torch.data.records import RecordWriter, TokenCache
from cocodr_tpu_torch.data.streams import TripletBatcher
from cocodr_tpu_torch.losses.dro import DroConfig, dro_greedy_init
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig
from cocodr_tpu_torch.models.condenser import (
    CoCondenserForPretraining,
    build_condenser,
    split_state_dict,
)
from cocodr_tpu_torch.models.dual_encoder import MODEL_REGISTRY, DualEncoder
from cocodr_tpu_torch.models.hf import state_dict_from_hf
from cocodr_tpu_torch.optim import AdamW, Lamb, warmup_linear
from cocodr_tpu_torch.pipelines.ance import MineConfig, ance_round
from cocodr_tpu_torch.pipelines.coco import CocoConfig, build_coco_train_step
from cocodr_tpu_torch.pipelines.eval_beir import eval_beir
from cocodr_tpu_torch.pipelines.train_step import (
    TrainStepConfig,
    build_train_step,
)
from cocodr_tpu_torch.pipelines.warmup import WarmupConfig, run_warmup
from cocodr_tpu_torch.utils.train_state import TrainState

transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon",
         "zeta", "eta", "theta", "iota", "kappa"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_full_recipe.py's world: docs repeat a topic word, queries
    name a topic; a BEIR-format task, warmup triples whose negatives cycle
    over 6 other topics, and ANCE records."""
    root = tmp_path_factory.mktemp("world")
    vocab = "[PAD] [UNK] [CLS] [SEP] [MASK]".split() + WORDS + ["filler"]
    (root / "vocab.txt").write_text("\n".join(vocab))
    tok = transformers.BertTokenizerFast(
        vocab_file=str(root / "vocab.txt"), do_lower_case=True)
    rng = np.random.RandomState(0)
    beir = root / "beir"
    (beir / "qrels").mkdir(parents=True)
    with open(beir / "corpus.jsonl", "w") as f:
        for i in range(40):
            w = WORDS[i % 10]
            other = WORDS[rng.randint(10)]
            f.write(json.dumps({"_id": f"d{i}", "title": "",
                                "text": f"{w} {w} filler {other} {w}"})
                    + "\n")
    with open(beir / "queries.jsonl", "w") as f:
        for j, w in enumerate(WORDS):
            f.write(json.dumps({"_id": f"q{j}", "text": f"{w} filler"})
                    + "\n")
    with open(beir / "qrels" / "test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for j in range(10):
            for i in range(40):
                if i % 10 == j:
                    f.write(f"q{j}\td{i}\t1\n")
    with open(root / "triples.tsv", "w") as f:
        for r in range(6):
            for j, w in enumerate(WORDS):
                neg = WORDS[(j + 1 + r) % 10]
                f.write(f"{w}\t{w} {w} filler\t{neg} {neg} filler\n")
    qp, pp = str(root / "train-query"), str(root / "passages")
    wid = {w: tok.convert_tokens_to_ids([w])[0] for w in WORDS}
    fid = tok.convert_tokens_to_ids(["filler"])[0]
    with RecordWriter(qp, 6) as w_:
        for j, w in enumerate(WORDS):
            w_.write([2, wid[w], fid, 3])
    with RecordWriter(pp, 6) as w_:
        for i in range(40):
            w = WORDS[i % 10]
            w_.write([2, wid[w], wid[w], fid, 3])
    return {"root": root, "tok": tok, "beir": str(beir), "qp": qp, "pp": pp,
            "positives": {j: j for j in range(10)},
            "dev_qrels": {j: {i: 1 for i in range(40) if i % 10 == j}
                          for j in range(10)}}


def handoff(coco_model, bert):
    """The COCO stage's backbone -> a rdot_nll_condenser DualEncoder: the
    reference's checkpoint split, then the HuggingFace-name loader."""
    backbone, c_head = split_state_dict(coco_model.state_dict())
    assert c_head and all(k.startswith("c_head.") for k in c_head)
    cfg = MODEL_REGISTRY["rdot_nll_condenser"](bert)
    model = DualEncoder(cfg)
    model.load_state_dict(state_dict_from_hf(backbone, cfg))
    return model


def eval_ndcg(world, model, work):
    metrics = eval_beir(
        model, world["beir"], str(work), world["tok"], task="synthetic",
        device="cpu", batch_size=16, top_k=40, mips_tile=16, q_chunk=16,
        exact_fp32=True, query_len=8, doc_len=10)
    return metrics["ndcg_cut_10"]


def port_coco(world, tmp_path, seed=0):
    """The JAX test's stage 1 through the port: a coCondenser from random
    init (the port's BERT initialisation, generator seed `seed`), AdamW
    5e-4, 26 steps with dropout (seed 1) over batches of 8 docs ->
    (model, first loss, last loss)."""
    tok = world["tok"]
    spans_path = tmp_path / "spans.jsonl"
    n = preprocess_corpus_to_spans(world["beir"] + "/corpus.jsonl",
                                   str(spans_path), tok, target_len=6)
    assert n == 40
    model = build_condenser(BertConfig.tiny(), "cpu",
                            torch.Generator().manual_seed(seed),
                            n_head_layers=1, skip_from=1, late_mlm=True)
    coll = CoCondenserCollator(tok, mlm_probability=0.3, max_seq_length=10)
    state = TrainState(model, AdamW(model.parameters(), 5e-4))
    step = build_coco_train_step(CocoConfig())
    losses = []
    for i, batch in enumerate(span_batches([str(spans_path)], coll,
                                           docs_per_batch=8, num_epochs=8)):
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                 1)
        losses.append(float(m["loss"]))
        if i >= 25:
            break
    return model, losses[0], losses[-1]


def warmup_and_ance(world, tmp_path, de_model):
    """The JAX test's stages 2 and 3 through the port on de_model (in
    place): run_warmup with LAMB (1e-3, warmup 4 of 600) on the text
    triples, dropout off as the JAX test trains it, then three ance_rounds
    of dro-greedy (G 4, LAMB 1e-3, warmup 4 of 400) with k-means groups
    over the train queries; an eval after each -> (warmup, final) nDCG@10."""
    tok = world["tok"]
    state2 = TrainState(de_model, Lamb(de_model.parameters(),
                                       warmup_linear(1e-3, 4, 600)))
    wcfg = WarmupConfig(max_seq_len=6, batch_size=10, num_epochs=20,
                        save_steps=0, log_every=100)
    run_warmup(state2, build_train_step(TrainStepConfig(loss_kind="nll")),
               str(world["root"] / "triples.tsv"), tok, wcfg,
               str(tmp_path / "warmup_ck"), resume=False, dropout_seed=None)
    assert state2.step == 120
    ndcg_warmup = eval_ndcg(world, de_model, tmp_path / "eval_warmup")
    dcfg = DroConfig(n_groups=4)
    state3 = TrainState(de_model, Lamb(de_model.parameters(),
                                       warmup_linear(1e-3, 4, 400)),
                        extra=dro_greedy_init(dcfg, "cpu"))
    step3 = build_train_step(TrainStepConfig(loss_kind="dro-greedy",
                                             dro=dcfg))
    qc, pc = TokenCache(world["qp"]), TokenCache(world["pp"])
    mine_cfg = MineConfig(
        topk_training=12, negative_sample=4, n_splits=1, cluster_query=True,
        cluster_centroids=4, kmeans_iters=10, kmeans_redo=1, dev_topk=10,
        batch_size=16, q_chunk=16, mips_tile=16, exact_fp32=True)
    for rnd in range(3):
        state3, _, steps = ance_round(
            state3, step3, TripletBatcher(qc, pc), pc, qc,
            world["positives"], qc, world["dev_qrels"],
            str(tmp_path / "ann"), rnd, mine_cfg, batch_size=10,
            steps_per_round=20, dropout_seed=None, device="cpu")
        assert steps == 4
    assert state3.step == 12
    return ndcg_warmup, eval_ndcg(world, de_model, tmp_path / "eval_final")


def test_four_stages_chain_through_the_port(world, tmp_path):
    """The JAX test's four stages, every one through the port with its own
    random streams: COCO's loss falls, the handoff carries the COCO
    backbone into the dual encoder bit for bit, warmup takes its 120 steps
    and each ANCE round its 4, and each eval gives an nDCG@10 in [0, 1].
    The JAX test's inequalities are not asserted here: on this world they
    hold for a few seeds only, in both packages (the next test)."""
    coco_model, first, last = port_coco(world, tmp_path)
    assert last < first, (first, last)
    de_model = handoff(coco_model, BertConfig.tiny())
    for k, v in coco_model.bert.state_dict().items():
        assert torch.equal(de_model.state_dict()["encoder." + k], v), k
    ndcg_coco = eval_ndcg(world, de_model, tmp_path / "eval_coco")
    before = {k: v.clone() for k, v in de_model.state_dict().items()}
    ndcg_warmup, ndcg_final = warmup_and_ance(world, tmp_path, de_model)
    assert any(not torch.equal(v, de_model.state_dict()[k])
               for k, v in before.items())
    for x in (ndcg_coco, ndcg_warmup, ndcg_final):
        assert 0.0 <= x <= 1.0


def jax_coco_stage(world, tmp_path, seed=0):
    """tests/test_full_recipe.py's stage 1 in the JAX package: init key
    PRNGKey(seed), dropout keys split from PRNGKey(1 + 100 * seed) (the
    JAX test's keys at seed 0) -> the coCondenser params."""
    import optax

    from cocodr_tpu.data.coco_collator import CoCondenserCollator as JColl
    from cocodr_tpu.data.coco_spans import span_batches as jax_batches
    from cocodr_tpu.pipelines.coco import CocoConfig as JaxCocoConfig
    from cocodr_tpu.pipelines.coco import build_coco_train_step as jax_step
    from cocodr_tpu.utils.train_state import TrainState as JaxTrainState

    spans = str(tmp_path / "jax_spans.jsonl")
    preprocess_corpus_to_spans(world["beir"] + "/corpus.jsonl", spans,
                               world["tok"], target_len=6)
    model = JaxCoco(JaxBertConfig.tiny(), n_head_layers=1, skip_from=1,
                    late_mlm=True)
    coll = JColl(world["tok"], mlm_probability=0.3, max_seq_length=10)
    first = next(jax_batches([spans], coll, docs_per_batch=8))
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.asarray(first["input_ids"]),
                        jnp.asarray(first["attention_mask"]),
                        jnp.asarray(first["labels"]))["params"]
    tx = optax.adamw(5e-4)
    state = JaxTrainState.create(params, tx)
    step = jax_step(model, tx, JaxCocoConfig())
    key = jax.random.PRNGKey(1 + 100 * seed)
    for i, batch in enumerate(jax_batches([spans], coll, docs_per_batch=8,
                                          num_epochs=8)):
        key, k = jax.random.split(key)
        state, _ = step(state, {kk: jnp.asarray(v) for kk, v in
                                batch.items()}, k)
        if i >= 25:
            break
    return jax.device_get(state.params)


def test_recipe_helps_through_the_port(world, tmp_path, monkeypatch):
    """The JAX test's three inequalities through the port's handoff,
    warmup, ANCE rounds and evals, from the JAX test's own COCO output
    (stage 1 run in the JAX package with its seeds: the port cannot draw
    its dropout masks), with the k-means initial rows of ance_round drawn
    as the JAX package draws them (jax.random.choice of PRNGKey(seed);
    the port draws RandomState(seed).choice). Every later stage is
    deterministic. On this world the inequalities hold for the JAX test
    at its seeds but not at most others, in either package
    (test_recipe_inequalities_depend_on_the_seed), so the port is held
    to them on the JAX test's draws."""
    from cocodr_tpu_torch.ops import kmeans as tkmeans

    monkeypatch.setattr(tkmeans, "init_indices", lambda n, c, seed: np.array(
        jax.random.choice(jax.random.PRNGKey(seed), n, (c,), replace=False)))
    bert = BertConfig.tiny()
    coco_model = CoCondenserForPretraining(bert, 1, 1, True)
    coco_model.load_state_dict(convert.condenser_state_dict_from_jax(
        jax_coco_stage(world, tmp_path), bert, 1))
    de_model = handoff(coco_model, bert)
    ndcg_coco = eval_ndcg(world, de_model, tmp_path / "eval_coco")
    ndcg_warmup, ndcg_final = warmup_and_ance(world, tmp_path, de_model)
    print("ndcg: coco", ndcg_coco, "warmup", ndcg_warmup, "final", ndcg_final)
    assert ndcg_warmup > ndcg_coco, (ndcg_coco, ndcg_warmup)
    assert ndcg_final > ndcg_warmup, (ndcg_warmup, ndcg_final)
    assert ndcg_final > ndcg_coco + 0.1, (ndcg_coco, ndcg_warmup, ndcg_final)


def jax_recipe(world, tmp_path, seed):
    """tests/test_full_recipe.py's recipe in the JAX package at `seed`
    (jax_coco_stage's keys) -> (coco, warmup, final) nDCG@10."""
    from cocodr_tpu.data.records import TokenCache as JaxTokenCache
    from cocodr_tpu.data.streams import TripletBatcher as JaxBatcher
    from cocodr_tpu.losses import DroConfig as JaxDroConfig
    from cocodr_tpu.losses import dro_greedy_init as jax_dro_init
    from cocodr_tpu.optim import lamb as jax_lamb
    from cocodr_tpu.optim import warmup_linear as jax_linear
    from cocodr_tpu.pipelines import ance as jance
    from cocodr_tpu.pipelines import eval_beir as jeval
    from cocodr_tpu.pipelines import train_step as jstep
    from cocodr_tpu.pipelines import warmup as jwarmup
    from cocodr_tpu.utils.train_state import TrainState as JaxTrainState

    tok = world["tok"]
    model = jax_build("rdot_nll_condenser", JaxBertConfig.tiny())
    params = {"encoder": jax_coco_stage(world, tmp_path, seed)["bert"]}

    def ndcg(p, name):
        return jeval.eval_beir(
            model, p, world["beir"], str(tmp_path / name), tok,
            task="synthetic", batch_size=16, top_k=40, mips_tile=16,
            q_chunk=16, exact_fp32=True, query_len=8,
            doc_len=10)["ndcg_cut_10"]

    out = [ndcg(params, "jax_eval_coco")]
    tx2 = jax_lamb(jax_linear(1e-3, 4, 600))
    state2 = jwarmup.run_warmup(
        JaxTrainState.create(params, tx2),
        jstep.build_train_step(model, tx2,
                               jstep.TrainStepConfig(loss_kind="nll")),
        str(world["root"] / "triples.tsv"), tok,
        jwarmup.WarmupConfig(max_seq_len=6, batch_size=10, num_epochs=20,
                             save_steps=0, log_every=100),
        str(tmp_path / "jax_warmup_ck"), resume=False, dropout_seed=None)
    out.append(ndcg(state2.params, "jax_eval_warmup"))
    dcfg = JaxDroConfig(n_groups=4)
    tx3 = jax_lamb(jax_linear(1e-3, 4, 400))
    state3 = JaxTrainState.create(state2.params, tx3,
                                  extra=jax_dro_init(dcfg))
    step3 = jstep.build_train_step(model, tx3, jstep.TrainStepConfig(
        loss_kind="dro-greedy", dro=dcfg))
    qc, pc = JaxTokenCache(world["qp"]), JaxTokenCache(world["pp"])
    mine_cfg = jance.MineConfig(
        topk_training=12, negative_sample=4, n_splits=1, cluster_query=True,
        cluster_centroids=4, kmeans_iters=10, kmeans_redo=1, dev_topk=10,
        batch_size=16, q_chunk=16, mips_tile=16, exact_fp32=True)
    for rnd in range(3):
        state3, _, _ = jance.ance_round(
            state3, step3, model, JaxBatcher(qc, pc), pc, qc,
            world["positives"], qc, world["dev_qrels"],
            str(tmp_path / "jax_ann"), rnd, mine_cfg, batch_size=10,
            steps_per_round=20, dropout_seed=None)
    out.append(ndcg(state3.params, "jax_eval_final"))
    return out


def recipe_helps(ndcg):
    coco, warmup, final = ndcg
    return warmup > coco and final > warmup and final > coco + 0.1


@pytest.mark.slow
def test_recipe_inequalities_depend_on_the_seed(world, tmp_path):
    """The record behind test_recipe_helps_through_the_port's design:
    the JAX test's recipe at seeds 0-5 in the JAX package (jax_recipe)
    and through the port with its own random streams (port_coco's init
    seed, then warmup_and_ance), each stage's nDCG@10 printed. In both
    packages the three inequalities hold at some seeds and fail at
    others: they are a property of one trajectory on this world, not of
    the recipe, so the port cannot be held to them on its own draws.
    Slow: twelve recipes, ~4 minutes."""
    held = {"jax": [], "port": []}
    for seed in range(6):
        work = tmp_path / f"seed{seed}"
        work.mkdir()
        jax_ndcg = jax_recipe(world, work, seed)
        coco_model, _, _ = port_coco(world, work, seed)
        de_model = handoff(coco_model, BertConfig.tiny())
        port_ndcg = [eval_ndcg(world, de_model, work / "eval_coco"),
                     *warmup_and_ance(world, work, de_model)]
        print(f"seed {seed}: jax {jax_ndcg}, port {port_ndcg}")
        for name, ndcg in (("jax", jax_ndcg), ("port", port_ndcg)):
            if recipe_helps(ndcg):
                held[name].append(seed)
    print("the inequalities hold at seeds", held)
    for name, seeds in held.items():
        assert 0 < len(seeds) < 6, (name, seeds)


def test_handoff_matches_the_jax_backbone_transfer():
    """JAX coCondenser params from a seed at the tiny config, converted into
    the port's Condenser, handed off through split_state_dict and
    state_dict_from_hf: the DualEncoder's query and document embeddings
    equal the JAX dual encoder's on {"encoder": coco_params["bert"]} (the
    JAX test's transfer), float32, 2e-5."""
    jcfg = JaxBertConfig.tiny()
    rng = np.random.RandomState(0)
    ids = rng.randint(5, 100, size=(6, 12)).astype(np.int32)
    mask = (np.arange(12)[None, :] < rng.randint(4, 13, size=6)[:, None]
            ).astype(np.int32)
    ids = ids * mask
    labels = np.where(rng.rand(6, 12) < 0.3, ids, -100).astype(np.int32)
    jcoco = JaxCoco(jcfg, n_head_layers=1, skip_from=1, late_mlm=True)
    coco_params = jax.device_get(jcoco.init(
        jax.random.PRNGKey(3), ids[:2], mask[:2], labels[:2])["params"])
    bert = BertConfig.tiny()
    coco_model = CoCondenserForPretraining(bert, 1, 1, True)
    coco_model.load_state_dict(convert.condenser_state_dict_from_jax(
        coco_params, bert, 1))
    model = handoff(coco_model, bert).eval()
    jde = jax_build("rdot_nll_condenser", jcfg)
    jparams = {"encoder": coco_params["bert"]}
    with torch.no_grad():
        t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
        got = {"query": model.query_emb(t_ids, t_mask),
               "body": model.body_emb(t_ids, t_mask)}
    for name, method in (("query", jde.query_emb), ("body", jde.body_emb)):
        want = jde.apply({"params": jparams}, jnp.asarray(ids),
                         jnp.asarray(mask), method=method)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5, err_msg=name)
    # the backbone went over whole: the embeddings, every layer, no head
    sd = model.state_dict()
    for k, v in coco_model.bert.state_dict().items():
        assert torch.equal(sd["encoder." + k], v), k
