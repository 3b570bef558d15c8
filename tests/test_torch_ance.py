"""The port's DRO training (pipelines/train_step.py's 'dro-greedy' and
'idro', pipelines/ance.py::train_on_ann_file, data/streams.py's ANCE half,
DroState in checkpoints and in models/convert.py) against the JAX
package's on the same tiny dual encoder and batches, dropout off, float32
on the CPU. Queries are shorter than documents, as in the reference (64
against 128 tokens). Tolerances: 1e-5 in losses, params and h_fun (sums
in another order), except where a test says otherwise."""
import copy
import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.data import streams as jstreams
from cocodr_tpu.losses import DroConfig as JaxDroConfig
from cocodr_tpu.losses import idro_init as jax_idro_init
from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu.optim import lamb as jax_lamb
from cocodr_tpu.optim import warmup_linear as jax_warmup_linear
from cocodr_tpu.pipelines import ance as jance
from cocodr_tpu.pipelines.train_step import TrainStepConfig as JaxStepConfig
from cocodr_tpu.pipelines.train_step import build_train_step as jax_step
from cocodr_tpu.utils.train_state import TrainState as JaxTrainState
from cocodr_tpu_torch.data import records as trec
from cocodr_tpu_torch.data import streams as tstreams
from cocodr_tpu_torch.losses.dro import DroConfig, DroState, idro_init
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig
from cocodr_tpu_torch.models.dual_encoder import MODEL_REGISTRY, DualEncoder
from cocodr_tpu_torch.optim import Lamb, warmup_linear
from cocodr_tpu_torch.pipelines import ance as tance
from cocodr_tpu_torch.pipelines import train_step as ts
from cocodr_tpu_torch.parallel.sharded_train import shard_train_init
from cocodr_tpu_torch.utils import train_state as tstate
import torch_mesh_workers as workers

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
G, B, SQ, SD, VOCAB, HEAD_DIM = 4, 8, 6, 12, 128, 16
LR, WARMUP, TOTAL = 1e-3, 2, 10


def batches(n, seed=0):
    """Padded token batches with groups and per-sample weights."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = {}
        for k, S in (("q", SQ), ("pos", SD), ("neg", SD)):
            ids = rng.randint(1, VOCAB, size=(B, S)).astype(np.int32)
            lens = rng.randint(S // 2, S + 1, size=B)
            mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
            b[f"{k}_ids"], b[f"{k}_mask"] = ids * mask, mask
        b["groups"] = rng.randint(0, G, size=B).astype(np.int32)
        b["weights"] = rng.uniform(0.5, 1.5, size=B).astype(np.float32)
        out.append(b)
    return out


def setup(model_type, kind, seed=0, **step_kw):
    """(JAX state, JAX step, port state, port step, port model config)."""
    jmodel = jax_build(model_type, JaxBertConfig.tiny(), head_dim=HEAD_DIM)
    ones = jnp.ones((2, SD), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(seed), ones, ones)["params"]
    tx = jax_lamb(jax_warmup_linear(LR, WARMUP, TOTAL), eps=1e-6)
    jdro = JaxDroConfig(n_groups=G)
    jstate = JaxTrainState.create(params, tx, extra=jax_idro_init(jdro))
    jstep = jax_step(jmodel, tx, JaxStepConfig(loss_kind=kind, dro=jdro,
                                               **step_kw))
    cfg = MODEL_REGISTRY[model_type](BertConfig.tiny(), head_dim=HEAD_DIM)
    model = DualEncoder(cfg)
    model.load_state_dict(convert.params_from_jax(jax.device_get(params),
                                                  cfg))
    state = tstate.TrainState(
        model, Lamb(model.parameters(), warmup_linear(LR, WARMUP, TOTAL),
                    eps=1e-6),
        extra=idro_init(DroConfig(n_groups=G), device="cpu"))
    step = ts.build_train_step(ts.TrainStepConfig(
        loss_kind=kind, dro=DroConfig(n_groups=G), **step_kw))
    return jstate, jstep, state, step, cfg


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


def run_both(jstate, jstep, state, step, data):
    """-> (JAX state, JAX losses, port losses); checks h_fun and the group
    statistics at every step."""
    jl, tl = [], []
    for b in data:
        jstate, jm = jstep(jstate, to_jax(b))
        m = step(state, to_torch(b))
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
        assert float(m["acc"]) == float(jm["acc"])
        for k in ("group_losses", "group_counts"):
            np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), **TOL)
        np.testing.assert_allclose(state.extra.h_fun.numpy(),
                                   np.asarray(jstate.extra.h_fun), **TOL)
    return jstate, jl, tl


@pytest.mark.parametrize("model_type", ["rdot_nll", "rdot_nll_condenser"])
@pytest.mark.parametrize("kind", ["dro-greedy", "idro"])
def test_trajectory_matches_jax_train_step(kind, model_type):
    """5 steps: robust losses, accuracies, group statistics, h_fun and the
    final params. The iDRO group pass takes the last layer (K = 1 of 2),
    so its products skip the first layer; dro-greedy applies the weights,
    iDRO ignores them, as in the JAX step."""
    jstate, jstep, state, step, cfg = setup(model_type, kind,
                                            idro_last_k_layers=1)
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    jstate, jl, tl = run_both(jstate, jstep, state, step, batches(5))
    np.testing.assert_allclose(tl, jl, **TOL)
    assert state.step == int(jstate.step) == 5
    assert_params_match(jstate.params, state.model, cfg)
    for name in ("sum_losses", "count_cat"):
        np.testing.assert_allclose(getattr(state.extra, name).numpy(),
                                   np.asarray(getattr(jstate.extra, name)),
                                   **TOL)
    moved = max((state.model.state_dict()[k] - v).abs().max().item()
                for k, v in start.items())
    assert moved > 1e-4


def test_idro_lane_config_matches_the_jax_default_path():
    """The lane config (bf16 rows written 3 groups at a time) against the
    JAX default (per-sample Gram) step: the same robust loss (1e-5), and
    h_fun within 3e-3 relative, the bound the JAX package's own test
    gives its bf16 lane rows (tests/test_train_step.py::
    test_idro_group_pass_variants_match)."""
    jstate, jstep, state, _, cfg = setup("rdot_nll", "idro",
                                         idro_last_k_layers=1)
    step = ts.build_train_step(ts.TrainStepConfig(
        loss_kind="idro", dro=DroConfig(n_groups=G), idro_last_k_layers=1,
        idro_lane_group_pass=True, idro_lane_chunk=3))
    for b in batches(3, seed=1):
        jstate, jm = jstep(jstate, to_jax(b))
        m = step(state, to_torch(b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **TOL)
        np.testing.assert_allclose(state.extra.h_fun.numpy(),
                                   np.asarray(jstate.extra.h_fun), rtol=3e-3)


def test_idro_clamps_k_to_the_depth():
    """K = 3 on a 2-layer model takes every layer: bit-equal to K = 2, and
    equal to the JAX package's clamped step."""
    data = batches(2, seed=2)
    jstate, jstep, state3, step3, cfg = setup("rdot_nll", "idro",
                                              idro_last_k_layers=3)
    _, _, state2, step2, _ = setup("rdot_nll", "idro", idro_last_k_layers=2)
    assert ts.last_k_layers(state3.model, 3) == list(
        state3.model.encoder.encoder.layer.parameters())
    for b in data:
        m3, m2 = step3(state3, to_torch(b)), step2(state2, to_torch(b))
        jstate, jm = jstep(jstate, to_jax(b))
        assert torch.equal(m3["loss"], m2["loss"])
        np.testing.assert_allclose(float(m3["loss"]), float(jm["loss"]),
                                   **TOL)
    assert torch.equal(state3.extra.h_fun, state2.extra.h_fun)
    for a, b in zip(state3.model.parameters(), state2.model.parameters()):
        assert torch.equal(a, b)
    assert_params_match(jstate.params, state3.model, cfg)
    with pytest.raises(ValueError, match="idro_last_k_layers"):
        ts.last_k_layers(state3.model, 0)


@pytest.mark.parametrize("kind", ["dro-greedy", "idro"])
def test_every_parameter_gets_a_gradient(kind):
    """The robust loss reaches every parameter of both towers of both model
    kinds, so LAMB (which skips a None gradient) takes every parameter's
    moments, as optax does."""
    for model_type in ("rdot_nll", "rdot_nll_condenser"):
        _, _, state, step, _ = setup(model_type, kind)
        step(state, to_torch(batches(1)[0]))
        params = list(state.model.parameters())
        assert all(p.grad is not None for p in params), model_type
        assert all(state.optimizer.state[p] for p in params), model_type


def test_dro_kinds_need_a_config():
    for kind in ts.DRO_KINDS:
        with pytest.raises(ValueError, match="TrainStepConfig.dro"):
            ts.build_train_step(ts.TrainStepConfig(loss_kind=kind))


ANN_LINES = [
    "3\t1\t4,5,6\n",
    "0\t2\t7,8\t0.5\t1\n",
    "2\t9\t1,3,10,11\t1.25\t3.0\n",
    "1\t4\t\t2\t2\n",
    "4\t6\t0,2,8\t1\t0\n",
]


def test_ann_streams_match_jax():
    """parse_ann_line (3- and 5-column lines, empty negatives, float group
    ids), the triplet expansion with rank sharding, shuffled_ann_lines and
    shard_indices equal the JAX package's."""
    for line in ANN_LINES:
        assert tstreams.parse_ann_line(line) == jstreams.parse_ann_line(line)
    for rank, world in ((0, 1), (1, 2), (0, 3)):
        got = list(tstreams.triplets_from_ann_lines(ANN_LINES, rank, world))
        want = list(jstreams.triplets_from_ann_lines(ANN_LINES, rank, world))
        assert [dataclasses.astuple(t) for t in got] == [
            dataclasses.astuple(t) for t in want]
        np.testing.assert_array_equal(tstreams.shard_indices(11, rank, world),
                                      jstreams.shard_indices(11, rank, world))
    for seed in (0, 7):
        assert (tstreams.shuffled_ann_lines(ANN_LINES, seed)
                == jstreams.shuffled_ann_lines(ANN_LINES, seed))


def write_ann_data(tmp_path, n_lines=12, negs=5, seed=3):
    """Query (SQ) and passage (SD) token caches and a 5-column ann file."""
    rng = np.random.RandomState(seed)
    qp, pp = str(tmp_path / "queries"), str(tmp_path / "passages")
    for path, n, width in ((qp, 20, SQ), (pp, 40, SD)):
        with trec.RecordWriter(path, width) as w:
            for _ in range(n):
                w.write([2] + rng.randint(5, VOCAB, rng.randint(
                    1, width - 1)).tolist() + [3])
    ann = str(tmp_path / "ann_training_data_0")
    with open(ann, "w") as f:
        for _ in range(n_lines):
            neg = ",".join(map(str, rng.choice(40, negs, replace=False)))
            f.write(f"{rng.randint(20)}\t{rng.randint(40)}\t{neg}\t"
                    f"{rng.uniform(0.5, 1.5):.3f}\t{rng.randint(G)}\n")
    with open(str(tmp_path / "ann_ndcg_0"), "w") as f:
        f.write('{"ndcg": 0.5, "checkpoint": "x"}')
    return qp, pp, ann


def test_triplet_batcher_matches_jax(tmp_path):
    """The batches of the ann file's triplets, drop_last on and off."""
    qp, pp, ann = write_ann_data(tmp_path)
    with open(ann) as f:
        lines = f.readlines()
    tb = tstreams.TripletBatcher(trec.TokenCache(qp), trec.TokenCache(pp))
    from cocodr_tpu.data.records import TokenCache as JaxTokenCache

    jb = jstreams.TripletBatcher(JaxTokenCache(qp), JaxTokenCache(pp))
    for drop_last in (True, False):
        got = list(tb.batches(tstreams.triplets_from_ann_lines(lines), 7,
                              drop_last))
        want = list(jb.batches(jstreams.triplets_from_ann_lines(lines), 7,
                               drop_last))
        assert len(got) == len(want) == (8 if drop_last else 9)
        for a, b in zip(got, want):
            for f in dataclasses.fields(b):
                x, y = getattr(a, f.name), getattr(b, f.name)
                np.testing.assert_array_equal(x, y, err_msg=f.name)
                assert x.dtype == y.dtype, f.name


def test_train_on_ann_file_matches_jax(tmp_path):
    """train_on_ann_file with the iDRO step (the clamped K = 2 of 2), no
    dropout, 5 steps of 8 over a 60-triplet file: the same batches in the
    same order, the same losses through metrics_cb and the same h_fun
    (1e-5), the same final params to 1e-4; get_latest_ann_data finds the
    file. The params' bound is above this trajectory's own rounding floor:
    on these batches (an ann line's 5 triplets share their query) the port
    against itself with the NLL's dot products summed in reverse order
    ends 3.5e-5 apart in LayerNorm weights (LAMB scales each tensor's
    update to its weight norm, so near-zero gradients move by their
    rounding); the JAX package ends 2.2e-5 from the port."""
    qp, pp, ann = write_ann_data(tmp_path)
    jstate, jstep, state, step, cfg = setup("rdot_nll_condenser", "idro")
    from cocodr_tpu.data.records import TokenCache as JaxTokenCache

    seen_j, seen_t, cb_j, cb_t = [], [], [], []

    def jrec(s, b, *a):
        seen_j.append({k: np.asarray(v) for k, v in b.items()})
        return jstep(s, b, *a)

    def trec_(s, b, g):
        assert g is None
        seen_t.append({k: v.numpy() for k, v in b.items()})
        return step(s, b, g)

    jstate, jn = jance.train_on_ann_file(
        jstate, jrec, jstreams.TripletBatcher(JaxTokenCache(qp),
                                              JaxTokenCache(pp)),
        ann, B, max_steps=5, seed=4, dropout_seed=None,
        metrics_cb=lambda s, m: cb_j.append((s, float(m["loss"]))))
    state, tn = tance.train_on_ann_file(
        state, trec_, tstreams.TripletBatcher(trec.TokenCache(qp),
                                              trec.TokenCache(pp)),
        ann, B, max_steps=5, seed=4, dropout_seed=None,
        metrics_cb=lambda s, m: cb_t.append((s, float(m["loss"]))))
    assert tn == jn == 5
    for a, b in zip(seen_t, seen_j):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert [s for s, _ in cb_t] == [s for s, _ in cb_j] == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([x for _, x in cb_t], [x for _, x in cb_j],
                               **TOL)
    assert_params_match(jstate.params, state.model, cfg, rtol=1e-4,
                        atol=1e-4)
    np.testing.assert_allclose(state.extra.h_fun.numpy(),
                               np.asarray(jstate.extra.h_fun), **TOL)
    n, path, meta = tance.get_latest_ann_data(str(tmp_path))
    assert (n, path, meta) == jance.get_latest_ann_data(str(tmp_path))
    assert n == 0 and path == ann and meta["ndcg"] == 0.5
    assert tance.get_latest_ann_data(str(tmp_path / "none"))[0] == -1


def test_train_on_ann_file_dropout_generators(tmp_path):
    """With dropout_seed the step gets dropout_generators(dropout_seed,
    state.step), so a run resumed at step 2 draws the masks an unbroken
    run draws there, and the model trains in train mode; an nll step's
    (loss, acc) reaches metrics_cb as a dict."""
    qp, pp, ann = write_ann_data(tmp_path)
    cfg = MODEL_REGISTRY["rdot_nll"](BertConfig.tiny(), head_dim=HEAD_DIM)
    model = DualEncoder(cfg)
    state = tstate.TrainState(model, Lamb(model.parameters(), 1e-3), step=2)
    inner, seen, out = ts.build_train_step(), [], []

    def step(st, batch, gens):
        seen.append((st.step, [g.get_state() for g in gens]))
        result = inner(st, batch, gens)
        assert st.model.training
        return result

    tance.train_on_ann_file(
        state, step, tstreams.TripletBatcher(trec.TokenCache(qp),
                                             trec.TokenCache(pp)),
        ann, B, max_steps=2, seed=1, dropout_seed=5,
        metrics_cb=lambda s, m: out.append((s, sorted(m))))
    assert [s for s, _ in seen] == [2, 3]
    for s, states in seen:
        want = ts.dropout_generators(5, s, torch.device("cpu"))
        assert all(torch.equal(a, g.get_state())
                   for a, g in zip(states, want))
    assert out == [(3, ["acc", "loss"]), (4, ["acc", "loss"])]


def test_what_mining_leaves_names_its_item(tmp_path):
    """A mesh and device_put (item 11a) raised here until the multi-device
    slice; in a world of one process they now give the single-device
    results bit for bit: mine(mesh=) the same ann file, train_on_ann_file
    and train_loop with a DP state's put_batch the same parameters (the
    ranks' sharded paths at W = 2 and 4 are tests/test_torch_sharded_*.py
    and tests/test_torch_cli_mesh.py). search_method='ivf' raised here
    until ops/ivf.py was ported; it now
    mines, with its index's build time as time_ivf_build (with exact_fp32
    the search is exact, as before; the IVF negatives are held against an
    exact mine in tests/test_torch_mine.py). A multi-chunk model (item 3) now mines: over records of one
    chunk's width its corpus is single vectors and the round writes the
    ann file of rdot_nll on the same weights (the multi-chunk corpus is
    held against the JAX mine in tests/test_torch_multichunk.py).
    train_loop's saver came with the COCO slice
    (tests/test_torch_coco.py)."""
    qp, pp, ann = write_ann_data(tmp_path)
    qc, pc = trec.TokenCache(qp), trec.TokenCache(pp)
    model = DualEncoder(MODEL_REGISTRY["rdot_nll"](BertConfig.tiny()))
    args = (pc, qc, {0: 1}, qc, {0: {1: 1}}, str(tmp_path / "m"), 0)
    got = tance.mine(model, None, *args[:-2], str(tmp_path / "ivf"), 0,
                     tance.MineConfig(search_method="ivf", batch_size=8),
                     device="cpu")
    assert got["time_ivf_build"] >= 0
    assert os.path.exists(tance.ann_data_path(str(tmp_path / "ivf"), 0))
    tance.mine(model, None, *args, tance.MineConfig(
        search_method="ivf", exact_fp32=True, batch_size=8), device="cpu")
    assert os.path.exists(tance.ann_data_path(str(tmp_path / "m"), 0))
    with workers.world_of_one() as mesh:
        tance.mine(model, None, *args[:-2], str(tmp_path / "mesh"), 0,
                   tance.MineConfig(search_method="ivf", exact_fp32=True,
                                    batch_size=8), mesh=mesh, device="cpu")
        assert (open(tance.ann_data_path(str(tmp_path / "mesh"), 0)).read()
                == open(tance.ann_data_path(str(tmp_path / "m"), 0)).read())
        ann_file = tance.ann_data_path(str(tmp_path / "m"), 0)
        batcher = tstreams.TripletBatcher(qc, pc)
        step = ts.build_train_step()
        m1, m2 = copy.deepcopy(model), copy.deepcopy(model)
        plain = tstate.TrainState(m1, Lamb(m1.parameters(), 1e-3))
        tance.train_on_ann_file(plain, step, batcher, ann_file, 1,
                                dropout_seed=None)
        dp, put = shard_train_init(mesh, m2, Lamb(m2.parameters(), 1e-3))
        tance.train_on_ann_file(dp, step, batcher, ann_file, 1,
                                dropout_seed=None, device_put=put)
        assert dp.step == plain.step > 0
        for a, b in zip(dp.model.parameters(), plain.model.parameters()):
            assert torch.equal(a, b)
        tance.train_loop(dp, step, batcher, str(tmp_path / "m"),
                         str(tmp_path / "ck"), 1, max_ann_files=1,
                         dropout_seed=None, device_put=put)
        assert tstate.latest_checkpoint(str(tmp_path / "ck")) is not None
    chunked = DualEncoder(MODEL_REGISTRY["rdot_nll_multi_chunk"](
        BertConfig.tiny(), base_len=pc.max_len))
    chunked.load_state_dict(model.state_dict())
    cfg = tance.MineConfig(exact_fp32=True, batch_size=8)
    for name, m in (("plain", model), ("chunked", chunked)):
        tance.mine(m, None, *args[:-2], str(tmp_path / name), 0, cfg,
                   device="cpu")
    with open(tance.ann_data_path(str(tmp_path / "plain"), 0)) as a, \
            open(tance.ann_data_path(str(tmp_path / "chunked"), 0)) as b:
        assert a.read() == b.read()


def test_checkpoint_round_trip_with_dro_state(tmp_path):
    """save_checkpoint writes the DroState, load_checkpoint restores it
    into a fresh state (and None stays None)."""
    _, _, state, step, _ = setup("rdot_nll", "idro")
    step(state, to_torch(batches(1)[0]))
    tstate.save_checkpoint(str(tmp_path), state)
    _, _, other, _, _ = setup("rdot_nll", "idro", seed=1)
    other.extra = None
    tstate.load_checkpoint(tstate.latest_checkpoint(str(tmp_path)), other)
    assert other.step == 1
    for f in dataclasses.fields(DroState):
        assert torch.equal(getattr(other.extra, f.name),
                           getattr(state.extra, f.name)), f.name
    for a, b in zip(other.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)
    state.extra = None
    tstate.save_checkpoint(str(tmp_path), state)
    tstate.load_checkpoint(tstate.latest_checkpoint(str(tmp_path)), other)
    assert other.extra is None


def test_load_jax_train_state_carries_extra():
    """A JAX iDRO state after 2 steps continues in the port: the DroState
    arrives, and a third step of each agrees."""
    data = batches(3, seed=5)
    jstate, jstep, state, step, cfg = setup("rdot_nll", "idro",
                                            idro_last_k_layers=1)
    for b in data[:2]:
        jstate, _ = jstep(jstate, to_jax(b))
    state.extra = None
    convert.load_jax_train_state(state, jax.device_get(jstate), cfg)
    assert state.step == 2
    for f in dataclasses.fields(DroState):
        np.testing.assert_array_equal(getattr(state.extra, f.name).numpy(),
                                      np.asarray(getattr(jstate.extra,
                                                         f.name)))
    jstate, _, _ = run_both(jstate, jstep, state, step, data[2:])
    assert_params_match(jstate.params, state.model, cfg)


def _compare_setup(dtype, seed=3):
    """A 2-layer H = 128 model with fused attention (chip_smoke.py's iDRO
    compare takes K1 and K8), its batch with every group present, and a
    skewed DroState."""
    import chip_smoke
    from cocodr_tpu_torch.models.dual_encoder import build_dual_encoder

    bert = BertConfig(vocab_size=1000, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=512,
                      max_position_embeddings=64, dtype=dtype,
                      attention_impl="fused")
    model = build_dual_encoder("rdot_nll_condenser", bert, device="cpu",
                               generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(8)
    batch = {}
    for k, S in (("q", 16), ("pos", 32), ("neg", 32)):
        ids = rng.randint(5, 1000, size=(8, S))
        lens = rng.randint(4, S + 1, size=8)
        mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int64)
        batch[f"{k}_ids"] = torch.from_numpy(ids * mask)
        batch[f"{k}_mask"] = torch.from_numpy(mask)
    batch["groups"] = torch.arange(8) % chip_smoke.IDRO_CMP_GROUPS
    dro = DroConfig(n_groups=chip_smoke.IDRO_CMP_GROUPS)
    cfg = ts.TrainStepConfig(loss_kind="idro", dro=dro)
    return model, batch, chip_smoke.compare_dro_state(dro, 0), cfg


def _agree(a, b):
    import chip_smoke

    (la, ga, ha, ca), (lb, gb, hb, cb) = a, b
    rel, glob, worst, cos = chip_smoke.step_agreement(la, ga, lb, gb)
    herr = chip_smoke.h_fun_log_err(ha, hb)
    cerr = (ca - cb).abs().max().item()
    return (chip_smoke.steps_agree(rel, glob, cos),
            herr <= chip_smoke.IDRO_H_LOG_TOL,
            cerr <= chip_smoke.IDRO_COSINE_TOL, (rel, glob, cos, herr, cerr))


@pytest.mark.parametrize("variant", ["bf16", "post_update_cotangent",
                                     "h_fun_not_updated", "every_layer_pass",
                                     "other_groups_rows"])
def test_idro_compare_bounds_separate_wrong_steps(monkeypatch, variant):
    """chip_smoke.py holds one iDRO step on the card (bf16, K1, K8) against
    the same step on the CPU's plain versions by the loss (5%), the
    clipped gradients' cosines (0.98 global, 0.8 worst tensor), h_fun
    (max |log h_card - log h_cpu| <= IDRO_H_LOG_TOL) and the group pass's
    cosines between the groups' gradients (max |diff| <=
    IDRO_COSINE_TOL). Here, against a float32 step: the same step in bf16
    passes all of them; a training cotangent of the post-update h_fun
    fails the gradient bounds; an h_fun left at its pre-update value fails
    the h_fun bound; a group pass over every layer in place of the last
    K = 1, and one whose rows are the gradients of other groups (the two
    that chip_smoke.py also plants on the card), fail the cosine bound. Measured here: bf16 loss 1.4e-3 apart, cosines 0.99989
    and 0.99966, h_fun 6.8e-5, group cosines 1.4e-3; the post-update
    cotangent: cosines 0.900 and 0.884; the stale h_fun: 0.94; every
    layer: group cosines 1.5e-2 (h_fun 4.4e-4, under its bound); other
    groups' rows: group cosines 6.0e-2 (h_fun 1.2e-3, under its bound)."""
    import chip_smoke

    model32, batch, dstate, cfg = _compare_setup(torch.float32)
    cfg = dataclasses.replace(cfg, idro_last_k_layers=1)
    want = chip_smoke.idro_compare_step(model32, batch, dstate, cfg)
    dtype = torch.bfloat16 if variant == "bf16" else torch.float32
    model, _, _, _ = _compare_setup(dtype)
    if variant == "post_update_cotangent":
        box, real_pass, real_bwd = {}, ts.idro_group_pass, ts.idro_backward

        def group_pass(*a):
            out = real_pass(*a)
            box["h"] = out[1].h_fun
            return out

        monkeypatch.setattr(ts, "idro_group_pass", group_pass)
        monkeypatch.setattr(ts, "idro_backward", lambda l, g, h, c: real_bwd(
            l, g, box["h"], c))
    elif variant == "h_fun_not_updated":
        real_pass = ts.idro_group_pass

        def group_pass(model, losses, groups, dstate, cfg):
            robust, _, stats = real_pass(model, losses, groups, dstate, cfg)
            return robust, dstate, stats

        monkeypatch.setattr(ts, "idro_group_pass", group_pass)
    fault = {"every_layer_pass": "every layer",
             "other_groups_rows": "other groups' rows"}.get(variant)
    remove = chip_smoke.wrong_group_pass(fault) if fault else None
    try:
        grads_ok, h_ok, cos_ok, numbers = _agree(
            chip_smoke.idro_compare_step(model, batch, dstate, cfg), want)
    finally:
        if remove:
            remove()
    if variant == "bf16":
        assert grads_ok and h_ok and cos_ok, numbers
    elif variant == "post_update_cotangent":
        assert not grads_ok, numbers
    elif variant == "h_fun_not_updated":
        assert grads_ok and cos_ok and not h_ok, numbers
    else:
        assert grads_ok and h_ok and not cos_ok, numbers
