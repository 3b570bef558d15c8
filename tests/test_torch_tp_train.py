"""Tensor-parallel training (parallel/tp.py through parallel/sharded_train.py,
pipelines/train_step.py, optim/lamb.py, pipelines/coco.py and
utils/train_state.py) at 1x2 and 2x2 (data x model) on spawned gloo ranks,
against the JAX package's steps under its shard_train_init on a 4x2 mesh of
tests/conftest.py's 8 fake CPU devices (GSPMD's tensor parallelism) and
against the port's unsplit steps in a world of one.

3 steps each of 'nll' (the warmup's), 'dro-greedy' and 'idro' (LAMB) and
of the direct COCO step (AdamW), float32 on the CPU: losses, the final
parameters (gathered whole) and h_fun 1e-5 (sums over the ranks in
another order); the clip's global norms and the iDRO group pass's Gram
matrices 1e-5 against the unsplit steps' (the split parameters' squared
norms and products summed over the model axis, the replicated ones
counted once); LAMB's trust ratios 1e-4 (a ratio divides two norms).
With dropout on, the split steps draw the unsplit steps' masks (the
attention probabilities' sliced from the whole mask): 1e-5 against the
port's unsplit steps. A checkpoint saved at 1x2 holds the whole tensors
and loads at 1x1, 2x1 and 1x2 with equal parameters and LAMB moments."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import torch_mesh_workers as workers
from cocodr_tpu.core import configs as jax_configs
from cocodr_tpu.core.mesh import MeshConfig, create_mesh
from cocodr_tpu.losses import DroConfig as JaxDroConfig
from cocodr_tpu.losses import idro_init as jax_idro_init
from cocodr_tpu.optim import lamb as jax_lamb
from cocodr_tpu.optim import warmup_linear as jax_warmup_linear
from cocodr_tpu.parallel.sharded_train import shard_train_init
from cocodr_tpu.pipelines import coco as jax_coco
from cocodr_tpu.pipelines.train_step import TrainStepConfig as JaxStepConfig
from cocodr_tpu.pipelines.train_step import build_train_step as jax_step
from cocodr_tpu_torch.core.mesh import spawn
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig
from test_torch_coco import HEADS, SKIP, jax_stage, port_model
from test_torch_sharded_train import G, KINDS, batches, coco_batches, \
    jax_params, port_sd

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
N_STEPS = 3
SHAPES = {2: (1, 2), 4: (2, 2)}
SEED = 11


def train_cases(sd, shape, dropout_seed=None, kinds=KINDS):
    return [("train", dict(kind=k, model_type="rdot_nll", sd=sd,
                           batches=batches(N_STEPS), n_groups=G, shape=shape,
                           dropout_seed=dropout_seed)) for k in kinds]


@pytest.fixture(scope="module")
def sd0():
    return port_sd(jax_params()[1])[0]


@pytest.fixture(scope="module")
def coco_sd():
    _, params = jax_stage()
    return port_model(params).state_dict()


_WORLDS = {}


def _plain(tree):
    """A JAX state's tree as nested dicts of numpy arrays (what a spawned
    rank can unpickle without JAX)."""
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def jax_lamb_state():
    """A JAX LAMB TrainState after 2 'nll' steps on one device, its fields
    as plain namespaces and dicts (models/convert.py::load_jax_train_state
    reads step, params, opt_state's (mu, nu) and count, extra)."""
    from types import SimpleNamespace

    from cocodr_tpu.utils.train_state import TrainState as JaxTrainState

    jmodel, params = jax_params()
    tx = jax_lamb(jax_warmup_linear(workers.LR, workers.WARMUP,
                                    workers.TOTAL), eps=1e-6)
    state = JaxTrainState.create(params, tx)
    step = jax_step(jmodel, tx, JaxStepConfig(loss_kind="nll"))
    for b in batches(2):
        state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()})
    js = jax.device_get(state)
    lamb_state, sched = js.opt_state
    return SimpleNamespace(
        step=np.asarray(js.step), params=_plain(js.params), extra=None,
        opt_state=(SimpleNamespace(mu=_plain(lamb_state.mu),
                                   nu=_plain(lamb_state.nu)),
                   SimpleNamespace(count=np.asarray(sched.count))))


def _world(W, tmp_path_factory, sd0, coco_sd):
    """Each world's cases, spawned once a module: the three kinds without
    dropout, the direct COCO step; at 1x2 also 'nll' and 'idro' with
    dropout, COCO with dropout, and a checkpoint saved at 1x2 then loaded
    at 2x1 and 1x2."""
    if W in _WORLDS:
        return _WORLDS[W]
    shape = SHAPES[W]
    ckpt = str(tmp_path_factory.mktemp(f"ck{W}"))
    cases = train_cases(sd0, shape)
    cases.append(("coco", dict(sd=coco_sd, batches=coco_batches(), chunk=0,
                               heads=HEADS, skip=SKIP, shape=shape)))
    if W == 2:
        cases += train_cases(sd0, shape, SEED, ["nll", "idro"])
        cases.append(("coco", dict(sd=coco_sd, batches=coco_batches(),
                                   chunk=0, heads=HEADS, skip=SKIP,
                                   shape=shape, dropout_seed=SEED)))
        cases += [("tp_checkpoint", dict(sd=sd0, batches=batches(2),
                                         root=ckpt, shape=(1, 2),
                                         save=True)),
                  ("tp_checkpoint", dict(sd=sd0, batches=[], root=ckpt,
                                         shape=(2, 1), save=False)),
                  ("tp_checkpoint", dict(sd=sd0, batches=[], root=ckpt,
                                         shape=(1, 2), save=False)),
                  ("train", dict(train_cases(sd0, shape, SEED, ["nll"])[0][1],
                                 remat_policy="")),
                  ("tp_load_jax", dict(sd=sd0, jax_state=jax_lamb_state(),
                                       shape=shape))]
    out = spawn(workers.run_cases, W, str(tmp_path_factory.mktemp(f"w{W}")),
                cases)
    _WORLDS[W] = W, ckpt, out
    return _WORLDS[W]


@pytest.fixture(scope="module", params=sorted(SHAPES))
def world(request, tmp_path_factory, sd0, coco_sd):
    return _world(request.param, tmp_path_factory, sd0, coco_sd)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, sd0, coco_sd):
    """The world of 2 (1x2), which holds the dropout and checkpoint
    cases."""
    return _world(2, tmp_path_factory, sd0, coco_sd)


@pytest.fixture(scope="module")
def unsplit(sd0, coco_sd):
    """The same cases in a world of one (the port's unsplit steps)."""
    with workers.world_of_one():
        runs = workers.run_cases(
            train_cases(sd0, None)
            + [("coco", dict(sd=coco_sd, batches=coco_batches(), chunk=0,
                             heads=HEADS, skip=SKIP))]
            + train_cases(sd0, None, SEED, ["nll", "idro"])
            + [("coco", dict(sd=coco_sd, batches=coco_batches(), chunk=0,
                             heads=HEADS, skip=SKIP, dropout_seed=SEED))])
    return {"train": dict(zip(KINDS, runs[:3])), "coco": runs[3],
            "dropout": dict(zip(["nll", "idro"], runs[4:6])),
            "coco_dropout": runs[6]}


def jax_tp_run(kind):
    """The JAX step of `kind` under shard_train_init on a 4x2 mesh (its
    parameters split by parallel/tp.py) -> losses, the final parameters
    (port names) and h_fun."""
    jmodel, params = jax_params()
    tx = jax_lamb(jax_warmup_linear(workers.LR, workers.WARMUP,
                                    workers.TOTAL), eps=1e-6)
    dro = JaxDroConfig(n_groups=G) if kind != "nll" else None
    extra = jax_idro_init(dro) if dro else None
    mesh = create_mesh(MeshConfig(data=4, model=2))
    state, put = shard_train_init(mesh, params, tx, extra=extra)
    step = jax_step(jmodel, tx, JaxStepConfig(loss_kind=kind, dro=dro))
    losses = []
    for b in batches(N_STEPS):
        state, m = step(state, put({k: jnp.asarray(v) for k, v in b.items()}))
        losses.append(float(m["loss"]))
    sd, _ = port_sd(state.params)
    h = None if extra is None else np.asarray(state.extra.h_fun)
    return losses, sd, h


def jax_coco_tp_run():
    """3 direct JAX COCO steps under shard_train_init on a 4x2 mesh ->
    (metrics, final parameters in port names)."""
    jmodel, params = jax_stage()
    tx = jax_configs.OptimizerConfig(
        name="adamw", lr=1e-3, warmup_steps=2, total_steps=10,
        weight_decay=0.01).build()
    jstep = jax_coco.build_coco_train_step(
        jmodel, tx, jax_coco.CocoConfig(batch_size=8, max_grad_norm=1.0))
    mesh = create_mesh(MeshConfig(data=4, model=2))
    state, put = shard_train_init(mesh, params, tx)
    metrics = []
    for i, b in enumerate(coco_batches()):
        state, m = jstep(state, put({k: jnp.asarray(v)
                                     for k, v in b.items()}),
                         jax.random.PRNGKey(i))
        metrics.append({k: float(m[k]) for k in ("loss", "mlm_loss",
                                                  "co_loss")})
    want = convert.condenser_state_dict_from_jax(
        jax.device_get(state.params), BertConfig.tiny(), HEADS)
    return metrics, want


@pytest.fixture(scope="module")
def jax_runs():
    return {k: jax_tp_run(k) for k in KINDS}


@pytest.fixture(scope="module")
def jax_coco_steps():
    return jax_coco_tp_run()


def _params_close(got, want):
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], np.asarray(w), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_tp_steps_match_the_jax_tp_step(world, jax_runs, kind):
    """3 steps at 1x2 and 2x2 against the JAX step on a 4x2 mesh: every
    rank's losses, whole final parameters and h_fun within 1e-5."""
    _, _, out = world
    losses, sd, h = jax_runs[kind]
    for rank_out in out:
        got = rank_out[KINDS.index(kind)]
        np.testing.assert_allclose(got["losses"], losses, **TOL)
        _params_close(got["params"], {k: v.numpy() for k, v in sd.items()})
        if h is not None:
            np.testing.assert_allclose(got["h_fun"], h, **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_tp_steps_match_the_unsplit_steps(world, unsplit, kind):
    """Against the port's unsplit steps: losses, parameters, h_fun, the
    clip's global norm each step and every iDRO Gram matrix 1e-5; LAMB's
    trust ratios after the last step 1e-4, but the attention key biases',
    whose gradient is rounding noise (a softmax does not change when one
    adds the same q.b_k to every score of a row), so that their moments
    and ratios are the noise's."""
    _, _, out = world
    want = unsplit["train"][kind]
    for rank_out in out:
        got = rank_out[KINDS.index(kind)]
        np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
        _params_close(got["params"], want["params"])
        np.testing.assert_allclose(got["norms"], want["norms"], **TOL)
        assert len(got["grams"]) == len(want["grams"])
        assert len(got["grams"]) == (N_STEPS if kind == "idro" else 0)
        for g, w in zip(got["grams"], want["grams"]):
            np.testing.assert_allclose(g, w, **TOL)
        assert got["trust"].keys() == want["trust"].keys()
        for name, w in want["trust"].items():
            if "key.bias" not in name:
                np.testing.assert_allclose(got["trust"][name], w, rtol=1e-4,
                                           err_msg=name)


@pytest.mark.parametrize("kind", ["nll", "idro"])
def test_tp_steps_with_dropout_match_the_unsplit_steps(world2, unsplit,
                                                      kind):
    """Dropout 0.1 at 1x2: the split steps draw the unsplit steps' masks,
    so losses, parameters and h_fun stay within 1e-5 of the port's unsplit
    steps (a mask drawn per rank, or the probabilities' mask drawn for
    the rank's heads alone, would not); the masks move the losses."""
    _, _, out = world2
    want = unsplit["dropout"][kind]
    base = unsplit["train"][kind]
    assert not np.allclose(want["losses"], base["losses"], **TOL)
    for rank_out in out:
        got = rank_out[len(KINDS) + 1 + ["nll", "idro"].index(kind)]
        np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
        _params_close(got["params"], want["params"])
        if want["h_fun"] is not None:
            np.testing.assert_allclose(got["h_fun"], want["h_fun"], **TOL)


def test_tp_coco_steps_match_jax_and_the_unsplit_steps(world, unsplit,
                                                       jax_coco_steps):
    """The direct COCO step (the c_head split too, the MLM head not): 3
    steps at 1x2 and 2x2 against the JAX step on a 4x2 mesh and the
    port's unsplit step, loss, mlm_loss, co_loss and the whole parameters
    1e-5; at 1x2 with dropout against the unsplit step with dropout."""
    W, _, out = world
    metrics, want = jax_coco_steps
    runs = [(out_r[len(KINDS)], unsplit["coco"]) for out_r in out]
    if W == 2:
        runs += [(out_r[len(KINDS) + 3], unsplit["coco_dropout"])
                 for out_r in out]
    for got, ref in runs:
        for g, m in zip(got["metrics"], ref["metrics"]):
            for k in m:
                np.testing.assert_allclose(g[k], m[k], **TOL, err_msg=k)
        _params_close(got["params"], ref["params"])
    for got, _ in runs[:len(out)]:
        for g, m in zip(got["metrics"], metrics):
            for k in m:
                np.testing.assert_allclose(g[k], m[k], **TOL, err_msg=k)
        _params_close(got["params"], {k: v.numpy() for k, v in want.items()})


def test_a_checkpoint_is_the_same_whatever_the_mesh(world2, sd0):
    """A checkpoint saved at 1x2 after 2 steps holds the whole tensors:
    loaded at 1x1 (one device; also the one AsyncSaver wrote), at 2x1
    (the same world of 2) and at 1x2 (a split state), the parameters and
    the LAMB moments are equal, bit for bit, to those the 1x2 state
    gathered when it saved."""
    _, ckpt, out = world2
    n = len(KINDS) + 4
    saved = out[0][n]
    assert saved[0] == 2
    loads = [o[n + k] for o in out for k in (1, 2)]
    for root in (ckpt, ckpt + "_async"):  # save_checkpoint, AsyncSaver
        loads.append(workers.tp_checkpoint(sd0, [], root, None, False))
    for step, params, moments in loads:
        assert step == 2
        assert params.keys() == saved[1].keys()
        for k, v in saved[1].items():
            assert np.array_equal(params[k], v), k
        assert moments.keys() == saved[2].keys()
        for k, st in saved[2].items():
            for m, v in st.items():
                assert np.array_equal(moments[k][m], v), (k, m)


def test_tp_steps_under_remat_replay_the_collectives_and_masks(world2,
                                                               unsplit):
    """'nll' at 1x2 with dropout, each layer under remat '' (the backward
    runs the split layer again: its all-reduces and its masks from the
    replayed generator state): losses and parameters within 1e-5 of the
    unsplit steps without remat (remat changes no value)."""
    _, _, out = world2
    want = unsplit["dropout"]["nll"]
    for rank_out in out:
        got = rank_out[len(KINDS) + 7]
        np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
        _params_close(got["params"], want["params"])


def test_load_jax_train_state_onto_a_model_axis(world2, sd0):
    """models/convert.py::load_jax_train_state of a JAX LAMB state into a
    state split at 1x2: its parameters and moments gathered back equal,
    bit for bit, those the same call gives one device."""
    _, _, out = world2
    want = workers.tp_load_jax(sd0, jax_lamb_state(), None)
    for rank_out in out:
        got = rank_out[len(KINDS) + 8]
        assert got[0] == want[0] == 2
        for a, b in ((got[1], want[1]),) + tuple(
                (got[2][k], want[2][k]) for k in want[2]):
            assert a.keys() == b.keys()
            for k in b:
                assert np.array_equal(a[k], b[k]), k
