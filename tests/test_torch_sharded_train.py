"""The port's data-parallel training and encoding at W = 2 and 4 spawned
gloo ranks (parallel/sharded_train.py, pipelines/train_step.py,
losses/contrastive.py and losses/dro.py's collective forms,
pipelines/coco.py, pipelines/encode.py's Encoder(mesh=)) against the JAX
package on tests/conftest.py's fake CPU devices: the JAX steps under
cocodr_tpu/parallel/sharded_train.py::shard_train_init on a mesh of 8
devices compute the global batch's math, as the port's ranks must.

Tolerances: float32 on the CPU, dropout off; losses, parameters and h_fun
1e-5 (sums in another order; the ranks' gradient all-reduce and gathered
statistics add one more order), tests/test_torch_ance.py's tolerance
for the DRO kinds too;
parameters and DroState bit-identical across ranks after every step; the
contrastive loss and its gradient 1e-5; the encodes byte-equal to one
device's."""
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
from cocodr_tpu.losses.contrastive import co_contrastive_loss as jax_co
from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu.optim import lamb as jax_lamb
from cocodr_tpu.optim import warmup_linear as jax_warmup_linear
from cocodr_tpu.parallel.sharded_train import shard_train_init
from cocodr_tpu.pipelines import coco as jax_coco
from cocodr_tpu.pipelines.train_step import TrainStepConfig as JaxStepConfig
from cocodr_tpu.pipelines.train_step import build_train_step as jax_step
from cocodr_tpu_torch.core.mesh import spawn
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig
from cocodr_tpu_torch.models.dual_encoder import MODEL_REGISTRY, DualEncoder
from test_torch_coco import HEADS, SKIP, jax_stage, port_model, step_batch

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
B, SQ, SD, VOCAB, G = 8, 6, 12, 128, 4
N_STEPS = 5
KINDS = ["nll", "dro-greedy", "idro"]


def batches(n=N_STEPS, seed=0):
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


def jax_params(seed=0):
    jmodel = jax_build("rdot_nll", JaxBertConfig.tiny(),
                       head_dim=workers.HEAD_DIM)
    ones = jnp.ones((2, SD), jnp.int32)
    return jmodel, jmodel.init(jax.random.PRNGKey(seed), ones, ones)["params"]


def port_sd(params):
    cfg = MODEL_REGISTRY["rdot_nll"](BertConfig.tiny(),
                                     head_dim=workers.HEAD_DIM)
    return convert.params_from_jax(jax.device_get(params), cfg), cfg


def jax_dp_run(kind):
    """The JAX step of `kind` under shard_train_init on a mesh of 8: the
    losses, the final parameters (port names) and h_fun."""
    jmodel, params = jax_params()
    tx = jax_lamb(jax_warmup_linear(workers.LR, workers.WARMUP,
                                    workers.TOTAL), eps=1e-6)
    dro = JaxDroConfig(n_groups=G) if kind != "nll" else None
    extra = jax_idro_init(dro) if dro else None
    mesh = create_mesh(MeshConfig(data=8, model=1))
    state, put = shard_train_init(mesh, params, tx, extra=extra)
    step = jax_step(jmodel, tx, JaxStepConfig(loss_kind=kind, dro=dro))
    losses = []
    for b in batches():
        state, m = step(state, put({k: jnp.asarray(v) for k, v in b.items()}))
        losses.append(float(m["loss"]))
    sd, _ = port_sd(state.params)
    h = None if extra is None else np.asarray(state.extra.h_fun)
    return losses, sd, h


def contrastive_data():
    return np.random.RandomState(2).randn(8, 8).astype(np.float32)


def encode_data():
    rng = np.random.RandomState(4)
    ids = rng.randint(3, VOCAB, size=(11, 16)).astype(np.int32)
    lens = rng.randint(1, 17, size=11)
    mask = (np.arange(16)[None, :] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


def encode_cases():
    """(case kwargs) of workers.encode: plain, length buckets, and the
    multi-chunk model (3 chunks of 8); the weights drawn from a seed."""
    ids, mask = encode_data()
    out = []
    for mt, kw in (("rdot_nll", {}), ("rdot_nll", {"buckets": (8, 16)}),
                   ("rdot_nll_multi_chunk", {"chunk_len": 8})):
        extra = {"base_len": 8} if mt == "rdot_nll_multi_chunk" else {}
        cfg = MODEL_REGISTRY[mt](BertConfig.tiny(), head_dim=workers.HEAD_DIM,
                                 **extra)
        torch.manual_seed(3)
        sd = DualEncoder(cfg).state_dict()
        w = 24 if mt == "rdot_nll_multi_chunk" else 16
        i = np.tile(ids, (1, w // 16 + 1))[:, :w]
        m = np.tile(mask, (1, w // 16 + 1))[:, :w]
        out.append(dict(model_type=mt, sd=sd, ids=i, mask=m, batch_size=8,
                        **kw))
    out.append(dict(out[0], batch_size=4))
    return out


def coco_batches():
    return [step_batch(seed=i) for i in range(3)]


@pytest.fixture(scope="module")
def sd0():
    return port_sd(jax_params()[1])[0]


@pytest.fixture(scope="module")
def coco_sd():
    _, params = jax_stage()
    return port_model(params).state_dict()


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory, sd0, coco_sd):
    W = request.param
    cases = [("train", dict(kind=k, model_type="rdot_nll", sd=sd0,
                            batches=batches(), n_groups=G)) for k in KINDS]
    cases.append(("contrastive", dict(cls_all=contrastive_data())))
    cases.append(("coco", dict(sd=coco_sd, batches=coco_batches(), chunk=0,
                               heads=HEADS, skip=SKIP)))
    if W == 2:
        cases.append(("coco", dict(sd=coco_sd, batches=coco_batches(),
                                   chunk=2, heads=HEADS, skip=SKIP)))
    cases += [("encode", kw) for kw in encode_cases()]
    cases.append(("broadcast_from_rank_0", dict(batch=batches(1)[0])))
    out = spawn(workers.run_cases, W, str(tmp_path_factory.mktemp(f"s{W}")),
                cases)
    return W, {"train": {k: [o[i] for o in out] for i, k in enumerate(KINDS)},
               "contrastive": [o[3] for o in out],
               "coco": [[o[4] for o in out]]
               + ([[o[5] for o in out]] if W == 2 else []),
               "encode": [[o[i] for o in out]
                          for i in range(len(out[0]) - 5, len(out[0]) - 1)],
               "broadcast": [o[-1] for o in out]}


@pytest.fixture(scope="module")
def jax_runs():
    return {k: jax_dp_run(k) for k in KINDS}


@pytest.mark.parametrize("kind", KINDS)
def test_dp_steps_match_the_jax_sharded_step(world, jax_runs, kind):
    """5 steps of 'nll' (the warmup's), 'dro-greedy' and 'idro' at W
    ranks against the JAX step on a mesh of 8 (global-batch math): every
    rank's losses, final parameters and h_fun within 1e-5."""
    _, out = world
    losses, sd, h = jax_runs[kind]
    for rank_out in out["train"][kind]:
        np.testing.assert_allclose(rank_out["losses"], losses, **TOL)
        for name, w in sd.items():
            np.testing.assert_allclose(rank_out["params"][name], w.numpy(),
                                       **TOL, err_msg=name)
        if h is not None:
            np.testing.assert_allclose(rank_out["h_fun"], h, **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_ranks_stay_bit_identical(world, kind):
    """After every step every rank holds the same parameters and DroState,
    bit for bit (a digest of their bytes a step)."""
    _, out = world
    digests = [r["digests"] for r in out["train"][kind]]
    assert all(d == digests[0] for d in digests)
    assert len(set(digests[0])) == N_STEPS  # the parameters move


def test_contrastive_loss_over_ranks_matches_jax(world):
    """co_contrastive_loss(axis_name=) on each rank's rows: the loss on
    every rank equals the JAX global form's and the JAX shard_map form's
    (pmean); each rank's gradient divided by W equals the JAX shard_map
    gradient of its rows and the global form's gradient of those rows
    (losses/contrastive.py's docstring: the mean all-reduce of a DP step
    divides the W out). 1e-5."""
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    W, out = world
    cls = contrastive_data()
    g_loss, g_grad = jax.value_and_grad(jax_co)(jnp.asarray(cls))
    mesh = Mesh(np.asarray(jax.devices()[:W]), ("data",))
    f = shard_map(lambda x: jax.value_and_grad(
        lambda y: jax_co(y, axis_name="data"))(x),
        mesh=mesh, in_specs=P("data"), out_specs=(P(), P("data")))
    s_loss, s_grad = f(jnp.asarray(cls))
    n = len(cls) // W
    for r, (loss, grad) in enumerate(out["contrastive"]):
        np.testing.assert_allclose(loss, float(g_loss), **TOL)
        np.testing.assert_allclose(loss, float(s_loss), **TOL)
        rows = slice(r * n, (r + 1) * n)
        np.testing.assert_allclose(grad / W, np.asarray(s_grad)[rows], **TOL)
        np.testing.assert_allclose(grad / W, np.asarray(g_grad)[rows], **TOL)


def jax_coco_run(chunk):
    """3 steps of the JAX COCO step on the whole batch, direct (chunk 0) or
    with the grad cache, as tests/test_torch_coco.py::
    test_coco_steps_match_jax builds it -> (metrics, final parameters)."""
    jmodel, params = jax_stage()
    tx = jax_configs.OptimizerConfig(
        name="adamw", lr=1e-3, warmup_steps=2, total_steps=10,
        weight_decay=0.01).build()
    jstep = jax_coco.build_coco_train_step(
        jmodel, tx, jax_coco.CocoConfig(batch_size=8, max_grad_norm=1.0,
                                        cache_chunk_size=chunk))
    from cocodr_tpu.utils.train_state import TrainState as JaxTrainState

    state = JaxTrainState.create(params, tx)
    metrics = []
    for i, b in enumerate(coco_batches()):
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()},
                         jax.random.PRNGKey(i))
        metrics.append({k: float(m[k]) for k in ("loss", "mlm_loss",
                                                  "co_loss")})
    want = convert.condenser_state_dict_from_jax(
        jax.device_get(state.params), BertConfig.tiny(), HEADS)
    return metrics, want


@pytest.fixture(scope="module")
def jax_coco_runs():
    return {0: jax_coco_run(0), 4: jax_coco_run(4)}


def test_coco_steps_over_ranks_match_the_global_step(world, jax_coco_runs):
    """The data-parallel direct COCO step at W ranks and, at W = 2, the
    grad cache (chunks of 2 spans a rank; the ranks' masked counts
    differ): 3 steps against the JAX global steps, loss, mlm_loss, co_loss
    (the direct step's against the JAX direct step, the cache's against
    the JAX cache step, whose mlm_loss counts late MLM in) and the final
    parameters (both against the JAX direct step) 1e-5 on every rank, the
    ranks' params bit-identical after every step."""
    _, out = world
    want = jax_coco_runs[0][1]
    for run, chunk in zip(out["coco"], (0, 4)):
        metrics = jax_coco_runs[chunk][0]
        assert all(r["digests"] == run[0]["digests"] for r in run)
        for rank_out in run:
            for got, m in zip(rank_out["metrics"], metrics):
                for k in m:
                    np.testing.assert_allclose(got[k], m[k], **TOL,
                                               err_msg=k)
            for name, w in want.items():
                np.testing.assert_allclose(rank_out["params"][name],
                                           w.numpy(), **TOL, err_msg=name)


@pytest.mark.parametrize("case", range(3), ids=["plain", "buckets",
                                                 "multi_chunk"])
def test_sharded_encode_is_byte_equal_to_one_device(world, case):
    """encode_cache (plain, length buckets) and encode_cache_multivector
    through Encoder(mesh=) at W ranks: every rank's output equals the
    single-device encode's byte for byte (11 records in batches of 8: the
    trailing batch of 3 padded to 8 and trimmed; every rank encodes at
    least 2 rows a batch)."""
    _, out = world
    kw = encode_cases()[case]
    want = workers.encode(mesh=False, **kw)
    for got in out["encode"][case]:
        if isinstance(want, tuple):
            for a, b in zip(got, want):
                assert a.tobytes() == b.tobytes()
        else:
            assert got.dtype == want.dtype
            assert got.tobytes() == want.tobytes()


def test_sharded_encode_of_one_row_a_rank(world):
    """Batches of 4 records: at W = 4 each rank encodes one row, which the
    CPU's BLAS multiplies by another routine (a matrix-vector product)
    than a batch's, summing in another order: 1e-5 there (the float32
    tolerance of the port's other encode tests), byte-equal at W = 2."""
    W, out = world
    kw = encode_cases()[3]
    want = workers.encode(mesh=False, **kw)
    for got in out["encode"][3]:
        if W == 2:
            assert got.tobytes() == want.tobytes()
        np.testing.assert_allclose(got, want, **TOL)


def test_init_and_setup_give_every_rank_rank_0s_state(world):
    """shard_train_init over ranks whose weights and DroState differ
    (each seeded by its rank) leaves every rank with rank 0's, bit for
    bit (the weights torch.manual_seed(0) draws, h_fun 1);
    shard_train_setup of states that each trained a step on their own
    rows leaves every rank rank 0's parameters and LAMB moments."""
    from cocodr_tpu_torch.losses.dro import DroConfig, idro_init

    _, out = world
    cfg = MODEL_REGISTRY["rdot_nll"](BertConfig.tiny(),
                                     head_dim=workers.HEAD_DIM)
    torch.manual_seed(0)
    model = DualEncoder(cfg)
    h = idro_init(DroConfig(n_groups=4), device="cpu").h_fun
    want = workers._digest(list(model.parameters()) + [h])
    assert [init for init, _ in out["broadcast"]] == [want] * len(
        out["broadcast"])
    setups = {setup for _, setup in out["broadcast"]}
    assert len(setups) == 1
