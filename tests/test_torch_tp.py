"""Tensor parallelism (cocodr_tpu_torch/parallel/tp.py): the split table,
the split forward against the JAX package's (tests/test_tp.py's
`shard_params_tp` forward on a 4x2 mesh of tests/conftest.py's 8 fake CPU
devices), and the split forms of K1 and K5 (ops/ffn.py): their plain
versions against the unsplit plain versions, their autograd Functions on
spawned gloo ranks against the unsplit `ffn_block` / `ffn`.

Tolerances: the forward atol 2e-5, rtol 1e-4 (tests/test_tp.py's; float32,
the split sums the partial products over the ranks in another order);
the plain split forms against the unsplit ones bit-equal at M = 1 and 1e-6
in float32 at M = 2 and 4; in bf16 at bert-base widths the split sum stays
under chip_smoke.py's limits for K1 and K5 (two bf16 ulps of the largest
output, 5% of outputs differing); the gradients 1e-5 (float32)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_mesh_workers as workers
from cocodr_tpu.core.mesh import DATA_AXIS, MODEL_AXIS
from cocodr_tpu.models.bert import BertConfig as JaxBertConfig
from cocodr_tpu.models.dual_encoder import build_dual_encoder as jax_build
from cocodr_tpu.parallel.tp import shard_params_tp as jax_shard_params_tp
from cocodr_tpu_torch.core.mesh import spawn
from cocodr_tpu_torch.models import convert
from cocodr_tpu_torch.models.bert import BertConfig
from cocodr_tpu_torch.models.dual_encoder import MODEL_REGISTRY, DualEncoder
from cocodr_tpu_torch.ops import ffn as tffn
from cocodr_tpu_torch.parallel import tp

torch.set_num_threads(1)

FWD_TOL = dict(atol=2e-5, rtol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 8, 16
SHAPES = {2: (1, 2), 4: (2, 2)}  # world size -> (data, model)
IMPLS = ["einsum", "fused"]


def records():
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 100, size=(B, S)).astype(np.int32)
    lens = rng.randint(S // 2, S + 1, size=B)
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


def jax_params():
    jmodel = jax_build("rdot_nll", JaxBertConfig.tiny(),
                       head_dim=workers.HEAD_DIM)
    ids, mask = records()
    return jmodel, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids[:1]),
                               jnp.asarray(mask[:1]))["params"]


def port_sd():
    _, params = jax_params()
    cfg = MODEL_REGISTRY["rdot_nll"](BertConfig.tiny(),
                                     head_dim=workers.HEAD_DIM)
    return convert.params_from_jax(jax.device_get(params), cfg)


def ffn_inputs(T=24, H=32, F=64, seed=0):
    """r [T, H] and a half-layer's weights in nn.Linear layout, float32."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return [f(T, H), 1 + 0.1 * f(H), 0.1 * f(H), 0.1 * f(F, H), 0.1 * f(F),
            0.1 * f(H, F), 0.1 * f(H), 1 + 0.1 * f(H), 0.1 * f(H)]


def k5_inputs(T=24, H=32, F=64, seed=1):
    x, _, _, w1, b1, w2, b2, _, _ = ffn_inputs(T, H, F, seed)
    return [x, w1, b1, w2, b2]


def cotangent(T=24, H=32):
    return np.random.RandomState(5).randn(T, H).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(SHAPES))
def world(request, tmp_path_factory):
    W = request.param
    sd = port_sd()
    ids, mask = records()
    cases = [("tp_forward", dict(model_type="rdot_nll", sd=sd, ids=ids,
                                 mask=mask, shape=SHAPES[W],
                                 attention_impl=impl)) for impl in IMPLS]
    cases += [("tp_ffn_grads", dict(inputs=inputs, cotangent=cotangent(),
                                    shape=SHAPES[W], block=block))
              for inputs, block in ((ffn_inputs(), True),
                                    (k5_inputs(), False))]
    out = spawn(workers.run_cases, W, str(tmp_path_factory.mktemp(f"t{W}")),
                cases)
    return W, out


def test_split_table_covers_the_hot_parameters():
    """tests/test_tp.py's table in nn.Linear layout: query / key / value
    split their rows (the heads) and bias, the attention output and
    output.dense their columns, intermediate its rows and bias; biases of
    the column-split layers, LayerNorms, embeddings and the head stay
    whole; a Condenser's c_head layers split by the same rules, its MLM
    head not."""
    from cocodr_tpu_torch.models.condenser import CoCondenserForPretraining

    cfg = MODEL_REGISTRY["rdot_nll"](BertConfig.tiny(), head_dim=16)
    specs = tp.tp_param_shardings(DualEncoder(cfg))
    layer = "encoder.encoder.layer.0."
    want = {"attention.self.query.weight": 0, "attention.self.key.bias": 0,
            "attention.output.dense.weight": 1,
            "attention.output.dense.bias": None,
            "intermediate.dense.weight": 0, "intermediate.dense.bias": 0,
            "output.dense.weight": 1, "output.dense.bias": None,
            "output.LayerNorm.weight": None}
    for name, dim in want.items():
        assert specs[layer + name] == dim, name
    assert specs["encoder.embeddings.word_embeddings.weight"] is None
    assert sum(d is not None for d in specs.values()) == 10 * 2
    coco = tp.tp_param_shardings(CoCondenserForPretraining(
        BertConfig.tiny(), 1, 1, True))
    assert coco["c_head.0.intermediate.dense.weight"] == 0
    assert all(d is None for k, d in coco.items() if k.startswith("cls."))


@pytest.mark.parametrize("impl", IMPLS)
def test_tp_forward_matches_the_jax_tp_forward(world, impl):
    """The port's split forward at 1x2 and 2x2 (einsum attention, and K8's
    plain version on N/M heads) against the JAX model's forward with
    shard_params_tp on a 4x2 mesh, query and body towers, on every rank:
    atol 2e-5, rtol 1e-4."""
    W, out = world
    jmodel, params = jax_params()
    ids, mask = records()
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                (DATA_AXIS, MODEL_AXIS))
    with mesh:
        p_tp = jax_shard_params_tp(params, mesh)
        rows = NamedSharding(mesh, P(DATA_AXIS))
        i = jax.device_put(jnp.asarray(ids), rows)
        m = jax.device_put(jnp.asarray(mask), rows)
        want = [np.asarray(jax.jit(lambda p, a, b, f=f: jmodel.apply(
            {"params": p}, a, b, method=f))(p_tp, i, m))
            for f in (jmodel.query_emb, jmodel.body_emb)]
    for rank_out in out:
        got = rank_out[IMPLS.index(impl)]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **FWD_TOL)


@pytest.mark.parametrize("M", [1, 2, 4])
def test_split_k1_plain_sums_to_the_unsplit_plain(M):
    """ffn_block_partial_reference over M slices of w1 / b1 (rows) and w2
    (columns), the float32 partials summed, then
    ffn_block_finish_reference: bit-equal to ffn_block_reference at
    M = 1, 1e-6 at M = 2 and 4 (float32)."""
    r, s1, c1, w1, b1, w2, b2, s2, c2 = map(torch.from_numpy, ffn_inputs())
    k = w1.shape[0] // M
    y, stats = 0, None
    for m in range(M):
        sl = slice(m * k, (m + 1) * k)
        part, stats = tffn.ffn_block_partial_reference(
            r, s1, c1, w1[sl], b1[sl], w2[:, sl])
        y = y + part
    got = tffn.ffn_block_finish_reference(r, stats, s1, c1, y, b2, s2, c2)
    want = tffn.ffn_block_reference(r, s1, c1, w1, b1, w2, b2, s2, c2)
    if M == 1:
        assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("M", [1, 2, 4])
def test_split_k5_plain_sums_to_the_unsplit_plain(M):
    """ffn_partial_reference over M slices, summed, then
    ffn_finish_reference: bit-equal to ffn_reference at M = 1, 1e-6 at
    M = 2 and 4 (float32)."""
    x, w1, b1, w2, b2 = map(torch.from_numpy, k5_inputs())
    k = w1.shape[0] // M
    y = sum(tffn.ffn_partial_reference(x, w1[m * k:(m + 1) * k],
                                       b1[m * k:(m + 1) * k],
                                       w2[:, m * k:(m + 1) * k])
            for m in range(M))
    got = tffn.ffn_finish_reference(y, b2)
    want = tffn.ffn_reference(x, w1, b1, w2, b2)
    if M == 1:
        assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("M", [2, 4])
def test_split_sums_stay_inside_chip_smokes_limits_in_bf16(M):
    """What chip_smoke.py holds the card's split forms to, after the sum,
    against the unsplit kernels: at bert-base widths in bf16 (T = 128,
    F/M = 1536 and 768) the split K1 differs from the unsplit plain K1 in
    under 5% of its outputs and by at most two bf16 ulps of its largest
    output (K1's limits), the split K5 likewise from the unsplit plain K5
    (K5's). The wrappers' CPU path takes these plain versions."""
    from test_torch_ffn import _bert_base_block

    bf = torch.bfloat16
    r, s1, c1, w1, b1, w2, b2, s2, c2 = _bert_base_block()
    r, w1, b1, w2, b2 = (t.to(bf) for t in (r, w1, b1, w2, b2))
    k = w1.shape[0] // M
    parts = [tffn.fused_ffn_block_partial(r, s1, c1, w1[m * k:(m + 1) * k],
                                          b1[m * k:(m + 1) * k],
                                          w2[:, m * k:(m + 1) * k].contiguous())
             for m in range(M)]
    y = sum(p for p, _ in parts)
    got = tffn.fused_ffn_block_finish(r, parts[0][1], s1, c1, y, b2, s2,
                                      c2).float()
    want = tffn.ffn_block_reference(r, s1, c1, w1, b1, w2, b2, s2,
                                    c2).float()
    diff = (got - want).abs()
    assert (diff > 0).float().mean().item() < 0.05
    assert diff.max().item() <= 2.0 ** -6 * want.abs().max().item()
    x = r
    y5 = sum(tffn.fused_ffn_partial(x, w1[m * k:(m + 1) * k],
                                    b1[m * k:(m + 1) * k],
                                    w2[:, m * k:(m + 1) * k].contiguous())
             for m in range(M))
    got5 = tffn.fused_ffn_finish(y5, b2).float()
    want5 = tffn.ffn_reference(x, w1, b1, w2, b2).float()
    diff5 = (got5 - want5).abs()
    assert (diff5 > 0).float().mean().item() < 0.05
    assert diff5.max().item() <= 2.0 ** -6 * want5.abs().max().item()


def test_cpu_wrappers_of_the_split_forms_launch_nothing():
    """On CPU tensors the split wrappers take their plain versions and
    count no launch."""
    counters = (tffn.fused_ffn_block_partial, tffn.fused_ffn_block_finish,
                tffn.fused_ffn_partial, tffn.fused_ffn_finish)
    before = [c.launches for c in counters]
    r, s1, c1, w1, b1, w2, b2, s2, c2 = map(torch.from_numpy, ffn_inputs())
    y, st = tffn.fused_ffn_block_partial(r, s1, c1, w1, b1, w2)
    tffn.fused_ffn_block_finish(r, st, s1, c1, y, b2, s2, c2)
    tffn.fused_ffn_finish(tffn.fused_ffn_partial(r, w1, b1, w2), b2)
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("block", [True, False], ids=["k1", "k5"])
def test_split_autograd_functions_match_the_unsplit(world, block):
    """ffn_block_tp (the split K1) and ffn_tp (the split K5) at 1x2 and
    2x2, each model rank with its slices of the same inputs: the output
    and every input's gradient (the split weights' whole) against the
    unsplit ffn_block / ffn on one process, 1e-5, on every rank. The
    gradient of r (block) or x (K5) is the residual's, counted once, plus
    the two model ranks' FFN gradients summed by f: it equals the unsplit
    gradient, and differs from what one rank's FFN alone gives."""
    _, out = world
    inputs = ffn_inputs() if block else k5_inputs()
    full = [torch.from_numpy(a).requires_grad_() for a in inputs]
    ct = torch.from_numpy(cotangent())
    fn = tffn.ffn_block if block else tffn.ffn
    want = fn(*full)
    (want * ct).sum().backward()
    for rank_out in out:
        got, grads = rank_out[len(IMPLS) + (0 if block else 1)]
        np.testing.assert_allclose(got, want.detach().numpy(), **TOL)
        for g, t in zip(grads, full):
            np.testing.assert_allclose(g, t.grad.numpy(), **TOL)
    # one rank's FFN alone misses the other's share of dL/dr
    half = [t.detach().clone().requires_grad_() for t in full]
    sl = {3: 0, 4: 0, 5: 1} if block else {1: 0, 2: 0, 3: 1}
    local = [t.narrow(sl[i], 0, t.shape[sl[i]] // 2) if i in sl else t
             for i, t in enumerate(half)]
    args = (*local, "gelu", 1e-12) if block else (*local, "gelu")
    (((tffn.ffn_block_tp if block else tffn.ffn_tp)(*args)) * ct).sum(
        ).backward()
    assert not np.allclose(half[0].grad.numpy(), full[0].grad.numpy(),
                           **TOL)
