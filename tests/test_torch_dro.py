"""The port's DRO losses (losses/dro.py) against the JAX package's on the
same inputs, made from a seed with numpy: dro_greedy_loss (with and
without weight_ema) over a 5-step state trajectory, idro_loss by
group_grads (float32 and bf16 rows) and by group_gram, per_group_grads
against the vmapped JAX pullback, and dro_state_summary. float32 on the
CPU; tolerance 1e-6 (sums in another order)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocodr_tpu.losses import dro as jd
from cocodr_tpu_torch.losses import dro as td

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
G, B = 6, 32


def assert_state(t, j):
    for name in ("h_fun", "sum_losses", "count_cat"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("weight_ema", [False, True])
def test_dro_greedy_trajectory_matches_jax(weight_ema):
    """Five steps from the initial state, one group left out of every
    batch: robust loss, the group statistics and every state field."""
    cfg_j = jd.DroConfig(n_groups=G, alpha=0.3, weight_ema=weight_ema)
    cfg_t = td.DroConfig(n_groups=G, alpha=0.3, weight_ema=weight_ema)
    js, ts = jd.dro_greedy_init(cfg_j), td.dro_greedy_init(cfg_t, "cpu")
    assert_state(ts, js)
    rng = np.random.RandomState(0)
    for _ in range(5):
        losses = (rng.rand(B) * 2.0).astype(np.float32)
        groups = rng.randint(0, G - 1, size=B).astype(np.int32)
        weights = (rng.rand(B) + 0.5).astype(np.float32)
        jl, js, (jgl, jgc) = jd.dro_greedy_loss(
            jnp.asarray(losses), jnp.asarray(groups), js, cfg_j,
            weights=jnp.asarray(weights))
        tl, ts, (tgl, tgc) = td.dro_greedy_loss(
            torch.from_numpy(losses), torch.from_numpy(groups), ts, cfg_t,
            weights=torch.from_numpy(weights))
        np.testing.assert_allclose(float(tl), float(jl), **TOL)
        np.testing.assert_allclose(tgl.numpy(), np.asarray(jgl), **TOL)
        np.testing.assert_allclose(tgc.numpy(), np.asarray(jgc), **TOL)
        assert_state(ts, js)
    # evaluation mode leaves the state as it is
    _, same, _ = td.dro_greedy_loss(torch.from_numpy(losses),
                                    torch.from_numpy(groups), ts, cfg_t,
                                    training=False)
    assert same is ts


def test_dro_greedy_gradient_matches_jax():
    """d robust / d losses, with weights: the JAX gradient."""
    cfg_j, cfg_t = jd.DroConfig(n_groups=G), td.DroConfig(n_groups=G)
    rng = np.random.RandomState(1)
    losses = rng.rand(B).astype(np.float32)
    groups = rng.randint(0, G, size=B).astype(np.int32)
    weights = (rng.rand(B) + 0.5).astype(np.float32)
    h = rng.uniform(0.1, 2.0, G).astype(np.float32)
    js = jd.dro_greedy_init(cfg_j).replace(h_fun=jnp.asarray(h))
    ts = td.dro_greedy_init(cfg_t, "cpu").replace(h_fun=torch.from_numpy(h))
    jg = jax.grad(lambda l: jd.dro_greedy_loss(
        l, jnp.asarray(groups), js, cfg_j, weights=jnp.asarray(weights))[0])(
        jnp.asarray(losses))
    tl = torch.from_numpy(losses).requires_grad_()
    td.dro_greedy_loss(tl, torch.from_numpy(groups), ts, cfg_t,
                       weights=torch.from_numpy(weights))[0].backward()
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg), **TOL)


def _idro_inputs(seed, P=40):
    rng = np.random.RandomState(seed)
    losses = rng.rand(B).astype(np.float32)
    groups = rng.randint(0, G - 1, size=B).astype(np.int32)  # one empty
    grads = rng.randn(G, P).astype(np.float32)
    grads[G - 1] = 0.0  # the empty group's row, as per_group_grads gives
    h = rng.dirichlet(np.ones(G)).astype(np.float32)
    return losses, groups, grads, h


@pytest.mark.parametrize("form", ["grads_f32", "grads_bf16", "gram"])
def test_idro_loss_matches_jax(form):
    """Three steps of the h_fun trajectory: robust loss (the pre-update
    weights), group statistics, the new state; by float32 rows, by bf16
    rows (normalised in bf16, Gram in float32 sums, as the JAX package
    does) and by the rows' Gram matrix."""
    cfg_j = jd.DroConfig(n_groups=G)
    cfg_t = td.DroConfig(n_groups=G)
    losses, groups, grads, h = _idro_inputs(2)
    js = jd.idro_init(cfg_j).replace(h_fun=jnp.asarray(h))
    ts = td.idro_init(cfg_t, "cpu").replace(h_fun=torch.from_numpy(h))
    for step in range(3):
        jl, jgrads = jnp.asarray(losses + step), jnp.asarray(grads * (step + 1))
        tl, tgrads = torch.from_numpy(losses + step), torch.from_numpy(
            grads * (step + 1))
        if form == "gram":
            jkw = dict(group_gram=jgrads @ jgrads.T)
            tkw = dict(group_gram=tgrads @ tgrads.T)
        elif form == "grads_bf16":
            jkw = dict(group_grads=jgrads.astype(jnp.bfloat16))
            tkw = dict(group_grads=tgrads.to(torch.bfloat16))
        else:
            jkw, tkw = dict(group_grads=jgrads), dict(group_grads=tgrads)
        jr, js, (jgl, jgc) = jd.idro_loss(jl, jnp.asarray(groups), js, cfg_j,
                                          **jkw)
        tr, ts, (tgl, tgc) = td.idro_loss(tl, torch.from_numpy(groups), ts,
                                          cfg_t, **tkw)
        np.testing.assert_allclose(float(tr), float(jr), **TOL)
        np.testing.assert_allclose(tgl.numpy(), np.asarray(jgl), **TOL)
        np.testing.assert_allclose(tgc.numpy(), np.asarray(jgc), **TOL)
        assert_state(ts, js)
    with pytest.raises(ValueError, match="exactly one"):
        td.idro_loss(tl, torch.from_numpy(groups), ts, cfg_t)


def test_idro_robust_loss_gradient_is_the_pre_update_weights():
    """d robust / d loss_i = h_pre[g_i] / count[g_i], as the JAX gradient
    and the port's training cotangent (pipelines/train_step.py::
    idro_backward) both have it."""
    from cocodr_tpu_torch.pipelines.train_step import idro_backward

    cfg_j, cfg_t = jd.DroConfig(n_groups=G), td.DroConfig(n_groups=G)
    losses, groups, grads, h = _idro_inputs(3)
    js = jd.idro_init(cfg_j).replace(h_fun=jnp.asarray(h))
    ts = td.idro_init(cfg_t, "cpu").replace(h_fun=torch.from_numpy(h))
    jg = jax.grad(lambda l: jd.idro_loss(l, jnp.asarray(groups), js, cfg_j,
                                         jnp.asarray(grads))[0])(
        jnp.asarray(losses))
    tl = torch.from_numpy(losses).requires_grad_()
    _, new, (_, gc) = td.idro_loss(tl, torch.from_numpy(groups), ts, cfg_t,
                                   group_grads=torch.from_numpy(grads))
    assert not torch.equal(new.h_fun, ts.h_fun)
    idro_backward(tl, torch.from_numpy(groups), ts.h_fun, gc)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("lane_chunk,dtype", [(0, None), (3, "bfloat16"),
                                              (1, "float32")])
def test_per_group_grads_matches_jax(lane_chunk, dtype):
    """Rows of per-group-mean gradients of losses(w) = (x @ w)^2 against
    the JAX vmapped pullback at each of its lane chunks (the port writes a
    row per product, whatever the JAX chunk), with an empty group (zero
    row); bf16 rows equal the JAX bf16 rows exactly."""
    D = 8
    rng = np.random.RandomState(4)
    x = rng.randn(B, D).astype(np.float32)
    w = rng.randn(D).astype(np.float32)
    groups = rng.randint(0, G - 1, size=B).astype(np.int32)
    _, pullback = jax.vjp(lambda w_: jnp.square(jnp.asarray(x) @ w_),
                          jnp.asarray(w))
    want = np.asarray(jd.per_group_grads(
        pullback, jnp.asarray(groups), G, lane_chunk=lane_chunk,
        store_dtype=None if dtype is None else jnp.dtype(dtype)
    ).astype(jnp.float32))
    tw = torch.from_numpy(w).requires_grad_()
    losses = torch.square(torch.from_numpy(x) @ tw)
    got = td.per_group_grads(losses, [tw], torch.from_numpy(groups), G,
                             store_dtype=None if dtype is None
                             else getattr(torch, dtype))
    assert got.dtype == (torch.float32 if dtype is None
                         else getattr(torch, dtype))
    assert not got[G - 1].any()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    assert tw.grad is None  # the products leave .grad alone


def test_gram_of_bf16_rows_sums_in_float32(monkeypatch):
    """gram() and the row norms over more columns than one block (blocks
    of 64 here): float32 sums of the exact products of bf16 values,
    against float64, 1e-6."""
    monkeypatch.setattr(td, "_GRAM_COLUMNS", 64)
    rng = np.random.RandomState(5)
    rows = torch.from_numpy(rng.randn(3, 200).astype(np.float32)).to(
        torch.bfloat16)
    want = rows.double() @ rows.double().t()
    np.testing.assert_allclose(td.gram(rows).numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(td._row_norms(rows).numpy()[:, 0],
                               want.diagonal().sqrt().numpy(), **TOL)


def test_dro_state_summary_matches_jax():
    rng = np.random.RandomState(6)
    h, sl, cc = (rng.rand(G).astype(np.float32) for _ in range(3))
    want = jd.dro_state_summary(jd.DroState(jnp.asarray(h), jnp.asarray(sl),
                                            jnp.asarray(cc)))
    got = td.dro_state_summary(td.DroState(torch.from_numpy(h),
                                           torch.from_numpy(sl),
                                           torch.from_numpy(cc)))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **TOL, err_msg=k)


def test_axis_name_and_missing_card_raise(monkeypatch):
    """axis_name raised naming item 11 until the multi-device slice; over
    a world of one process the collective forms give the single-replica
    state bit for bit, and the Gram form refuses an axis, as the JAX
    assert does (W = 2 and 4: tests/test_torch_sharded_train.py). Without
    a card the inits raise."""
    import torch_mesh_workers as workers

    cfg = td.DroConfig(n_groups=G)
    st = td.dro_greedy_init(cfg, "cpu")
    rng = np.random.RandomState(0)
    l = torch.from_numpy(rng.rand(6).astype(np.float32))
    g = torch.from_numpy(rng.randint(0, G, 6))
    rows = torch.from_numpy(rng.randn(G, 5).astype(np.float32))
    with workers.world_of_one() as mesh:
        for fn, kw in ((td.dro_greedy_loss, {}),
                       (td.idro_loss, {"group_grads": rows})):
            want = fn(l, g, st, cfg, **kw)
            got = fn(l, g, st, cfg, axis_name=mesh, **kw)
            assert torch.equal(got[0], want[0])
            for f in ("h_fun", "sum_losses", "count_cat"):
                assert torch.equal(getattr(got[1], f), getattr(want[1], f))
        with pytest.raises(ValueError, match="group_gram"):
            td.idro_loss(l, g, st, cfg, group_gram=torch.eye(G),
                         axis_name=mesh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.idro_init(cfg)
