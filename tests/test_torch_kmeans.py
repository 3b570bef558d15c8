"""The port's k-means (ops/kmeans.py) against the JAX package's
(cocodr_tpu/ops/kmeans.py) on the CPU, float32, and the calibration of
chip_smoke.py's card-against-CPU k-means bounds (`kmeans_walk`).
Tolerances: centroids 1e-5 (sums in another order), assignments equal."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

import chip_smoke
from cocodr_tpu.ops import kmeans as jk
from cocodr_tpu_torch.ops import kmeans as tk

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def blobs(seed, n=600, d=16, c=6, spread=0.3):
    """Planted, well-separated clusters: c centres 10 apart on average,
    points within `spread` of theirs."""
    rng = np.random.RandomState(seed)
    centres = rng.randn(c, d) * 4
    labels = rng.randint(c, size=n)
    x = centres[labels] + spread * rng.randn(n, d)
    return x.astype(np.float32), labels


@pytest.mark.parametrize("duplicated", [False, True])
def test_kmeans_single_matches_jax(duplicated):
    """30 Lloyd steps from a shared init: centroids 1e-5, the assignments
    and inertia equal (inertia 1e-5). With duplicated initial centroids the
    copies' clusters empty (ties take the first), so the rule that re-seeds
    the first empty cluster from the farthest point runs, one cluster a
    step."""
    rng = np.random.RandomState(0)
    x = rng.randn(500, 16).astype(np.float32)
    idx = np.arange(0, 80, 10)
    if duplicated:
        idx[1:4] = idx[0]
    init = x[idx]
    jc, ji, jin = jk._kmeans_single(jnp.asarray(x), jnp.asarray(init), 8, 30)
    tc, ti, tin = tk._kmeans_single(torch.from_numpy(x),
                                    torch.from_numpy(init), 8, 30)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(float(tin), float(jin), rtol=1e-5)
    if duplicated:  # the copies were re-seeded apart
        assert len({tuple(r) for r in np.round(tc.numpy(), 4)}) == 8


def test_lloyd_step_reseeds_one_empty_cluster_a_step():
    """Three copies of one centroid: after one step the first copy takes
    all its points, the second (the first empty) moves to the farthest
    point, the third keeps its place; equal to the JAX step."""
    x, _ = blobs(1)
    init = x[[0, 0, 0, 300]]
    t, _ = tk._lloyd_step(torch.from_numpy(x), torch.from_numpy(init))
    j, _ = jk._lloyd_step(jnp.asarray(x), jnp.asarray(init))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    _, d2 = tk._assign(torch.from_numpy(x), torch.from_numpy(init))
    np.testing.assert_array_equal(t[1].numpy(), x[int(torch.argmax(d2))])
    np.testing.assert_array_equal(t[2].numpy(), init[2])


def same_partition(a, b):
    """a and b label the points alike up to one permutation of labels."""
    a, b = np.asarray(a), np.asarray(b)
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def test_kmeans_finds_jax_partition_and_best_restart():
    """Planted clusters: the port's kmeans (numpy init draws) and the JAX
    one (threefry draws) give one partition up to a label permutation,
    which is the planted one; the port returns the lowest-inertia restart
    of n_redo (each restart rerun here from init_indices), and
    assign_clusters agrees with the JAX one on its centroids."""
    x, labels = blobs(2)
    jc, ja = jk.kmeans(jnp.asarray(x), 6, n_iter=20, n_redo=4, seed=3)
    tc, ta = tk.kmeans(x, 6, n_iter=20, n_redo=4, seed=3, device="cpu")
    assert ta.dtype == torch.int64 and tc.dtype == torch.float32
    assert same_partition(ta.numpy(), np.asarray(ja))
    assert same_partition(ta.numpy(), labels)
    xt = torch.from_numpy(x)
    runs = [tk._kmeans_single(xt, xt[torch.from_numpy(
        tk.init_indices(len(x), 6, 3 + r))], 6, 20) for r in range(4)]
    best = min(range(4), key=lambda r: float(runs[r][2]))
    assert torch.equal(tc, runs[best][0]) and torch.equal(ta, runs[best][1])
    want = jk.assign_clusters(jnp.asarray(x), jnp.asarray(tc.numpy()))
    np.testing.assert_array_equal(tk.assign_clusters(x, tc).numpy(),
                                  np.asarray(want))


def test_best_of_redo_takes_the_lowest_inertia():
    """Crowded data with 3 restarts of 2 steps: the restarts end at other
    inertias, and kmeans returns the assignment of the lowest."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(300, 8).astype(np.float32))
    inertias = [float(tk._kmeans_single(x, x[torch.from_numpy(
        tk.init_indices(300, 5, 7 + r))], 5, 2)[2]) for r in range(3)]
    assert len(set(inertias)) == 3
    best = int(np.argmin(inertias))
    _, ids = tk.kmeans(x, 5, n_iter=2, n_redo=3, seed=7, device="cpu")
    want = tk._kmeans_single(x, x[torch.from_numpy(
        tk.init_indices(300, 5, 7 + best))], 5, 2)[1]
    assert torch.equal(ids, want)


def test_kmeans_turns_tf32_off_and_restores_it(monkeypatch):
    """kmeans, _kmeans_single and assign_clusters run their products with
    TF32 off whatever the caller set, and restore the caller's setting
    (also after an error)."""
    seen = []
    real = tk._assign

    def spy(x, c):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(x, c)

    monkeypatch.setattr(tk, "_assign", spy)
    x, _ = blobs(5, n=60, c=3)
    for flag in (True, False):
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", flag)
        tk.kmeans(x, 3, n_iter=2, device="cpu")
        tk.assign_clusters(x, torch.from_numpy(x[:3]))
        assert torch.backends.cuda.matmul.allow_tf32 is flag
    assert seen and not any(seen)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(ValueError, match="initial centroids"):
        tk._kmeans_single(torch.from_numpy(x), torch.from_numpy(x[:2]), 3, 1)
    assert torch.backends.cuda.matmul.allow_tf32 is True


# --- the card check's bounds ----------------------------------------------

def crowded(seed, n=2048, d=768, rank=128):
    """LayerNorm-scaled points in a narrow cone, shaped like a random
    BERT-base tower's query embeddings (|x|^2 = 768, squared distance to
    the mean 25-34 against 19-51 for the tower's): a common direction plus
    a rank-128 spread and a little noise."""
    rng = np.random.RandomState(seed)
    z = rng.randn(n, rank) @ rng.randn(rank, d) / np.sqrt(rank) * 0.2
    x = rng.randn(d) + z + 0.02 * rng.randn(n, d)
    x = (x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)
    return torch.from_numpy(x.astype(np.float32))


def assign_other_rounding(x, c):
    """The assignment with its product summed in float64 and rounded to
    float32 once: a float32 result of another rounding, as a card's other
    summation order gives."""
    x2 = (x * x).sum(1, keepdim=True)
    c2 = (c * c).sum(1)[None, :]
    d2 = x2 - 2.0 * (x.double() @ c.double().t()).float() + c2
    best, ids = d2.min(1)
    return ids, best.clamp_min(0.0)


def tf32(t):
    """Round float32 to TF32's 10-bit mantissa (nearest, ties away)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def assign_tf32(x, c):
    """The assignment's product of TF32-rounded operands (a matmul with
    TF32 on)."""
    x2 = (x * x).sum(1, keepdim=True)
    c2 = (c * c).sum(1)[None, :]
    d2 = x2 - 2.0 * (tf32(x) @ tf32(c).t()) + c2
    best, ids = d2.min(1)
    return ids, best.clamp_min(0.0)


def lloyd_variant(sums64=False, nearest=False):
    """_lloyd_step with its per-cluster sums summed in float64 and rounded
    once (another rounding: sound), or with the first empty cluster moved
    to the point nearest its centroid, not the farthest (a wrong reseed
    rule)."""
    def step(x, centroids):
        n_clusters = centroids.shape[0]
        ids, d2 = tk._assign(x, centroids)
        onehot = F.one_hot(ids, n_clusters).to(x.dtype)
        counts = onehot.sum(0)
        sums = ((onehot.double().t() @ x.double()).float() if sums64
                else onehot.t() @ x)
        new_c = sums / counts.clamp_min(1.0)[:, None]
        empty = counts == 0
        new_c = torch.where(empty[:, None], centroids, new_c)
        pick = torch.argmin(d2) if nearest else torch.argmax(d2)
        first = torch.argmax(empty.to(torch.int32))
        reseed = (torch.arange(n_clusters) == first) & empty.any()
        return torch.where(reseed[:, None], x[pick][None, :], new_c), d2.sum()
    return step


def step_with(assign, step=tk._lloyd_step):
    """`step` with its assignment computed by `assign`."""
    def run(x, c):
        real = tk._assign
        tk._assign = assign
        try:
            return step(x, c)
        finally:
            tk._assign = real
    return run


def walk(seed, card_assign=tk._assign, card_step=tk._lloyd_step, steps=25):
    """kmeans_walk over crowded(seed) from 50 initial centroids, 5 of them
    copies of the first (their clusters empty, so reseeds run); the 'card'
    side steps with card_step, its assignment by card_assign."""
    x = crowded(seed)
    idx = tk.init_indices(len(x), 50, seed)
    idx[1:6] = idx[0]
    return chip_smoke.kmeans_walk(x, x[torch.from_numpy(idx)], steps,
                                  card_assign,
                                  step_with(card_assign, card_step))[1:]


def passes(flips, inertia, cerr):
    return (flips <= chip_smoke.KMEANS_FLIP_SHARE
            and inertia <= chip_smoke.KMEANS_INERTIA_RTOL
            and cerr <= chip_smoke.KMEANS_CENTROID_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_walk_bounds_pass_another_rounding(seed):
    """float32 products of another rounding on the 'card' side pass
    chip_smoke.py's bounds at every step (readings in its comment); the
    plain version against itself reads 0 everywhere."""
    assert walk(seed) == (0.0, 0.0, 0.0)
    readings = walk(seed, card_assign=assign_other_rounding,
                    card_step=lloyd_variant(sums64=True))
    assert passes(*readings), readings


@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_walk_bounds_fail_tf32_and_a_wrong_reseed(seed, monkeypatch):
    """A TF32-rounded assignment fails the label or inertia bound; a
    reseed from the nearest point fails the centroid bound."""
    flips, inertia, _ = walk(seed, card_assign=assign_tf32)
    assert (flips > chip_smoke.KMEANS_FLIP_SHARE
            or inertia > chip_smoke.KMEANS_INERTIA_RTOL), (flips, inertia)
    readings = walk(seed, card_step=lloyd_variant(nearest=True))
    assert readings[2] > chip_smoke.KMEANS_CENTROID_TOL, readings
