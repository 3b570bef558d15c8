"""L2 k-means (Lloyd) for iDRO query clustering: the counterpart of
cocodr_tpu/ops/kmeans.py, which replaces `faiss.Kmeans` (reference
ANCE/drivers/run_ann_data_gen.py:340-373: d=768, n_clusters=50,
niter=500, nredo=5; assignment via index.search).

The JAX package computes k-means in XLA with no Pallas kernel, so this is
plain torch on the device of `x`. One Lloyd step is one [N, C] distance
product, an argmin, and the per-cluster sums; the best of `n_redo`
restarts by inertia wins. Empty clusters keep their old centroid, and at
most one of them per step, the first, is re-seeded from the point
farthest from its centroid.

Two choices keep the card's result deterministic and close to the float32
plain version on the CPU:
- the per-cluster sums are a one-hot product, onehot(ids)^T @ x ([C, N] x
  [N, D]), where `index_add_`/`scatter_add_` would sum by atomics on the
  card, in another order every run;
- both products run in float32 with TF32 off (saved, cleared and restored
  around each call): the assignment's x2 - 2xc + c2 cancels, and TF32's
  10-bit mantissa moves points near a boundary.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cocodr_tpu_torch.ops._device import resolve_device


def _float32_products(fn):
    """Run fn with TF32 off for float32 matmuls, whatever the caller set."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
    return wrapped


def _assign(x, centroids):
    """argmin_c ||x - c||^2 via x2 - 2xc + c2 -> (ids [N] int64, the
    squared distances [N] clamped at 0); ties take the first centroid."""
    x2 = (x * x).sum(1, keepdim=True)  # [N, 1]
    c2 = (centroids * centroids).sum(1)[None, :]  # [1, C]
    d2 = x2 - 2.0 * (x @ centroids.t()) + c2  # [N, C]
    best, ids = d2.min(1)
    return ids, best.clamp_min(0.0)


def _lloyd_step(x, centroids):
    """-> (new centroids, inertia before the update)."""
    n_clusters = centroids.shape[0]
    ids, d2 = _assign(x, centroids)
    onehot = F.one_hot(ids, n_clusters).to(x.dtype)  # [N, C]
    counts = onehot.sum(0)
    sums = onehot.t() @ x  # [C, D], deterministic (no atomics)
    new_c = sums / counts.clamp_min(1.0)[:, None]
    empty = counts == 0
    new_c = torch.where(empty[:, None], centroids, new_c)
    # re-seed the first empty cluster, if any, from the point farthest
    # from its centroid (argmax takes the first index on ties)
    far_pt = x[torch.argmax(d2)]
    first = torch.argmax(empty.to(torch.int32))
    reseed = ((torch.arange(n_clusters, device=x.device) == first)
              & empty.any())
    new_c = torch.where(reseed[:, None], far_pt[None, :], new_c)
    return new_c, d2.sum()


@_float32_products
def _kmeans_single(x, init_centroids, n_clusters: int, n_iter: int):
    """n_iter Lloyd steps from init_centroids -> (centroids [C, D], ids
    [N], inertia of the final assignment, a 0-d tensor)."""
    if init_centroids.shape[0] != n_clusters:
        raise ValueError(f"{init_centroids.shape[0]} initial centroids for "
                         f"n_clusters={n_clusters}")
    c = init_centroids
    for _ in range(n_iter):
        c, _ = _lloyd_step(x, c)
    ids, d2 = _assign(x, c)
    return c, ids, d2.sum()


def init_indices(n: int, n_clusters: int, seed: int) -> np.ndarray:
    """Restart r's initial centroids: rows RandomState(seed + r).choice(n,
    n_clusters, replace=False) of x (the JAX package draws them with
    jax.random.choice, a threefry stream, so the two packages start from
    other rows of the same seed)."""
    return np.random.RandomState(seed).choice(n, n_clusters, replace=False)


@_float32_products
def kmeans(x, n_clusters: int, n_iter: int = 100, n_redo: int = 1,
           seed: int = 0, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """k-means of x [N, D] (numpy or a tensor) on `device` (the card unless
    the caller passes device="cpu") -> (centroids [C, D] float32,
    assignments [N] int64), both on that device. The best of n_redo
    restarts by inertia (the first on ties); restart r starts from the
    rows init_indices(N, n_clusters, seed + r)."""
    dev = resolve_device(device)
    x = torch.as_tensor(x).to(dev, torch.float32)
    best = None
    for r in range(n_redo):
        idx = torch.from_numpy(init_indices(x.shape[0], n_clusters, seed + r))
        centroids, ids, inertia = _kmeans_single(x, x[idx.to(dev)],
                                                 n_clusters, n_iter)
        inertia = float(inertia)
        if best is None or inertia < best[2]:
            best = (centroids, ids, inertia)
    return best[0], best[1]


@_float32_products
def assign_clusters(x, centroids):
    """Nearest-centroid assignment [N] int64 (the miner's index.search over
    the centroids), on the centroids' device."""
    x = torch.as_tensor(x).to(centroids.device, torch.float32)
    ids, _ = _assign(x, centroids.float())
    return ids
