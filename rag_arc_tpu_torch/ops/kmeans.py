"""k-means (Lloyd's) for IVF training on the device (counterpart of
``rag_arc_tpu/ops/kmeans.py``).

The sampling and the kmeans++ seeding are numpy, copied from the JAX
package, so the training sample and the initial centres are bit-equal to
its. Each Lloyd iteration is a few torch ops on the given device: the
(N, k) f32 cross product, ``argmin`` (first index on ties, as
``jnp.argmin``), ``index_add_`` for ``segment_sum``, and the empty-cluster
repair from the globally farthest points (``torch.argsort(-d,
stable=True)`` for ``jnp.argsort``). The products are true f32 under
``ops/bm25.py::full_f32_matmul``, whatever the caller set for TF32.

On the card ``index_add_`` adds with atomics in no fixed order, so the
centroids may differ by a few ULPs from run to run (and from the JAX
package's, whose sums run in another order); the assignments they give
differ only where a row lies that close to two centroids.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from rag_arc_tpu_torch.ops.bm25 import full_f32_matmul

ASSIGN_CHUNK = 1 << 18  # rows assigned per product


def _kmeans_run(
    x: torch.Tensor, init: torch.Tensor, n_clusters: int, n_iters: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd iterations on ``x`` (N, d) f32 from ``init`` (k, d). Returns
    (centroids (k, d), assignments (N,) int64)."""
    x_sq = torch.sum(x * x, dim=1)
    ones = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    centroids = init
    with full_f32_matmul():
        for _ in range(n_iters):
            c_sq = torch.sum(centroids * centroids, dim=1)
            # squared distance up to the constant x_sq: -2 x·c + ||c||²
            d2 = c_sq[None, :] - 2.0 * (x @ centroids.T)
            assign = torch.argmin(d2, dim=1)
            sums = torch.zeros_like(centroids).index_add_(0, assign, x)
            counts = torch.zeros(n_clusters, dtype=torch.float32, device=x.device)
            counts.index_add_(0, assign, ones)
            new_centroids = sums / torch.clamp(counts, min=1.0)[:, None]
            # empty-cluster repair: take the globally farthest points
            dist_to_own = torch.gather(d2, 1, assign[:, None])[:, 0] + x_sq
            far_idx = torch.argsort(-dist_to_own, stable=True)[:n_clusters]
            empty = counts < 1.0
            centroids = torch.where(empty[:, None], x[far_idx], new_centroids)
        assign = _assign_chunk(x, centroids)
    return centroids, assign


def kmeans(
    x: np.ndarray,
    n_clusters: int,
    n_iters: int = 10,
    sample_size: int = 131072,
    seed: int = 0,
    *,
    device: torch.device | str,
) -> Tuple[np.ndarray, np.ndarray]:
    """Train on (a sample of) x; assign all rows. Returns
    (centroids (k, d) f32, assignments (N,) i32)."""
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[0]
    if n < n_clusters:
        raise ValueError(f"need at least {n_clusters} points, got {n}")
    rng = np.random.default_rng(seed)
    train = x
    if n > sample_size:
        train = x[rng.choice(n, size=sample_size, replace=False)]
    # kmeans++ costs k sequential distance passes over its input; seed it
    # on a bounded subsample (>= 8 points per center)
    init_pool = train
    init_cap = max(n_clusters * 8, 8192)
    if len(init_pool) > init_cap:
        init_pool = init_pool[rng.choice(len(init_pool), size=init_cap, replace=False)]
    init = _kmeans_pp_init(init_pool, n_clusters, rng)
    device = torch.device(device)
    centroids, _ = _kmeans_run(
        torch.from_numpy(np.ascontiguousarray(train)).to(device),
        torch.from_numpy(init).to(device), n_clusters, n_iters,
    )
    # assign the full corpus in chunks, one upload each
    assign = np.empty(n, dtype=np.int32)
    with full_f32_matmul():
        for start in range(0, n, ASSIGN_CHUNK):
            part = torch.from_numpy(x[start : start + ASSIGN_CHUNK]).to(device)
            assign[start : start + ASSIGN_CHUNK] = (
                _assign_chunk(part, centroids).to(torch.int32).cpu().numpy()
            )
    return centroids.cpu().numpy(), assign


def _kmeans_pp_init(
    x: np.ndarray, n_clusters: int, rng: np.random.Generator
) -> np.ndarray:
    """kmeans++ seeding: each next center drawn ∝ squared distance to the
    nearest existing center."""
    n = x.shape[0]
    centers = np.empty((n_clusters, x.shape[1]), dtype=np.float32)
    centers[0] = x[rng.integers(n)]
    d2 = ((x - centers[0]) ** 2).sum(axis=1)
    for i in range(1, n_clusters):
        probs = d2 / max(d2.sum(), 1e-12)
        centers[i] = x[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, ((x - centers[i]) ** 2).sum(axis=1))
    return centers


def _assign_chunk(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row (first on ties): one product and an
    ``argmin``. The caller holds ``full_f32_matmul``."""
    c_sq = torch.sum(centroids * centroids, dim=1)
    return torch.argmin(c_sq[None, :] - 2.0 * (x @ centroids.T), dim=1)
