"""K-means on device (lax.scan over fixed iterations).

Replaces sklearn.cluster.KMeans used for cluster-prototype construction
(code/search_image.py:185-232 `get_cluster_features`, k=2) and the
silhouette scan (code/search_image.py:234-293). Fixed iteration count and
static shapes keep it jit-friendly; k-means++-style seeding is replaced by
deterministic farthest-point seeding for reproducibility.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("k", "iters"))
def kmeans(
    x: jnp.ndarray,  # [N, D]
    k: int,
    iters: int = 25,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (centroids [k, D], assignments [N])."""
    x = x.astype(jnp.float32)
    n = x.shape[0]

    # Farthest-point initial centroids (deterministic).
    def seed_body(carry, _):
        cents, dists = carry
        idx = jnp.argmax(dists)
        new_c = x[idx]
        cents = jnp.roll(cents, 1, axis=0).at[0].set(new_c)
        d_new = jnp.sum((x - new_c[None, :]) ** 2, axis=1)
        return (cents, jnp.minimum(dists, d_new)), None

    init_c = jnp.tile(x[0][None, :], (k, 1))
    d0 = jnp.sum((x - x[0][None, :]) ** 2, axis=1)
    (cents, _), _ = jax.lax.scan(seed_body, (init_c, d0), None, length=k - 1)

    def em_body(cents, _):
        # [N, k] squared distances via matmul expansion
        x2 = jnp.sum(x * x, axis=1, keepdims=True)
        c2 = jnp.sum(cents * cents, axis=1)[None, :]
        xc = x @ cents.T
        d = x2 + c2 - 2.0 * xc
        assign = jnp.argmin(d, axis=1)
        onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32)  # [N, k]
        counts = jnp.sum(onehot, axis=0)  # [k]
        sums = onehot.T @ x               # [k, D]
        new_cents = jnp.where(
            counts[:, None] > 0, sums / jnp.maximum(counts[:, None], 1.0), cents
        )
        return new_cents, None

    cents, _ = jax.lax.scan(em_body, cents, None, length=iters)

    x2 = jnp.sum(x * x, axis=1, keepdims=True)
    c2 = jnp.sum(cents * cents, axis=1)[None, :]
    d = x2 + c2 - 2.0 * (x @ cents.T)
    assign = jnp.argmin(d, axis=1)
    return cents, assign


def silhouette_score(x: jnp.ndarray, assign: jnp.ndarray, k: int) -> jnp.ndarray:
    """Mean silhouette coefficient (used by the reference's k-scan,
    code/search_image.py:234-293). O(N^2) pairwise distances — intended for
    the small k-shot sets it is applied to."""
    x = x.astype(jnp.float32)
    n = x.shape[0]
    x2 = jnp.sum(x * x, axis=1)
    d = jnp.sqrt(jnp.maximum(x2[:, None] + x2[None, :] - 2.0 * (x @ x.T), 0.0))
    onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32)  # [N, k]
    counts = jnp.sum(onehot, axis=0)  # [k]
    # Mean distance from each point to each cluster: [N, k]
    sums = d @ onehot
    own_count = counts[assign]
    # a: mean intra-cluster distance excluding self
    a = (sums[jnp.arange(n), assign]) / jnp.maximum(own_count - 1.0, 1.0)
    # b: min mean distance to other clusters. EMPTY clusters must read
    # +inf, not 0 (their sums column is exactly 0, which would force
    # b=0 and s=-1 for every point — sklearn errors on empty clusters;
    # we exclude them so the k-scan sees the true silhouette)
    mean_to = jnp.where(counts[None, :] > 0,
                        sums / jnp.maximum(counts[None, :], 1.0), jnp.inf)
    mask = jax.nn.one_hot(assign, k, dtype=jnp.bool_)
    b = jnp.min(jnp.where(mask, jnp.inf, mean_to), axis=1)
    s = jnp.where(own_count > 1, (b - a) / jnp.maximum(jnp.maximum(a, b), 1e-12), 0.0)
    return jnp.mean(s)
