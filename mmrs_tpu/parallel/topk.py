"""Distributed top-k over a row-sharded gallery.

SURVEY.md §5's design, implemented: queries are replicated, each chip runs
the fused `cosine_topk` over ITS gallery shard (local indices +
shard offset -> global row ids), the per-shard [Q, k] candidates are
all-gathered (k * n_shards values — tiny), and the final top-k
merge happens on every chip redundantly (cheaper than a host round-trip).
One jitted shard_map; no host involvement.

Ragged galleries (N not divisible by the shard count — every real index)
are padded with zero rows to the next multiple and masked by global row id
inside the merge, so any N runs on any mesh. The int8-quantized gallery
(ops/quant.py) composes with the mesh the same way: int8 rows + f32 scales
are both row-sharded, each chip runs the fused quantized kernel on its
shard, and the merge is identical.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from mmrs_tpu.ops.topk import NEG_INF, cosine_topk
from mmrs_tpu.parallel.mesh import DATA_AXIS


def padded_rows(n: int, n_shards: int) -> int:
    return ((n + n_shards - 1) // n_shards) * n_shards


def _pad_rows(x: jnp.ndarray, rows: int) -> jnp.ndarray:
    if x.shape[0] == rows:
        return x
    return jnp.pad(x, [(0, rows - x.shape[0])] + [(0, 0)] * (x.ndim - 1))


def _merge_shard_candidates(vals, idxs, k, axis, rows_per_shard, n_valid):
    """Mask out-of-range / missing candidates, all-gather over the shard
    axis and take the global top-k (replicated on every shard)."""
    shard_id = jax.lax.axis_index(axis)
    gidx = idxs + shard_id * rows_per_shard            # local -> global rows
    invalid = (idxs < 0) | (gidx >= n_valid)
    vals = jnp.where(invalid, NEG_INF, vals)
    all_vals = jax.lax.all_gather(vals, axis)          # [S, Q, k]
    all_idxs = jax.lax.all_gather(gidx, axis)
    s, qn, kk = all_vals.shape
    flat_v = jnp.transpose(all_vals, (1, 0, 2)).reshape(qn, s * kk)
    flat_i = jnp.transpose(all_idxs, (1, 0, 2)).reshape(qn, s * kk)
    best_v, pos = jax.lax.top_k(flat_v, k)
    best_i = jnp.take_along_axis(flat_i, pos, axis=1)
    best_i = jnp.where(best_v == NEG_INF, -1, best_i)
    return best_v, best_i


def sharded_cosine_topk(
    queries: jnp.ndarray,      # [Q, D] replicated
    gallery: jnp.ndarray,      # [N_pad, D] row-sharded over `axis`
    k: int,
    mesh: Mesh,
    axis: str = DATA_AXIS,
    impl: str = "auto",
    n_valid: int | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (values [Q, k], global indices [Q, k]) — replicated.

    `n_valid` is the real row count when the gallery was padded to a
    multiple of the shard count (place_gallery does this); defaults to the
    (padded) array length."""
    n = gallery.shape[0]
    n_shards = mesh.shape[axis]
    if n_valid is None:
        n_valid = n
    if n % n_shards != 0:
        gallery = _pad_rows(gallery, padded_rows(n, n_shards))
    rows_per_shard = gallery.shape[0] // n_shards

    def local(q, g_shard):
        vals, idxs = cosine_topk(q, g_shard, k=min(k, rows_per_shard),
                                 impl=impl)
        if vals.shape[1] < k:  # tiny shards: top up with sentinels
            padk = k - vals.shape[1]
            vals = jnp.pad(vals, ((0, 0), (0, padk)),
                           constant_values=NEG_INF)
            idxs = jnp.pad(idxs, ((0, 0), (0, padk)), constant_values=-1)
        return _merge_shard_candidates(vals, idxs, k, axis,
                                       rows_per_shard, n_valid)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis, None)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(queries, gallery)


def sharded_cosine_topk_quantized(
    queries: jnp.ndarray,      # [Q, D] float, replicated
    gallery_q: jnp.ndarray,    # [N_pad, D] int8, row-sharded
    scales: jnp.ndarray,       # [N_pad] f32, row-sharded
    k: int,
    mesh: Mesh,
    axis: str = DATA_AXIS,
    impl: str = "auto",
    n_valid: int | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """int8 gallery x mesh: per-shard fused quantized top-k + global merge.
    Composes the two scaling features (int8 HBM residency, multi-chip)."""
    from mmrs_tpu.ops.quant import cosine_topk_quantized

    n = gallery_q.shape[0]
    n_shards = mesh.shape[axis]
    if n_valid is None:
        n_valid = n
    if n % n_shards != 0:
        rows = padded_rows(n, n_shards)
        gallery_q = _pad_rows(gallery_q, rows)
        scales = _pad_rows(scales, rows)
    rows_per_shard = gallery_q.shape[0] // n_shards

    def local(q, g_shard, s_shard):
        vals, idxs = cosine_topk_quantized(
            q, g_shard, s_shard, k=min(k, rows_per_shard), impl=impl)
        if vals.shape[1] < k:
            padk = k - vals.shape[1]
            vals = jnp.pad(vals, ((0, 0), (0, padk)),
                           constant_values=NEG_INF)
            idxs = jnp.pad(idxs, ((0, 0), (0, padk)), constant_values=-1)
        return _merge_shard_candidates(vals, idxs, k, axis,
                                       rows_per_shard, n_valid)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis, None), P(axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(queries, gallery_q, scales)


def sharded_similarities(
    queries: jnp.ndarray,      # [Q, D] replicated
    gallery: jnp.ndarray,      # [N_pad, D] row-sharded
    mesh: Mesh,
    axis: str = DATA_AXIS,
) -> jnp.ndarray:
    """Full similarity rows [Q, N_pad], column-sharded over the mesh —
    the calibration input; each shard computes only its own column strip
    (f32 accumulation), nothing is gathered."""

    def local(q, g_shard):
        return jax.lax.dot_general(
            q, g_shard, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)

    return shard_map(local, mesh=mesh, in_specs=(P(), P(axis, None)),
                     out_specs=P(None, axis), check_vma=False)(
                         queries, gallery)


def sharded_similarities_quantized(
    q_q: jnp.ndarray,          # [Q, D] int8 queries
    q_scale: jnp.ndarray,      # [Q] f32
    gallery_q: jnp.ndarray,    # [N_pad, D] int8, row-sharded
    scales: jnp.ndarray,       # [N_pad] f32, row-sharded
    mesh: Mesh,
    axis: str = DATA_AXIS,
) -> jnp.ndarray:
    def local(qq, qs, g_shard, s_shard):
        acc = jax.lax.dot_general(
            qq, g_shard, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32)
        return acc.astype(jnp.float32) * qs[:, None] * s_shard[None, :]

    return shard_map(local, mesh=mesh,
                     in_specs=(P(), P(), P(axis, None), P(axis)),
                     out_specs=P(None, axis), check_vma=False)(
                         q_q, q_scale, gallery_q, scales)


def place_gallery(gallery: jnp.ndarray, mesh: Mesh, axis: str = DATA_AXIS):
    """Device-put a gallery row-sharded over the mesh, zero-padding ragged
    row counts to the next shard multiple (mask with n_valid at query
    time). Returns the (possibly padded) sharded array."""
    rows = padded_rows(gallery.shape[0], mesh.shape[axis])
    gallery = _pad_rows(gallery, rows)
    return jax.device_put(gallery, NamedSharding(mesh, P(axis, None)))


def place_gallery_quantized(gallery: jnp.ndarray, mesh: Mesh,
                            axis: str = DATA_AXIS):
    """Quantize to int8 + per-row scales, pad ragged rows, and row-shard
    both over the mesh. Returns (gallery_q, scales)."""
    from mmrs_tpu.ops.quant import quantize_rows

    g_q, scales = quantize_rows(gallery)
    rows = padded_rows(g_q.shape[0], mesh.shape[axis])
    g_q = _pad_rows(g_q, rows)
    scales = _pad_rows(scales, rows)
    return (
        jax.device_put(g_q, NamedSharding(mesh, P(axis, None))),
        jax.device_put(scales, NamedSharding(mesh, P(axis))),
    )
