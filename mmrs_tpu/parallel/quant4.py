"""int4 packed gallery x mesh — the capacity ladder's top rung, sharded.

Completes the composition VERDICT r3 #6 asked for: the [D/8, N] packed
word plane (ops/quant4.py) is COLUMN-sharded over the data axis (columns
are gallery rows in the transposed layout), per-row scales row-sharded,
and each card runs the int4 scan (dual masked int8 dots) on its own
shard — the scan is shard-local by construction, so the only new code
is placement + the same candidate all-gather merge the bf16/int8
sharded paths use (parallel/topk.py). 4x rows per card TIMES n_cards.

Reference equivalent: none (the reference holds one torch f32 gallery,
code/search_image.py:105-117); this is the scale-out of its
scan.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from mmrs_tpu.ops.quant4 import cosine_topk_int4, similarities_int4
from mmrs_tpu.parallel.mesh import DATA_AXIS
from mmrs_tpu.parallel.topk import (_merge_shard_candidates, _pad_rows,
                                    padded_rows)
from mmrs_tpu.ops.topk import NEG_INF


def place_gallery_int4(gallery: jnp.ndarray, mesh: Mesh | None,
                       axis: str = DATA_AXIS):
    """Quantize [N, D] (L2-normalized) rows to the packed int4 layout and
    shard over the mesh: words [D/8, N_pad] column-sharded, scales [N_pad]
    row-sharded. Padding rows carry all-zero CODES (their packed words
    are the offset-8 pattern, not zero bytes — the epilogue's
    8*rowsum(q_lo) correction cancels them to an exact 0.0 score at a
    ~1e-13 scale) and are masked by global id in the merge anyway."""
    from mmrs_tpu.ops.quant4 import quantize_rows_int4

    if mesh is None:
        return quantize_rows_int4(gallery)
    rows = padded_rows(gallery.shape[0], mesh.shape[axis])
    gallery = _pad_rows(gallery, rows)
    words, scales = quantize_rows_int4(gallery)
    return (
        jax.device_put(words, NamedSharding(mesh, P(None, axis))),
        jax.device_put(scales, NamedSharding(mesh, P(axis))),
    )


def sharded_cosine_topk_int4(
    queries: jnp.ndarray,     # [Q, D] float (L2-normalized), replicated
    packed: jnp.ndarray,      # [D/8, N_pad] int32 words, column-sharded
    scales: jnp.ndarray,      # [N_pad] f32, row-sharded
    k: int,
    mesh: Mesh,
    axis: str = DATA_AXIS,
    n_valid: int | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-shard int4 scan + global candidate merge — the
    sharded_cosine_topk contract over the packed plane."""
    n = packed.shape[1]
    n_shards = mesh.shape[axis]
    if n_valid is None:
        n_valid = n
    if n % n_shards != 0:
        rows = padded_rows(n, n_shards)
        packed = jnp.pad(packed, ((0, 0), (0, rows - n)))
        scales = _pad_rows(scales, rows)
    rows_per_shard = packed.shape[1] // n_shards

    def local(q, w_shard, s_shard):
        vals, idxs = cosine_topk_int4(
            q, w_shard, s_shard, k=min(k, rows_per_shard))
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
        in_specs=(P(), P(None, axis), P(axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(queries, packed, scales)


def sharded_similarities_int4(
    queries: jnp.ndarray,     # [Q, D] float (L2-normalized), replicated
    packed: jnp.ndarray,      # [D/8, N_pad] int32 words, column-sharded
    scales: jnp.ndarray,      # [N_pad] f32, row-sharded
    mesh: Mesh,
    axis: str = DATA_AXIS,
) -> jnp.ndarray:
    """Full approximate-cosine rows [Q, N_pad], column-sharded — the
    calibration input; each shard scores only its own column strip."""

    def local(q, w_shard, s_shard):
        return similarities_int4(q, w_shard, s_shard)

    return shard_map(local, mesh=mesh,
                     in_specs=(P(), P(None, axis), P(axis)),
                     out_specs=P(None, axis), check_vma=False)(
                         queries, packed, scales)
