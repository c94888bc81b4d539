"""Streaming top-k over indexes larger than device memory.

The gallery-size scaling story past HBM capacity (SURVEY.md §5: gallery
sharding/streaming IS the reference's scaling axis): row chunks of an
on-disk (memmapped) index are uploaded double-buffered while the fused
`cosine_topk` kernel scans the previous chunk; only [Q, k] candidates per
chunk come back, merged on host at the end. Device residency is bounded by
`prefetch + 1` chunks regardless of index size; host residency by the
memmap window.

A 10M x 512 index fully resident in bf16 is 10 GB — it still fits one
card (use SearchEngine / sharded_cosine_topk for that, or int8 for 2x the
rows). This module is for the tier beyond that, or for hosts/cards where
the index must stay on disk.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mmrs_tpu.ops.topk import cosine_topk


def streaming_topk(
    embeddings,                   # [N, D] array-like (np.memmap ok), f16/f32
    queries: np.ndarray,          # [Q, D] (unnormalized ok — caller's call)
    k: int = 10,
    chunk_rows: int = 1 << 20,
    device_dtype=jnp.bfloat16,
    impl: str = "auto",
    prefetch: int = 2,
    mesh=None,
    axis: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (values [Q, k] f32, global indices [Q, k] int64).

    When the index holds fewer than k rows, the surplus slots carry
    value -inf and index -1 (the unambiguous invalid sentinel) —
    callers must not feed a negative index into paths[].

    Upload of chunk i+1 overlaps the scan of chunk i (JAX dispatch is
    async; results are fetched `prefetch` chunks behind). Peak device
    memory ~= (prefetch + 1) * chunk_rows * D * itemsize(device_dtype).

    With `mesh`, each chunk is row-sharded over the mesh's data axis and
    scanned by `parallel.sharded_cosine_topk` — the on-disk-index tier
    composed with multi-chip: upload bandwidth and scan both scale with
    the chip count, and the per-chunk [Q, k] merge is the only collective.
    """
    n = embeddings.shape[0]

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from mmrs_tpu.parallel.mesh import DATA_AXIS
        from mmrs_tpu.parallel.topk import sharded_cosine_topk

        axis = axis or DATA_AXIS
        n_shards = mesh.shape[axis]
        shard = NamedSharding(mesh, P(axis, None))
        repl = NamedSharding(mesh, P())
        q_dev = jax.device_put(
            jnp.asarray(np.asarray(queries), device_dtype), repl)
    else:
        q_dev = jnp.asarray(np.asarray(queries), device_dtype)

    # Upload chunks in their SOURCE dtype and cast on device: numpy's
    # f16->bf16 host conversion is single-threaded and slower than the
    # host->device link, so a host-side cast would bottleneck the whole
    # stream. XLA casts at device-memory speed.
    cast = jax.jit(lambda c: c.astype(device_dtype))

    pending: deque = deque()      # (offset, vals_dev, idxs_dev, chunk_ref)
    all_vals = []
    all_idxs = []

    def drain_one():
        off, v, i, _chunk = pending.popleft()
        all_vals.append(np.asarray(v, np.float32))
        all_idxs.append(np.asarray(i, np.int64) + off)

    for a in range(0, n, chunk_rows):
        b = min(a + chunk_rows, n)
        kk = min(k, b - a)
        host_chunk = np.ascontiguousarray(embeddings[a:b])
        if mesh is not None:
            pad = (-(b - a)) % n_shards
            if pad:
                host_chunk = np.pad(host_chunk, ((0, pad), (0, 0)))
            chunk = cast(jax.device_put(host_chunk, shard))
            vals, idxs = sharded_cosine_topk(q_dev, chunk, k=kk, mesh=mesh,
                                             axis=axis, impl=impl,
                                             n_valid=b - a)
        else:
            chunk = cast(jax.device_put(host_chunk))
            vals, idxs = cosine_topk(q_dev, chunk, k=kk, impl=impl)
        if kk < k:                # tiny tail chunk: pad with sentinels
            vals = jnp.pad(vals, ((0, 0), (0, k - kk)),
                           constant_values=-np.inf)
            # -(a+1) so the +off in drain_one yields a GLOBAL index of
            # -1 (the unambiguous sentinel); -a would map to row 0
            idxs = jnp.pad(idxs, ((0, 0), (0, k - kk)),
                           constant_values=-(a + 1))
        # keep a reference to the chunk until its result is fetched so the
        # allocator cannot recycle it mid-flight, then let it free
        pending.append((a, vals, idxs, chunk))
        while len(pending) > prefetch:
            drain_one()
    while pending:
        drain_one()

    merged_v = np.concatenate(all_vals, axis=1)      # [Q, k * n_chunks]
    merged_i = np.concatenate(all_idxs, axis=1)
    order = np.argsort(-merged_v, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(merged_v, order, 1),
            np.take_along_axis(merged_i, order, 1))
