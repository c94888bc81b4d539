"""IVF ANN index x mesh — slot-shard every bucket over the data axis.

VERDICT r3 #1: the sub-linear index (index/ivf.py) must compose with
--gallery-shards, because a 100M-row gallery needs IVF *and* several
cards at once. The layout choice:

  - **Slot-sharding, not cluster-sharding.** Every shard holds ALL C
    clusters but only `cap / n_shards` slots of each bucket (and a
    1/n_shards strip of the spill). The centroid matmul and the global
    top-nprobe probe list are computed replicated — identical on every
    card, no communication — and each card reads only ITS slot strip of
    the probed buckets. Per-chip traffic drops S-fold (nprobe * cap/S
    * Dp) while capacity grows S-fold: latency AND capacity scale.
    Cluster-sharding instead leaves the probe set unbalanced (a query's
    nprobe clusters can all live on one chip) and forces either S x
    wasted masked scans or a superset probe that breaks parity.
  - **Exact parity.** The probed rows are exactly the single-device
    index's probed rows (same centroids, same assignments, same probe
    list), each scored by the same kernel, so the all-gather merge
    reproduces single-device `ivf_topk` exactly — tested, and
    nprobe == C stays exactly brute force through the mesh.
  - **The merge is the flat path's merge.** Bucket ids are stored as
    GLOBAL gallery rows, so no shard-offset arithmetic: mask id < 0,
    all-gather [S, Q, k], top-k. Same collective budget as
    parallel/topk.py (k * S tiny rows).

Reference equivalent: none — the reference scans one torch f32 gallery
per query (code/search_image.py:105-117); this is the scale-out of the
sub-linear replacement for that scan.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from mmrs_tpu.index.ivf import (IVFIndex, _ivf_topk_body, auto_nprobe,
                                probe_impl)
from mmrs_tpu.ops.topk import NEG_INF
from mmrs_tpu.parallel.mesh import DATA_AXIS


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_axis(x: jnp.ndarray, axis: int, size: int, fill=0):
    if x.shape[axis] == size:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, size - x.shape[axis])
    return jnp.pad(x, pads, constant_values=fill)


def ivf_shardings(mesh: Mesh, axis: str = DATA_AXIS,
                  quant: str = "") -> dict:
    """NamedShardings for each IVFIndex array under slot-sharding. The
    int4 layout stores slots on the LAST bucket axis ([C, Dp/8, cap])
    and the spill as one flat packed plane ([Dp/8, S]), so the sharded
    axis moves accordingly — the slots are still what splits."""
    ns = lambda spec: NamedSharding(mesh, spec)  # noqa: E731
    if quant == "int4":
        buckets, spill = P(None, None, axis), P(None, axis)
    else:
        buckets, spill = P(None, axis, None), P(axis, None)
    return {
        "centroids": ns(P()),                  # replicated (C x Dp is tiny)
        "buckets": ns(buckets),                # cap slots split over chips
        "bucket_ids": ns(P(None, axis)),
        "bucket_scales": ns(P(None, axis)),
        "spill": ns(spill),                    # spill rows split over chips
        "spill_ids": ns(P(axis)),
        "spill_scales": ns(P(axis)),
    }


def place_ivf(ivf: IVFIndex, mesh: Mesh, axis: str = DATA_AXIS) -> IVFIndex:
    """Reshard a built IVFIndex over the mesh: pad the cap axis and the
    spill rows to shard multiples (dead slots carry id -1 / zero rows —
    masked like single-device padding), then device_put each array with
    its slot-sharding. Use build_ivf(mesh=...) instead when the index
    never fits one chip: it allocates the bucket arrays ALREADY sharded
    and streams rows straight into the strips."""
    s = mesh.shape[axis]
    quant = ivf.quant
    sh = ivf_shardings(mesh, axis, quant=quant)
    if quant == "int4":
        # slots sit on LANES in the packed layout: each shard's strip
        # (cap / s) must stay a 128-lane multiple for the probe kernel
        cap = _round_up(ivf.bucket_cap, 128 * s)
    else:
        cap = _round_up(ivf.bucket_cap, s)
    cap_axis, spill_axis = (2, 1) if quant == "int4" else (1, 0)
    spl = _round_up(ivf.spill.shape[spill_axis], s)
    out = dataclasses.replace(
        ivf,
        centroids=jax.device_put(ivf.centroids, sh["centroids"]),
        buckets=jax.device_put(
            _pad_axis(ivf.buckets, cap_axis, cap), sh["buckets"]),
        bucket_ids=jax.device_put(
            _pad_axis(ivf.bucket_ids, 1, cap, fill=-1), sh["bucket_ids"]),
        spill=jax.device_put(_pad_axis(ivf.spill, spill_axis, spl),
                             sh["spill"]),
        spill_ids=jax.device_put(
            _pad_axis(ivf.spill_ids, 0, spl, fill=-1), sh["spill_ids"]),
    )
    if ivf.quantized:
        out = dataclasses.replace(
            out,
            bucket_scales=jax.device_put(
                _pad_axis(ivf.bucket_scales, 1, cap), sh["bucket_scales"]),
            spill_scales=jax.device_put(
                _pad_axis(ivf.spill_scales, 0, spl), sh["spill_scales"]),
        )
    return out


def _merge_global_candidates(vals, idxs, k: int, axis: str):
    """All-gather per-shard candidates whose ids are ALREADY global
    gallery rows (IVF stores ids explicitly) and take the merged top-k,
    replicated on every shard."""
    vals = jnp.where(idxs < 0, NEG_INF, vals)
    all_vals = jax.lax.all_gather(vals, axis)          # [S, Q, k]
    all_idxs = jax.lax.all_gather(idxs, axis)
    s, qn, kk = all_vals.shape
    flat_v = jnp.transpose(all_vals, (1, 0, 2)).reshape(qn, s * kk)
    flat_i = jnp.transpose(all_idxs, (1, 0, 2)).reshape(qn, s * kk)
    best_v, pos = jax.lax.top_k(flat_v, k)
    best_i = jnp.take_along_axis(flat_i, pos, axis=1)
    return best_v, jnp.where(best_v == NEG_INF, -1, best_i)


def sharded_ivf_topk(
    queries: jnp.ndarray,     # [Q, D] L2-normalized, replicated
    ivf: IVFIndex,            # arrays placed by place_ivf / sharded build
    k: int = 10,
    nprobe: int = 0,          # 0 = auto; == n_clusters is exact
    mesh: Optional[Mesh] = None,
    axis: str = DATA_AXIS,
    impl: str = "auto",       # per-shard kernel choice (ops/dispatch.py)
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """ivf_topk's contract over the slot-sharded index: each shard runs
    the probe body on its slot strip, candidates all-gather-merge.
    Results replicate single-device ivf_topk exactly (same probed rows,
    same scores; ties may reorder)."""
    if mesh is None:
        raise ValueError("sharded_ivf_topk needs a mesh; use ivf_topk")
    if nprobe <= 0:
        nprobe = auto_nprobe(ivf.n_clusters)
    nprobe = min(nprobe, ivf.n_clusters)
    k = min(k, ivf.n_total)
    impl = probe_impl(ivf.quant, impl)

    quant = ivf.quant
    quantized = ivf.quantized
    if quantized:
        bscales, sscales = ivf.bucket_scales, ivf.spill_scales
        scale_specs = (P(None, axis), P(axis))
    else:  # dummies keep one shard_map signature
        bscales = jnp.zeros((1, 1), jnp.float32)
        sscales = jnp.zeros((1,), jnp.float32)
        scale_specs = (P(), P())
    if quant == "int4":
        from mmrs_tpu.index.ivf import _ivf_topk_body_q4 as body

        bucket_spec, spill_spec = P(None, None, axis), P(None, axis)
    else:
        body = _ivf_topk_body
        bucket_spec, spill_spec = P(None, axis, None), P(axis, None)

    def local(q, cents, buckets, bucket_ids, spill, spill_ids, bs, ss):
        vals, idxs = body(
            q, cents, buckets, bucket_ids, spill, spill_ids,
            bs if quantized else None, ss if quantized else None,
            k=k, nprobe=nprobe, impl=impl)
        return _merge_global_candidates(vals, idxs, k, axis)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), bucket_spec, P(None, axis),
                  spill_spec, P(axis)) + scale_specs,
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(queries, ivf.centroids, ivf.buckets, ivf.bucket_ids,
              ivf.spill, ivf.spill_ids, bscales, sscales)
