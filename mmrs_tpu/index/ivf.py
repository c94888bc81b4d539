"""IVF (inverted-file) ANN index — sub-linear gallery search.

The reference scores every gallery row per query
(`100. * image_features @ text_features.T`, code/search_image.py:105-117);
the brute-force scan (ops/topk.py) is bound by device-memory bandwidth,
which makes *bandwidth* the hard floor: a 10M-row bf16 gallery is 10.24 GB
of traffic per scan no matter how good the kernel is. This module goes
sub-linear:

  - **Spherical k-means** (train on a row sample, one streamed
    assignment pass over the full gallery) — all matmuls, fixed iteration
    count, jit-friendly.
  - **Static-shape buckets**: cluster c's rows live at `buckets[c, :cap]`
    (zero-padded, ids -1). Rows past a bucket's capacity go to a dense
    **spill** array that is scanned exactly on every query, so capacity
    overflow degrades cost, never recall.
  - **Search = one small centroid matmul + nprobe bucket reads**: per
    query, score the [C, D] centroids, take the top `nprobe` clusters, and
    scan only those buckets (a Triton kernel whose blocks each load their
    own probed bucket id and read only that bucket; the gather is never
    materialized).
    Traffic per query drops from N*D to ~nprobe*cap*D + C*D — 100x at
    10M rows / C=4096 / nprobe=32.
  - `nprobe == n_clusters` probes every bucket and (with the spill) is
    EXACTLY brute force — the recall knob has a closed top end, tested.

Build streams the (possibly memmapped) host gallery in chunks — the flat
gallery is never device-resident, so index capacity stays bounded by the
bucket array (~1.25x the raw rows), not 2x.
"""

from __future__ import annotations

import functools
import json
import math
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from mmrs_tpu.ops.dispatch import resolve_impl
from mmrs_tpu.ops.normalize import l2_normalize
from mmrs_tpu.ops.topk import NEG_INF, candidate_width, exact_dot_t, tile_topk
from mmrs_tpu.utils.logging import get_logger

log = get_logger(__name__)

_TRAIN_CHUNK = 8192      # E-step accumulation chunk (one-hot matmul rows)
_STREAM_CHUNK = 65536    # host->device build streaming rows


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def auto_clusters(n_rows: int) -> int:
    """Power-of-two near sqrt(N) (the classic IVF sizing): 1M -> 1024,
    10M -> 4096. Clamped (to a power of two, keeping the invariant) so
    tiny galleries stay searchable."""
    if n_rows <= 1:
        return 1
    clamp = max(1, n_rows // 8)
    clamp = 1 << (clamp.bit_length() - 1)   # round DOWN to a power of two
    return min(1 << math.ceil(math.log2(math.sqrt(n_rows))), clamp)


def auto_nprobe(n_clusters: int) -> int:
    """Default probe width: C/8, floor 8 — measured ~0.93 recall@10 on
    64-blob synthetic data (test_ivf.py); recall is corpus-dependent, so
    tune per deployment with ivf_recall (nprobe == C is exact)."""
    return max(1, min(n_clusters, max(8, n_clusters // 8)))


@dataclass
class IVFIndex:
    """Device-resident IVF structure. All row ids are GLOBAL gallery rows,
    so results are interchangeable with ops/topk.cosine_topk's.

    With `quantize="int8"` (or True) at build, bucket/spill rows are
    symmetric per-row int8 (ops/quant.py convention) and `bucket_scales`/
    `spill_scales` hold the per-slot f32 dequant factors — half the
    residency (2x rows per card) at ~0.3% score error, same trade as the
    flat int8 gallery mode. With `quantize="int4"`, buckets hold PACKED
    int4 words in the flat gallery's transposed layout per bucket
    ([C, Dp/8, cap] int32, the ops/quant4.py convention) and spill is
    one flat packed plane ([Dp/8, S]) — quarter the residency (4x rows
    per card, ~0.6% score
    error), completing the capacity ladder inside the ANN index."""

    centroids: jnp.ndarray    # [C, Dp]  (L2-normalized)
    buckets: jnp.ndarray      # [C, cap, Dp] rows (bf16/int8) or
    #                           [C, Dp/8, cap] int32 packed words (int4)
    bucket_ids: jnp.ndarray   # [C, cap] int32 global row ids, -1 pad
    spill: jnp.ndarray        # [S, Dp] rows, or [Dp/8, S] packed (int4)
    spill_ids: jnp.ndarray    # [S] int32, -1 pad
    n_total: int              # live gallery rows
    dim: int                  # true embedding dim (Dp >= dim, zero-padded)
    bucket_scales: Optional[jnp.ndarray] = None   # [C, cap] f32 (int8/int4)
    spill_scales: Optional[jnp.ndarray] = None    # [S] f32

    @property
    def n_clusters(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def bucket_cap(self) -> int:
        return int(self.bucket_ids.shape[1])

    @property
    def quant(self) -> str:
        """"" (bf16) | "int8" | "int4" — from the stored dtypes."""
        if self.buckets.dtype == jnp.int32:
            return "int4"
        if self.bucket_scales is not None:
            return "int8"
        return ""

    @property
    def quantized(self) -> bool:
        return self.bucket_scales is not None

    def hbm_bytes(self) -> int:
        arrs = [self.centroids, self.buckets, self.bucket_ids,
                self.spill, self.spill_ids]
        if self.quantized:
            arrs += [self.bucket_scales, self.spill_scales]
        return sum(int(np.prod(a.shape)) * a.dtype.itemsize for a in arrs)


# -- training -----------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("k", "iters", "n_valid"))
def _spherical_kmeans(x: jnp.ndarray, k: int, iters: int, n_valid: int,
                      key: jnp.ndarray) -> jnp.ndarray:
    """Centroids [k, D] f32 from a normalized sample x [Mp, D] (rows >=
    n_valid are zero padding). Cosine assignment; E-step sums accumulate
    chunk-by-chunk (one-hot matmuls, no scatter), so the [M, k]
    one-hot never materializes whole."""
    mp, d = x.shape
    nc = mp // _TRAIN_CHUNK if mp % _TRAIN_CHUNK == 0 else -1
    if nc < 1:
        raise ValueError("sample rows must be padded to the train chunk")
    xc = x.reshape(nc, _TRAIN_CHUNK, d)
    row_id = (jnp.arange(nc * _TRAIN_CHUNK, dtype=jnp.int32)
              .reshape(nc, _TRAIN_CHUNK))
    valid = (row_id < n_valid).astype(jnp.float32)          # [nc, chunk]

    idx = jax.random.choice(key, jnp.arange(n_valid), (k,), replace=False)
    cents = x[idx].astype(jnp.float32)

    def em(cents, _):
        def chunk_step(carry, inp):
            sums, counts = carry
            xb, vb = inp
            sims = jax.lax.dot_general(
                xb, cents, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32)          # [chunk, k]
            assign = jnp.argmax(sims, axis=1)
            onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32)
            onehot = onehot * vb[:, None]
            sums = sums + jax.lax.dot_general(
                onehot, xb, (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)          # [k, D]
            counts = counts + jnp.sum(onehot, axis=0)
            return (sums, counts), None

        (sums, counts), _ = jax.lax.scan(
            chunk_step,
            (jnp.zeros((k, d), jnp.float32), jnp.zeros((k,), jnp.float32)),
            (xc, valid))
        norm = jnp.linalg.norm(sums, axis=1, keepdims=True)
        new = jnp.where((counts[:, None] > 0) & (norm > 1e-12),
                        sums / jnp.maximum(norm, 1e-12), cents)
        return new, None

    cents, _ = jax.lax.scan(em, cents, None, length=iters)
    return cents


def train_centroids(sample: np.ndarray, n_clusters: int, iters: int = 10,
                    seed: int = 0) -> jnp.ndarray:
    """Spherical k-means centroids [C, D] f32 from a host row sample."""
    m, d = sample.shape
    if n_clusters > m:
        raise ValueError(f"n_clusters {n_clusters} > sample rows {m}")
    x = jnp.asarray(np.asarray(sample), jnp.float32)
    x = l2_normalize(x)
    mp = _round_up(m, _TRAIN_CHUNK)
    if mp != m:
        x = jnp.zeros((mp, d), x.dtype).at[:m].set(x)
    return _spherical_kmeans(x, n_clusters, iters, m, jax.random.key(seed))


# -- build --------------------------------------------------------------------


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _fill_chunk(buckets, spill, rows, bpos, spos):
    """Scatter one normalized row chunk into its bucket/spill slots.
    `buckets` is the FINAL [C, cap, Dp] array (a post-fill reshape of a
    10 GB flat array relayouts — a full device copy that OOMed the 10M
    build); flat positions split into (cluster, slot) in-jit. Positions
    marked "not here" are set PAST the array (positive out-of-bounds =>
    dropped by mode='drop'; -1 would WRAP to the last slot per numpy
    semantics), covering padding and the other-destination rows."""
    rows = l2_normalize(rows.astype(jnp.float32))
    d = rows.shape[1]
    dp = buckets.shape[2]
    if d != dp:
        rows = jnp.zeros((rows.shape[0], dp), jnp.float32).at[:, :d].set(rows)
    rows = rows.astype(buckets.dtype)
    cap = buckets.shape[1]
    ci = bpos // cap          # OOB sentinel C*cap -> ci == C: still OOB
    si = bpos % cap
    buckets = buckets.at[ci, si].set(rows, mode="drop")
    spill = spill.at[spos].set(rows, mode="drop")
    return buckets, spill


def _oob(pos: np.ndarray, size: int) -> np.ndarray:
    """-1 'not here' markers -> positive out-of-bounds (dropped, not
    wrapped) scatter positions."""
    return np.where(pos < 0, np.int32(size), pos).astype(np.int32)


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3))
def _fill_chunk_q8(buckets, bscales, spill, sscales, rows, bpos, spos):
    """int8 variant of _fill_chunk: per-row symmetric quantization
    (ops/quant.py convention) happens on device during the fill pass."""
    from mmrs_tpu.ops.quant import quantize_rows

    rows = l2_normalize(rows.astype(jnp.float32))
    d = rows.shape[1]
    dp = buckets.shape[2]
    if d != dp:
        rows = jnp.zeros((rows.shape[0], dp), jnp.float32).at[:, :d].set(rows)
    q, scale = quantize_rows(rows)
    cap = buckets.shape[1]
    ci = bpos // cap
    si = bpos % cap
    buckets = buckets.at[ci, si].set(q, mode="drop")
    bscales = bscales.at[ci, si].set(scale, mode="drop")
    spill = spill.at[spos].set(q, mode="drop")
    sscales = sscales.at[spos].set(scale, mode="drop")
    return buckets, bscales, spill, sscales


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3))
def _fill_chunk_q4(buckets, bscales, spill, sscales, rows, bpos, spos):
    """int4 variant: rows quantize to packed words on device and scatter
    COLUMN-wise into the per-bucket transposed planes (buckets
    [C, Dp/8, cap]; row j's words land at [ci, :, si]) and the flat
    spill plane ([Dp/8, S] at column spos)."""
    from mmrs_tpu.ops.quant4 import quantize_rows_int4

    rows = l2_normalize(rows.astype(jnp.float32))
    d = rows.shape[1]
    dp = buckets.shape[1] * 8
    if d != dp:
        rows = jnp.zeros((rows.shape[0], dp), jnp.float32).at[:, :d].set(rows)
    words, scale = quantize_rows_int4(rows)       # [Dp/8, chunk], [chunk]
    cap = buckets.shape[2]
    ci = bpos // cap
    si = bpos % cap
    # advanced indices split by a slice put the index axis FIRST:
    # buckets.at[ci, :, si] selects [chunk, Dp/8]
    buckets = buckets.at[ci, :, si].set(words.T, mode="drop")
    bscales = bscales.at[ci, si].set(scale, mode="drop")
    spill = spill.at[:, spos].set(words, mode="drop")
    sscales = sscales.at[spos].set(scale, mode="drop")
    return buckets, bscales, spill, sscales


@functools.partial(jax.jit, static_argnames=())
def _assign_chunk(rows, cents):
    rows = l2_normalize(rows.astype(jnp.float32))
    sims = jax.lax.dot_general(rows, cents, (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.float32)
    return jnp.argmax(sims, axis=1).astype(jnp.int32)


def _auto_cap(assign: np.ndarray, n_clusters: int, n: int,
              cover: float = 0.98, max_slots_frac: float = 1.3) -> int:
    """Bucket capacity from the MEASURED cluster histogram: the smallest
    cap whose buckets hold >= `cover` of all rows (the rest spill to the
    exact scan), bounded so total slots stay <= max_slots_frac * n — a
    blind 1.25x-average cap either wastes padding or overflows badly on
    skewed corpora (real galleries cluster by class)."""
    counts = np.bincount(assign, minlength=n_clusters)
    caps = np.unique(counts)
    lo = 0
    for c in caps:  # <= C candidates; covered(c) is monotone in c
        if np.minimum(counts, c).sum() >= cover * n:
            lo = int(c)
            break
    else:
        lo = int(caps[-1])
    hi = max(8, math.floor(max_slots_frac * n / n_clusters))
    return _round_up(max(8, min(lo, hi)), 8)


def _placement(assign: np.ndarray, n_clusters: int,
               cap: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """Host-side slotting. Returns (bpos [N], spos [N], bucket_ids
    [C*cap], spill_ids [S]); bpos/spos are -1 where the row goes to the
    other structure."""
    n = assign.shape[0]
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    starts = np.searchsorted(sorted_assign, np.arange(n_clusters))
    rank = np.arange(n, dtype=np.int64) - starts[sorted_assign]
    in_bucket = rank < cap

    bpos = np.full(n, -1, np.int32)
    spos = np.full(n, -1, np.int32)
    flat = (sorted_assign.astype(np.int64) * cap + rank)[in_bucket]
    bpos[order[in_bucket]] = flat.astype(np.int32)
    n_spill = int((~in_bucket).sum())
    spos[order[~in_bucket]] = np.arange(n_spill, dtype=np.int32)

    bucket_ids = np.full(n_clusters * cap, -1, np.int32)
    bucket_ids[flat] = order[in_bucket].astype(np.int32)
    spill_ids = order[~in_bucket].astype(np.int32)
    return bpos, spos, bucket_ids, spill_ids


def _pad_chunk(rows: np.ndarray, chunk: int) -> np.ndarray:
    if rows.shape[0] == chunk:
        return rows
    return np.concatenate(
        [rows, np.zeros((chunk - rows.shape[0], rows.shape[1]),
                        rows.dtype)])


def build_ivf(
    embeddings,                       # [N, D] host array-like (memmap ok)
    n_clusters: int = 0,              # 0 = auto (pow2 near sqrt N)
    bucket_cap: int = 0,              # 0 = auto (1.25x average, /8-aligned)
    iters: int = 10,
    train_rows: int = 262_144,
    seed: int = 0,
    dtype=jnp.bfloat16,
    chunk: int = _STREAM_CHUNK,
    centroids: Optional[jnp.ndarray] = None,  # reuse trained centroids
    assignments: Optional[np.ndarray] = None,  # reuse a prior full pass
    quantize: bool = False,           # int8 rows + per-slot scales
    mesh=None,                        # slot-shard buckets over the mesh
    cover: float = 0.98,              # auto-cap slot budget (spill = 1-cover)
    slots_frac: float = 1.3,          # total-slots ceiling (x n rows)
) -> IVFIndex:
    """Train (or reuse) centroids, assign every row, and stream rows into
    the bucket structure. Host RSS stays ~one chunk; device residency is
    the bucket array (~cap*C/N overhead over the raw rows) plus spill.
    With `mesh`, the bucket/spill arrays are allocated ALREADY slot-
    sharded (parallel/ivf.py layout) and rows stream straight into the
    strips — a multi-chip-sized index never has single-chip residency."""
    n, d = embeddings.shape
    if n == 0:
        raise ValueError("empty gallery")
    if centroids is None and assignments is None:
        m = min(n, max(train_rows,
                       n_clusters if n_clusters > 0 else auto_clusters(n)))
        sel = (np.linspace(0, n - 1, m).astype(np.int64)
               if m < n else np.arange(n))
        sample = jnp.asarray(np.asarray(embeddings[sel], np.float32))
    else:
        sample = None

    def chunks():
        for a in range(0, n, chunk):
            yield jnp.asarray(
                _pad_chunk(np.asarray(embeddings[a:a + chunk]), chunk))

    return build_ivf_streaming(
        chunks, n, d, n_clusters=n_clusters, bucket_cap=bucket_cap,
        iters=iters, seed=seed, dtype=dtype, chunk=chunk, sample=sample,
        centroids=centroids, assignments=assignments, quantize=quantize,
        mesh=mesh, cover=cover, slots_frac=slots_frac)


def build_ivf_streaming(
    make_chunks,                      # () -> iterator of [chunk, D] arrays
    n: int,
    d: int,
    n_clusters: int = 0,
    bucket_cap: int = 0,
    iters: int = 10,
    seed: int = 0,
    dtype=jnp.bfloat16,
    chunk: int = _STREAM_CHUNK,
    sample: Optional[jnp.ndarray] = None,     # training rows [M, D]
    centroids: Optional[jnp.ndarray] = None,
    assignments: Optional[np.ndarray] = None,
    train_rows: int = 262_144,
    quantize: bool = False,
    mesh=None,
    cover: float = 0.98,
    slots_frac: float = 1.3,
) -> IVFIndex:
    """Build from a re-iterable chunk source (device arrays welcome — the
    10M bench generates chunks on device, CLAUDE.md rule). Chunks must be
    exactly `chunk` rows (zero-pad the tail); passes: [sample], assign,
    fill. If `sample` is None the training rows are strided out of the
    stream itself (one extra pass). With `mesh`, bucket cap / spill pad
    round up to 8*n_shards, arrays allocate sharded (slot-sharding,
    parallel/ivf.py), and the fill scatters run under GSPMD — each chunk
    is replicated once and every shard keeps only its strip."""
    if n <= 0:
        raise ValueError("empty gallery")
    if assignments is not None and centroids is None:
        # fresh centroids would disagree with the stale row placement:
        # probe selection (new centroids) and bucket contents (old
        # assignments) silently diverge and recall degrades with no error
        raise ValueError(
            "assignments without centroids: reusing a prior assignment "
            "pass only makes sense with the centroids that produced it")
    if n_clusters <= 0:
        n_clusters = auto_clusters(n)
    n_clusters = min(n_clusters, n)
    dp = _round_up(d, 128)

    if centroids is None:
        if sample is None:
            m = min(n, max(train_rows, n_clusters))
            stride = max(1, n // m)
            parts = []
            for ci, rows in enumerate(make_chunks()):
                base = ci * chunk
                valid = min(chunk, n - base)
                parts.append(jnp.asarray(rows)[: valid: stride])
            sample = jnp.concatenate(parts, axis=0)[:m]
            del parts
        centroids = train_centroids(np.asarray(sample, np.float32),
                                    n_clusters, iters=iters, seed=seed)
    # the sample must not stay resident next to the bucket array (a 10M
    # build OOMed with 0.5 GB of dead sample rows still alive)
    sample = None
    cents = l2_normalize(jnp.asarray(centroids, jnp.float32))
    if cents.shape[0] != n_clusters:
        raise ValueError("centroids/n_clusters mismatch")

    if assignments is None:
        parts = []
        for rows in make_chunks():
            parts.append(np.asarray(_assign_chunk(jnp.asarray(rows), cents)))
        assignments = np.concatenate(parts)[:n]
    assignments = np.asarray(assignments, np.int32)
    if assignments.shape[0] != n:
        raise ValueError("assignments/rows mismatch")

    quant = {True: "int8", False: "", None: ""}.get(quantize, quantize)
    if quant not in ("", "int8", "int4"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    if bucket_cap <= 0:
        bucket_cap = _auto_cap(assignments, n_clusters, n, cover=cover,
                               max_slots_frac=slots_frac)
    bucket_cap = min(bucket_cap, _round_up(n, 8))
    n_shards = 1
    if mesh is not None:
        from mmrs_tpu.parallel.mesh import DATA_AXIS

        n_shards = mesh.shape[DATA_AXIS]
        bucket_cap = _round_up(bucket_cap, 8 * n_shards)

    bpos, spos, bucket_ids, spill_ids = _placement(assignments, n_clusters,
                                                   bucket_cap)
    n_spill = spill_ids.shape[0]
    s_pad = max(8, _round_up(n_spill, 8 * n_shards))
    item = {"": jnp.dtype(dtype).itemsize, "int8": 1, "int4": 0.5}[quant]
    log.info(
        "ivf: C=%d cap=%d -> %.2f GB buckets + %.2f GB spill (%d rows, "
        "%.2f%% — scanned exactly)",
        n_clusters, bucket_cap,
        n_clusters * bucket_cap * dp * item / 1e9,
        s_pad * dp * item / 1e9, n_spill, 100.0 * n_spill / n)

    shardings = {}
    if mesh is not None:
        from mmrs_tpu.parallel.ivf import ivf_shardings

        shardings = ivf_shardings(mesh, quant=quant)

    def zeros(name, shape, zdtype):
        if mesh is None:
            return jnp.zeros(shape, zdtype)
        # allocate straight into the sharded layout: each chip only ever
        # holds its strip, never the whole array
        return jax.jit(lambda: jnp.zeros(shape, zdtype),
                       out_shardings=shardings[name])()

    bscales = sscales = None
    if quant == "int4":
        buckets = zeros("buckets", (n_clusters, dp // 8, bucket_cap),
                        jnp.int32)
        spill = zeros("spill", (dp // 8, s_pad), jnp.int32)
    else:
        row_dtype = jnp.int8 if quant else dtype
        buckets = zeros("buckets", (n_clusters, bucket_cap, dp), row_dtype)
        spill = zeros("spill", (s_pad, dp), row_dtype)
    if quant:
        bscales = zeros("bucket_scales", (n_clusters, bucket_cap),
                        jnp.float32)
        sscales = zeros("spill_scales", (s_pad,), jnp.float32)
    for ci, rows in enumerate(make_chunks()):
        a = ci * chunk
        b = min(a + chunk, n)
        bp = np.full(chunk, -1, np.int32)
        sp = np.full(chunk, -1, np.int32)
        bp[:b - a] = bpos[a:b]
        sp[:b - a] = spos[a:b]
        bp = jnp.asarray(_oob(bp, n_clusters * bucket_cap))
        sp = jnp.asarray(_oob(sp, s_pad))
        rows = jnp.asarray(rows)
        if mesh is not None:
            # replicate the chunk + positions so the donated sharded
            # carries and the updates live on one device set (committed
            # single-device operands can't mix with mesh-sharded ones)
            from jax.sharding import NamedSharding, PartitionSpec as PS

            rep = NamedSharding(mesh, PS())
            rows = jax.device_put(rows, rep)
            bp = jax.device_put(bp, rep)
            sp = jax.device_put(sp, rep)
        if quant == "int4":
            buckets, bscales, spill, sscales = _fill_chunk_q4(
                buckets, bscales, spill, sscales, rows, bp, sp)
        elif quant:
            buckets, bscales, spill, sscales = _fill_chunk_q8(
                buckets, bscales, spill, sscales, rows, bp, sp)
        else:
            buckets, spill = _fill_chunk(buckets, spill, rows, bp, sp)

    sids = np.full(s_pad, -1, np.int32)
    sids[:n_spill] = spill_ids
    cents_p = cents
    if dp != d:
        cents_p = jnp.zeros((n_clusters, dp), cents.dtype).at[:, :d].set(cents)
    centroids_out = cents_p.astype(dtype)
    bucket_ids_out = jnp.asarray(bucket_ids.reshape(n_clusters, bucket_cap))
    spill_ids_out = jnp.asarray(sids)
    if mesh is not None:
        centroids_out = jax.device_put(centroids_out, shardings["centroids"])
        bucket_ids_out = jax.device_put(bucket_ids_out,
                                        shardings["bucket_ids"])
        spill_ids_out = jax.device_put(spill_ids_out, shardings["spill_ids"])
    return IVFIndex(
        centroids=centroids_out,
        buckets=buckets,
        bucket_ids=bucket_ids_out,
        spill=spill,
        spill_ids=spill_ids_out,
        n_total=n,
        dim=d,
        bucket_scales=bscales,
        spill_scales=sscales,
    )


# -- search -------------------------------------------------------------------


def _probe_kernel(*refs, cap: int, d: int, k: int, kp: int, tile_r: int,
                  bk: int, quantized: bool):
    """One block = one row tile of one probed bucket of one query: it
    loads its own bucket id probe[q, p], scores the tile's rows against
    the query row (f32 multiply-add over D chunks) and writes the tile's
    top-k candidates."""
    if quantized:
        probe_ref, q_ref, b_ref, ids_ref, s_ref, ov_ref, oi_ref = refs
    else:
        probe_ref, q_ref, b_ref, ids_ref, ov_ref, oi_ref = refs
    qi = pl.program_id(0)
    pi = pl.program_id(1)
    ri = pl.program_id(2)
    c = probe_ref[qi, pi]
    start = ri * tile_r
    rmask = start + jnp.arange(tile_r, dtype=jnp.int32) < cap

    def chunk(j, acc):
        kmask = j * bk + jnp.arange(bk) < d
        qv = plt.load(q_ref.at[qi, pl.ds(j * bk, bk)], mask=kmask, other=0)
        b = plt.load(b_ref.at[c, pl.ds(start, tile_r), pl.ds(j * bk, bk)],
                     mask=rmask[:, None] & kmask[None, :], other=0)
        prod = b.astype(jnp.float32) * qv.astype(jnp.float32)[None, :]
        return acc + jnp.sum(prod, axis=1)

    scores = jax.lax.fori_loop(0, pl.cdiv(d, bk), chunk,
                               jnp.zeros((tile_r,), jnp.float32))
    ids = plt.load(ids_ref.at[c, pl.ds(start, tile_r)], mask=rmask, other=-1)
    if quantized:
        # int8 rows: the device-memory read is int8; the per-slot dequant
        # scales fold into the score row
        scores = scores * plt.load(s_ref.at[c, pl.ds(start, tile_r)],
                                   mask=rmask, other=0.0)
    scores = jnp.where(ids >= 0, scores, NEG_INF)
    ov, oi = tile_topk(scores[None, :], k, kp, ids=ids[None, :])
    ov_ref[...] = ov
    oi_ref[...] = oi


def _probe_buckets_pallas(q, probe, buckets, bucket_ids, scales, k: int,
                          tile_r: int = 128, bk: int = 64,
                          interpret: bool = False):
    """[Q, k] top-k over each query's probed buckets. Only the probed
    buckets are read from device memory and nothing is gathered: each
    block reads its own bucket id. XLA merges the per-(query, probe, row
    tile) candidates."""
    qn = q.shape[0]
    c, cap, dp = buckets.shape
    p = probe.shape[1]
    quantized = scales is not None
    tile_r = min(tile_r, max(16, pl.next_power_of_2(cap)))
    bk = min(bk, max(16, pl.next_power_of_2(dp)))
    kp = candidate_width(k)
    nr = pl.cdiv(cap, tile_r)
    args = [probe, q, buckets, bucket_ids] + ([scales] if quantized else [])
    out_spec = pl.BlockSpec((None, None, 1, kp), lambda i, j, r: (i, j, r, 0))
    ov, oi = pl.pallas_call(
        functools.partial(_probe_kernel, cap=cap, d=dp, k=k, kp=kp,
                          tile_r=tile_r, bk=bk, quantized=quantized),
        grid=(qn, p, nr),
        in_specs=[pl.no_block_spec] * len(args),
        out_specs=(out_spec, out_spec),
        out_shape=(jax.ShapeDtypeStruct((qn, p, nr, kp), jnp.float32),
                   jax.ShapeDtypeStruct((qn, p, nr, kp), jnp.int32)),
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=3),
        interpret=interpret,
        name="ivf_probe_int8" if quantized else "ivf_probe",
    )(*args)
    ov = ov.reshape(qn, p * nr * kp)
    oi = oi.reshape(qn, p * nr * kp)
    vals, at = jax.lax.top_k(ov, k)
    return vals, jnp.take_along_axis(oi, at, axis=1)


def _probe_buckets_xla(q, probe, buckets, bucket_ids, scales, k: int):
    """Oracle / CPU path: per-query bucket gather, memory bounded by
    lax.map's one-query working set ([P, cap, Dp])."""
    cap = buckets.shape[1]
    p = probe.shape[1]
    kk = min(k, p * cap)

    def per_query(args):
        qv, pids = args
        b = jnp.take(buckets, pids, axis=0)          # [P, cap, Dp]
        ids = jnp.take(bucket_ids, pids, axis=0)     # [P, cap]
        s = exact_dot_t(b.reshape(p * cap, -1).astype(qv.dtype),
                        qv[None, :])[:, 0]
        if scales is not None:
            s = s * jnp.take(scales, pids, axis=0).reshape(-1)
        s = jnp.where(ids.reshape(-1) >= 0, s, NEG_INF)
        v, i = jax.lax.top_k(s, kk)
        return v, jnp.take(ids.reshape(-1), i).astype(jnp.int32)

    vals, ids = jax.lax.map(per_query, (q, probe))
    if kk < k:
        pad_v = jnp.full((q.shape[0], k - kk), NEG_INF, jnp.float32)
        pad_i = jnp.full((q.shape[0], k - kk), -1, jnp.int32)
        vals = jnp.concatenate([vals, pad_v], axis=1)
        ids = jnp.concatenate([ids, pad_i], axis=1)
    return vals, ids


def _ivf_topk_body(q, centroids, buckets, bucket_ids, spill, spill_ids,
                   bucket_scales, spill_scales,
                   k: int, nprobe: int, impl: str):
    """Probe + spill scan, returning ([Q, k] f32 cosines, [Q, k] int32
    GLOBAL row ids, -1 padded). Shard-local by construction: ids are
    stored global, so parallel/ivf.py runs this body per shard over a
    slot strip and all-gather-merges (the bucket arrays just get
    narrower on the cap axis)."""
    qn, d = q.shape
    dp = buckets.shape[2]
    if d != dp:
        q = jnp.zeros((qn, dp), q.dtype).at[:, :d].set(q)

    csims = jax.lax.dot_general(
        q.astype(centroids.dtype), centroids, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)                 # [Q, C]
    _, probe = jax.lax.top_k(csims, nprobe)                 # [Q, P]
    probe = probe.astype(jnp.int32)

    quantized = bucket_scales is not None
    qd = q.astype(jnp.bfloat16 if quantized else buckets.dtype)
    if impl == "xla":
        vals, ids = _probe_buckets_xla(qd, probe, buckets, bucket_ids,
                                       bucket_scales, k)
    else:
        vals, ids = _probe_buckets_pallas(
            qd, probe, buckets, bucket_ids, bucket_scales, k,
            interpret=impl == "pallas_interpret")

    # exact spill scan (tiny): overflow rows never cost recall
    ss = exact_dot_t(qd, spill.astype(qd.dtype))            # [Q, S]
    if quantized:
        ss = ss * spill_scales[None, :]
    ss = jnp.where(spill_ids[None, :] >= 0, ss, NEG_INF)
    ks = min(k, spill.shape[0])
    sv, si = jax.lax.top_k(ss, ks)
    sid = jnp.take(spill_ids, si)

    mv = jnp.concatenate([vals, sv], axis=1)
    mi = jnp.concatenate([ids, sid], axis=1)
    fv, fi = jax.lax.top_k(mv, k)
    fi = jnp.take_along_axis(mi, fi, axis=1)
    return jnp.where(fi < 0, NEG_INF, fv), fi


def _probe_buckets_xla_q4(q_q, q_scale, rs_q, probe, buckets, bucket_ids,
                          scales, k: int):
    """Oracle / CPU path for int4 buckets — bit-identical epilogue math
    (ops/quant4._score_f32), per-query gather bounded by lax.map."""
    from mmrs_tpu.ops.quant4 import _score_f32, _unpack_planes_xla

    c, dw, cap = buckets.shape
    p = probe.shape[1]
    kk = min(k, p * cap)

    def per_query(args):
        qv, qs, rs, pids = args
        b = jnp.take(buckets, pids, axis=0)          # [P, dw, cap]
        ids = jnp.take(bucket_ids, pids, axis=0)     # [P, cap]
        w = jnp.transpose(b, (1, 0, 2)).reshape(dw, p * cap)
        lo, hi = _unpack_planes_xla(w)               # [Dp/2, P*cap]
        h = lo.shape[0]
        dlo = jax.lax.dot_general(qv[None, :h], lo,
                                  (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.int32)
        dhi = jax.lax.dot_general(qv[None, h:], hi,
                                  (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.int32)
        s_tile = jnp.take(scales, pids, axis=0).reshape(1, -1)
        s = _score_f32(dlo, dhi, rs, qs, s_tile)[0]
        s = jnp.where(ids.reshape(-1) >= 0, s, NEG_INF)
        v, i = jax.lax.top_k(s, kk)
        return v, jnp.take(ids.reshape(-1), i).astype(jnp.int32)

    vals, ids = jax.lax.map(per_query, (q_q, q_scale, rs_q, probe))
    if kk < k:
        pad_v = jnp.full((q_q.shape[0], k - kk), NEG_INF, jnp.float32)
        pad_i = jnp.full((q_q.shape[0], k - kk), -1, jnp.int32)
        vals = jnp.concatenate([vals, pad_v], axis=1)
        ids = jnp.concatenate([ids, pad_i], axis=1)
    return vals, ids


def _ivf_topk_body_q4(q, centroids, buckets, bucket_ids, spill, spill_ids,
                      bucket_scales, spill_scales,
                      k: int, nprobe: int, impl: str):
    """int4 probe + packed spill scan ([Q, k] f32, [Q, k] global ids)."""
    from mmrs_tpu.ops.quant4 import (_prep_queries, _score_f32,
                                     _unpack_planes_xla)

    qn, d = q.shape
    dp = buckets.shape[1] * 8
    if d != dp:
        q = jnp.zeros((qn, dp), q.dtype).at[:, :d].set(q)

    csims = jax.lax.dot_general(
        q.astype(centroids.dtype), centroids, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)                 # [Q, C]
    _, probe = jax.lax.top_k(csims, nprobe)
    probe = probe.astype(jnp.int32)

    q_q, q_scale, rs_q = _prep_queries(q.astype(jnp.float32))
    vals, ids = _probe_buckets_xla_q4(
        q_q, q_scale, rs_q, probe, buckets, bucket_ids, bucket_scales, k)

    # exact spill scan over the flat packed plane
    lo, hi = _unpack_planes_xla(spill)                      # [Dp/2, S]
    h = lo.shape[0]
    dlo = jax.lax.dot_general(q_q[:, :h], lo, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    dhi = jax.lax.dot_general(q_q[:, h:], hi, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    ss = _score_f32(dlo, dhi, rs_q[:, None], q_scale[:, None],
                    spill_scales[None, :])                  # [Q, S]
    ss = jnp.where(spill_ids[None, :] >= 0, ss, NEG_INF)
    ks = min(k, spill.shape[1])
    sv, si = jax.lax.top_k(ss, ks)
    sid = jnp.take(spill_ids, si)

    mv = jnp.concatenate([vals, sv], axis=1)
    mi = jnp.concatenate([ids, sid], axis=1)
    fv, fi = jax.lax.top_k(mv, k)
    fi = jnp.take_along_axis(mi, fi, axis=1)
    return jnp.where(fi < 0, NEG_INF, fv), fi


def probe_impl(quant: str, impl: str) -> str:
    """ops/dispatch.py's rule for the bucket probe. int4 buckets have no
    kernel: they always take the XLA form, and asking for the kernel
    raises."""
    if quant != "int4":
        return resolve_impl("ivf_probe", impl)
    if impl not in ("auto", "xla"):
        raise ValueError(f"int4 IVF buckets have no kernel (impl={impl!r})")
    return "xla"


@functools.partial(jax.jit, static_argnames=("k", "nprobe", "impl",
                                             "quant"))
def _ivf_topk(q, centroids, buckets, bucket_ids, spill, spill_ids,
              bucket_scales, spill_scales, k: int, nprobe: int, impl: str,
              quant: str = ""):
    body = _ivf_topk_body_q4 if quant == "int4" else _ivf_topk_body
    return body(q, centroids, buckets, bucket_ids, spill,
                spill_ids, bucket_scales, spill_scales,
                k, nprobe, impl)


def ivf_topk(
    queries: jnp.ndarray,     # [Q, D] L2-normalized
    ivf: IVFIndex,
    k: int = 10,
    nprobe: int = 0,          # 0 = auto
    impl: str = "auto",       # ops/dispatch.py
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k (cosines [Q, k] f32, global row ids [Q, k] int32), sorted
    descending — the cosine_topk contract, restricted to probed buckets
    (+ the exact spill). nprobe == n_clusters reproduces brute force."""
    if nprobe <= 0:
        nprobe = auto_nprobe(ivf.n_clusters)
    nprobe = min(nprobe, ivf.n_clusters)
    k = min(k, ivf.n_total)
    impl = probe_impl(ivf.quant, impl)
    return _ivf_topk(queries, ivf.centroids, ivf.buckets, ivf.bucket_ids,
                     ivf.spill, ivf.spill_ids, ivf.bucket_scales,
                     ivf.spill_scales, k, nprobe, impl, quant=ivf.quant)


def tune_nprobe(
    ivf: IVFIndex,
    embeddings,               # [N, D] host array-like (memmap ok)
    target_recall: float = 0.95,
    k: int = 10,
    n_queries: int = 64,
    impl: str = "auto",
    mesh=None,
) -> dict:
    """Smallest power-of-two nprobe whose measured recall@k against the
    exact scan reaches `target_recall`, on a strided row sample as
    queries. Probe sets NEST as nprobe grows (top-nprobe centroids),
    so recall is monotone and a doubling walk suffices — the faiss-style
    recall/latency knob, measured per corpus instead of guessed
    (`auto_nprobe` is the blind default). The exact oracle streams
    chunk-at-a-time (index/stream.py): the flat gallery is never fully
    device-resident next to the buckets.

    Returns {"nprobe", "recall", "target", "k", "curve": {nprobe: r}}.
    """
    from mmrs_tpu.index.stream import streaming_topk

    n = embeddings.shape[0]
    sel = np.unique(np.linspace(0, n - 1, n_queries).astype(np.int64))
    q_host = np.asarray(embeddings[sel], np.float32)
    q = l2_normalize(jnp.asarray(q_host))
    k = min(k, n)
    _, exact = streaming_topk(embeddings, q_host, k=k, mesh=mesh)
    exact = np.asarray(exact)

    def recall_at(nprobe: int) -> float:
        if mesh is not None:
            from mmrs_tpu.parallel.ivf import sharded_ivf_topk

            _, got = sharded_ivf_topk(q, ivf, k=k, nprobe=nprobe,
                                      mesh=mesh, impl=impl)
        else:
            _, got = ivf_topk(q, ivf, k=k, nprobe=nprobe, impl=impl)
        got = np.asarray(got)
        return sum(len(set(exact[i]) & set(got[i]))
                   for i in range(got.shape[0])) / float(got.size)

    curve = {}
    nprobe = 1
    chosen = None
    while True:
        nprobe = min(nprobe, ivf.n_clusters)
        r = recall_at(nprobe)
        curve[nprobe] = r
        if r >= target_recall or nprobe >= ivf.n_clusters:
            chosen = nprobe
            break
        nprobe *= 2
    log.info("tune_nprobe: target %.3f -> nprobe=%d (recall %.4f; curve %s)",
             target_recall, chosen, curve[chosen],
             {p: round(r, 4) for p, r in curve.items()})
    return {"nprobe": chosen, "recall": curve[chosen],
            "target": target_recall, "k": k,
            "curve": {int(p): float(r) for p, r in curve.items()}}


def ivf_recall(ivf: IVFIndex, embeddings, queries, k: int = 10,
               nprobe: int = 0, impl: str = "auto") -> float:
    """Measured recall@k vs the exact scan for a query sample — the knob
    report for choosing nprobe (mirrors faiss practice; the reference has
    no ANN story to compare)."""
    from mmrs_tpu.ops.topk import cosine_topk

    q = l2_normalize(jnp.asarray(np.asarray(queries), jnp.float32))
    g = l2_normalize(jnp.asarray(np.asarray(embeddings), jnp.float32))
    oracle_dtype = jnp.bfloat16 if ivf.quantized else ivf.buckets.dtype
    _, exact = cosine_topk(q.astype(oracle_dtype),
                           g.astype(oracle_dtype), k, impl="xla")
    _, got = ivf_topk(q, ivf, k=k, nprobe=nprobe, impl=impl)
    exact = np.asarray(exact)
    got = np.asarray(got)
    hits = sum(len(set(exact[i]) & set(got[i])) for i in range(exact.shape[0]))
    return hits / float(exact.shape[0] * exact.shape[1])


# -- persistence --------------------------------------------------------------


def gallery_fingerprint(embeddings) -> str:
    """Cheap content identity for a gallery: shape + md5 over ~64 strided
    rows (memmap-friendly — only the sampled rows are read). Guards a
    sidecar against a gallery that changed at unchanged shape: the
    stored slot maps would then disagree with the rebuilt rows and
    recall would degrade silently."""
    import hashlib

    n, d = embeddings.shape
    h = hashlib.md5(f"{n}x{d}".encode())
    # n == 0: shape-only hash (linspace(0, -1) would index row -1)
    for i in (np.unique(np.linspace(0, n - 1, 64).astype(np.int64))
              if n else ()):
        h.update(np.ascontiguousarray(
            np.asarray(embeddings[int(i)], np.float32)).tobytes())
    return h.hexdigest()


def sidecar_meta(directory: str) -> Optional[dict]:
    """The saved sidecar's meta dict, or None if no sidecar exists."""
    path = os.path.join(directory, "ivf.json")
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def update_sidecar_meta(directory: str, **extra) -> None:
    """Merge extra keys (e.g. the tuned-nprobe record) into ivf.json
    atomically."""
    meta = sidecar_meta(directory)
    if meta is None:
        raise FileNotFoundError(f"no ivf sidecar in {directory}")
    meta.update(extra)
    tmp = os.path.join(directory, "ivf.json.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(directory, "ivf.json"))


def save_ivf(directory: str, ivf: IVFIndex, embeddings=None) -> None:
    """Sidecar persistence next to a gallery: centroids + slot maps only
    (the bucket ROWS are rebuilt from the gallery on load — the sidecar
    stays ~4 bytes/row, not another copy of the embeddings). Pass the
    gallery `embeddings` to stamp a content fingerprint that load_ivf
    verifies."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, "ivf.npz.tmp.npz")
    np.savez(
        tmp,
        centroids=np.asarray(ivf.centroids, np.float32),
        bucket_ids=np.asarray(ivf.bucket_ids),
        spill_ids=np.asarray(ivf.spill_ids),
    )
    os.replace(tmp, os.path.join(directory, "ivf.npz"))
    meta = {"n_total": ivf.n_total, "dim": ivf.dim,
            "n_clusters": ivf.n_clusters, "bucket_cap": ivf.bucket_cap,
            "quantized": ivf.quantized, "quant": ivf.quant}
    if embeddings is not None:
        meta["fingerprint"] = gallery_fingerprint(embeddings)
    tmp_m = os.path.join(directory, "ivf.json.tmp")
    with open(tmp_m, "w", encoding="utf-8") as f:
        json.dump(meta, f)
    os.replace(tmp_m, os.path.join(directory, "ivf.json"))


def extend_sidecar(directory: str, embeddings,
                   chunk: int = _STREAM_CHUNK) -> dict:
    """Extend a saved sidecar to cover rows APPENDED to the gallery since
    it was saved (the `mmrs index update` flow): assign only the new
    rows with the SAVED centroids, place them into each cluster's free
    slots (overflow appends to the spill — scanned exactly, so recall
    never degrades; only small-Q latency grows with repeated extends,
    rebuild when spill gets heavy), and rewrite the sidecar atomically.
    The k-means training and the assignment pass over the OLD rows —
    the expensive build passes — never re-run. Returns the new meta."""
    meta = sidecar_meta(directory)
    if meta is None:
        raise FileNotFoundError(f"no ivf sidecar in {directory}")
    n_old, d = meta["n_total"], meta["dim"]
    n = embeddings.shape[0]
    if embeddings.shape[1] != d:
        raise ValueError(f"dim {embeddings.shape[1]} != sidecar {d}")
    if n < n_old:
        raise ValueError(
            f"gallery shrank ({n} < {n_old}): extend only handles "
            "appends — rebuild with build_ivf")
    if meta.get("fingerprint"):
        got = gallery_fingerprint(embeddings[:n_old])
        if got != meta["fingerprint"]:
            raise ValueError(
                "sidecar fingerprint mismatch on the OLD prefix — the "
                "existing rows changed, not just appended; rebuild")
    z = np.load(os.path.join(directory, "ivf.npz"))
    # stored centroids are lane-padded to Dp with zeros and unit-norm:
    # slicing back to the true dim preserves every assignment sim
    cents = jnp.asarray(z["centroids"][:, :d], jnp.float32)
    bucket_ids = np.array(z["bucket_ids"])            # [C, cap]
    spill_ids = list(z["spill_ids"][z["spill_ids"] >= 0])
    c, cap = bucket_ids.shape

    # assign only the appended rows (chunked device matmuls)
    parts = []
    for a in range(n_old, n, chunk):
        rows = np.asarray(embeddings[a:min(a + chunk, n)], np.float32)
        parts.append(np.asarray(_assign_chunk(jnp.asarray(rows), cents)))
    assign_new = np.concatenate(parts) if parts else np.zeros(0, np.int32)

    # next free slot per cluster (ids fill front-to-back at build)
    free = (bucket_ids >= 0).sum(axis=1).astype(np.int64)   # [C]
    for j, cl in enumerate(assign_new):
        row = n_old + j
        s = free[cl]
        if s < cap:
            bucket_ids[cl, s] = row
            free[cl] += 1
        else:
            spill_ids.append(row)

    s_pad = max(8, _round_up(len(spill_ids), 8))   # never a 0-row spill
    spill_arr = np.full(s_pad, -1, np.int32)
    spill_arr[: len(spill_ids)] = spill_ids
    tmp = os.path.join(directory, "ivf.npz.tmp.npz")
    np.savez(tmp, centroids=z["centroids"], bucket_ids=bucket_ids,
             spill_ids=spill_arr)
    os.replace(tmp, os.path.join(directory, "ivf.npz"))
    new_meta = dict(meta)
    new_meta["n_total"] = n
    new_meta["fingerprint"] = gallery_fingerprint(embeddings)
    new_meta.pop("tuned", None)   # recall drifted; re-measure on demand
    tmp_m = os.path.join(directory, "ivf.json.tmp")
    with open(tmp_m, "w", encoding="utf-8") as f:
        json.dump(new_meta, f)
    os.replace(tmp_m, os.path.join(directory, "ivf.json"))
    log.info("ivf sidecar extended: %d -> %d rows (%d new; spill now %d)",
             n_old, n, n - n_old, len(spill_ids))
    return new_meta


def shrink_sidecar(directory: str, kept_mask, embeddings,
                   chunk: int = _STREAM_CHUNK) -> dict:
    """Shrink a saved sidecar after rows were DELETED from the gallery —
    the index side of the governance deletions (dedup/leakage/delete →
    `mmrs index compact`, which calls this; the reference instead
    re-embeds from scratch after its tool/delete*.py passes,
    /root/reference/tool/delete repeated.py:1-40). `kept_mask` is a bool
    array over the PRE-compaction row order; `embeddings` is the
    post-compaction gallery (the kept rows, original relative order —
    compact_index's contract). Ids renumber in place and each bucket
    re-front-fills (so a later extend_sidecar append stays valid), then
    former SPILL rows are re-placed into the freed slots using the SAVED
    centroids — deletions make queries cheaper, never looser. The
    k-means training pass never re-runs. Returns the new meta."""
    meta = sidecar_meta(directory)
    if meta is None:
        raise FileNotFoundError(f"no ivf sidecar in {directory}")
    kept = np.asarray(kept_mask, bool)
    if kept.shape[0] != meta["n_total"]:
        raise ValueError(f"mask covers {kept.shape[0]} rows, sidecar "
                         f"has {meta['n_total']}")
    n_new, d = int(kept.sum()), meta["dim"]
    if n_new == 0:
        # a compaction that deletes every row leaves nothing to index;
        # ValueError keeps compact_index on its warn-and-retrain path
        raise ValueError("compaction kept 0 rows — nothing to shrink; "
                         "rebuild the sidecar when rows return")
    if embeddings.shape[0] != n_new or embeddings.shape[1] != d:
        raise ValueError(
            f"post-compaction gallery is {embeddings.shape}, mask keeps "
            f"{n_new}x{d} — pass the compacted gallery and its mask")
    z = np.load(os.path.join(directory, "ivf.npz"))
    # old row id -> new row id (-1 for dropped); np.where evaluates the
    # gather on -1 pad ids too (wraps to the last element) — harmless,
    # the where picks -1 for those lanes
    new_of = np.where(kept, np.cumsum(kept) - 1, -1).astype(np.int32)
    old_ids = np.array(z["bucket_ids"])               # [C, cap]
    c, cap = old_ids.shape
    bucket_ids = np.where(old_ids >= 0, new_of[old_ids], -1)
    # re-front-fill every bucket: dropped rows left holes, and both the
    # probe mask and extend_sidecar's free-slot counter assume the live
    # prefix is contiguous
    order = np.argsort(bucket_ids < 0, axis=1, kind="stable")
    bucket_ids = np.take_along_axis(bucket_ids, order, axis=1)
    sp = z["spill_ids"]
    spill = np.where(sp >= 0, new_of[sp], -1)
    spill = spill[spill >= 0]
    # re-place surviving spill rows into freed bucket slots (saved
    # centroids, chunked device matmuls): the spill strip is scanned by
    # EVERY query, so shrinking it is the latency win of a delete
    if spill.size:
        cents = jnp.asarray(z["centroids"][:, :d], jnp.float32)
        free = (bucket_ids >= 0).sum(axis=1).astype(np.int64)
        still_spilled = []
        for a in range(0, spill.size, chunk):
            ids = spill[a:a + chunk]
            rows = np.asarray(embeddings[ids], np.float32)
            assign = np.asarray(_assign_chunk(jnp.asarray(rows), cents))
            for rid, cl in zip(ids, assign):
                s = free[cl]
                if s < cap:
                    bucket_ids[cl, s] = rid
                    free[cl] += 1
                else:
                    still_spilled.append(int(rid))
        spill = np.asarray(still_spilled, np.int32)
    s_pad = max(8, _round_up(spill.size, 8))   # never a 0-row spill
    spill_arr = np.full(s_pad, -1, np.int32)
    spill_arr[: spill.size] = spill
    tmp = os.path.join(directory, "ivf.npz.tmp.npz")
    np.savez(tmp, centroids=z["centroids"], bucket_ids=bucket_ids,
             spill_ids=spill_arr)
    os.replace(tmp, os.path.join(directory, "ivf.npz"))
    new_meta = dict(meta)
    new_meta["n_total"] = n_new
    new_meta["fingerprint"] = gallery_fingerprint(embeddings)
    new_meta.pop("tuned", None)   # recall drifted; re-measure on demand
    tmp_m = os.path.join(directory, "ivf.json.tmp")
    with open(tmp_m, "w", encoding="utf-8") as f:
        json.dump(new_meta, f)
    os.replace(tmp_m, os.path.join(directory, "ivf.json"))
    log.info("ivf sidecar shrunk: %d -> %d rows (spill now %d)",
             kept.shape[0], n_new, spill.size)
    return new_meta


def load_ivf(directory: str, embeddings=None, dtype=jnp.bfloat16,
             chunk: int = _STREAM_CHUNK, mesh=None, make_chunks=None,
             n: int = 0, d: int = 0) -> IVFIndex:
    """Rebuild the device structure from a save_ivf sidecar + the gallery
    rows (streamed; one pass, no training, no assignment). With `mesh`,
    arrays allocate straight into the slot-sharded layout (as in
    build_ivf(mesh=)). Rows come from `embeddings` (host array-like,
    fingerprint-verified) OR a `make_chunks` device-chunk source with
    explicit n/d (build_ivf_streaming's contract; no fingerprint —
    the caller vouches the stream matches the sidecar)."""
    with open(os.path.join(directory, "ivf.json"), encoding="utf-8") as f:
        meta = json.load(f)
    z = np.load(os.path.join(directory, "ivf.npz"))
    if embeddings is not None:
        n, d = embeddings.shape
    elif make_chunks is None or n <= 0 or d <= 0:
        raise ValueError("need embeddings, or make_chunks with n and d")
    if n != meta["n_total"] or d != meta["dim"]:
        raise ValueError(
            f"ivf sidecar built for {meta['n_total']}x{meta['dim']}, "
            f"gallery is {n}x{d} — rebuild with build_ivf")
    if embeddings is not None and meta.get("fingerprint"):
        got = gallery_fingerprint(embeddings)
        if got != meta["fingerprint"]:
            raise ValueError(
                "ivf sidecar fingerprint mismatch: the gallery content "
                "changed since the sidecar was saved (same shape, "
                "different rows) — rebuild with build_ivf")
    bucket_ids = z["bucket_ids"]
    spill_ids = z["spill_ids"]
    quant = meta.get("quant", "int8" if meta.get("quantized") else "")
    c, cap = bucket_ids.shape
    dp = _round_up(d, 128)
    n_shards = 1
    shardings = {}
    if mesh is not None:
        from mmrs_tpu.parallel.ivf import ivf_shardings
        from mmrs_tpu.parallel.mesh import DATA_AXIS

        n_shards = mesh.shape[DATA_AXIS]
        shardings = ivf_shardings(mesh, quant=quant)
        # slot-sharding needs shard-divisible cap/spill: pad with dead
        # slots (id -1, zero rows — masked like any other padding)
        cap_p = _round_up(cap, n_shards)
        if cap_p != cap:
            bucket_ids = np.pad(bucket_ids, ((0, 0), (0, cap_p - cap)),
                                constant_values=-1)
            cap = cap_p
        spl_p = _round_up(spill_ids.shape[0], n_shards)
        if spl_p != spill_ids.shape[0]:
            spill_ids = np.pad(spill_ids,
                               (0, spl_p - spill_ids.shape[0]),
                               constant_values=-1)

    bpos = np.full(n, -1, np.int32)
    flat = bucket_ids.reshape(-1)
    live = flat >= 0
    bpos[flat[live]] = np.arange(c * cap, dtype=np.int32)[live]
    spos = np.full(n, -1, np.int32)
    slive = spill_ids >= 0
    spos[spill_ids[slive]] = np.arange(spill_ids.shape[0],
                                       dtype=np.int32)[slive]

    s_rows = spill_ids.shape[0]

    def zeros(name, shape, zdtype):
        if mesh is None:
            return jnp.zeros(shape, zdtype)
        return jax.jit(lambda: jnp.zeros(shape, zdtype),
                       out_shardings=shardings[name])()

    bscales = sscales = None
    if quant == "int4":
        buckets = zeros("buckets", (c, dp // 8, cap), jnp.int32)
        spill = zeros("spill", (dp // 8, s_rows), jnp.int32)
    else:
        row_dtype = jnp.int8 if quant else dtype
        buckets = zeros("buckets", (c, cap, dp), row_dtype)
        spill = zeros("spill", (s_rows, dp), row_dtype)
    if quant:
        bscales = zeros("bucket_scales", (c, cap), jnp.float32)
        sscales = zeros("spill_scales", (s_rows,), jnp.float32)
    def row_chunks():
        if make_chunks is not None:
            for ci, rows in enumerate(make_chunks()):
                yield ci * chunk, jnp.asarray(rows)
            return
        for a in range(0, n, chunk):
            b = min(a + chunk, n)
            rows = np.asarray(embeddings[a:b])
            if b - a < chunk:
                rows = np.concatenate(
                    [rows, np.zeros((chunk - (b - a), d), rows.dtype)])
            yield a, jnp.asarray(rows)

    for a, rows in row_chunks():
        b = min(a + chunk, n)
        bp = np.full(chunk, -1, np.int32)
        sp = np.full(chunk, -1, np.int32)
        bp[:b - a] = bpos[a:b]
        sp[:b - a] = spos[a:b]
        bp = jnp.asarray(_oob(bp, c * cap))
        sp = jnp.asarray(_oob(sp, s_rows))
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as PS

            rep = NamedSharding(mesh, PS())
            rows = jax.device_put(rows, rep)
            bp = jax.device_put(bp, rep)
            sp = jax.device_put(sp, rep)
        if quant == "int4":
            buckets, bscales, spill, sscales = _fill_chunk_q4(
                buckets, bscales, spill, sscales, rows, bp, sp)
        elif quant:
            buckets, bscales, spill, sscales = _fill_chunk_q8(
                buckets, bscales, spill, sscales, rows, bp, sp)
        else:
            buckets, spill = _fill_chunk(buckets, spill, rows, bp, sp)

    cents = jnp.asarray(z["centroids"], jnp.float32)
    if cents.shape[1] != dp:
        cents = jnp.zeros((c, dp), cents.dtype).at[:, :cents.shape[1]].set(
            cents)
    centroids_out = cents.astype(dtype)
    bucket_ids_out = jnp.asarray(bucket_ids)
    spill_ids_out = jnp.asarray(spill_ids)
    if mesh is not None:
        centroids_out = jax.device_put(centroids_out, shardings["centroids"])
        bucket_ids_out = jax.device_put(bucket_ids_out,
                                        shardings["bucket_ids"])
        spill_ids_out = jax.device_put(spill_ids_out, shardings["spill_ids"])
    return IVFIndex(
        centroids=centroids_out,
        buckets=buckets,
        bucket_ids=bucket_ids_out,
        spill=spill,
        spill_ids=spill_ids_out,
        n_total=n,
        dim=d,
        bucket_scales=bscales,
        spill_scales=sscales,
    )
