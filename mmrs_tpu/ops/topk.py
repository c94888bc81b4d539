"""Fused cosine top-k gallery scan: a Pallas kernel for the GPU (Triton).

The query engine's hot op, replacing the reference's
`100. * image_features @ text_features.T` + host-side ranking
(code/search_image.py:105-117, CLIP/lab1.py:90-91). The scan has two
passes:

  1. the kernel: each block scores one gallery tile against a block of
     queries (bf16 or int8 operands on the tensor cores, f32 or int32
     accumulation, D walked in chunks) and extracts that tile's own k best
     (k rounds of max and first-position-of-max), writing
     [Q, n_tiles, kp] candidates; the [Q, N] score matrix never reaches
     device memory;
  2. XLA: `lax.top_k` over the n_tiles * kp candidates of each query.

Ties keep the lowest gallery row first, as `lax.top_k` over the full score
row does. The int8 gallery (ops/quant.py) runs the same kernel with the
per-row dequant scales as an epilogue.

Inputs are expected L2-normalized (the reference's contract,
CLIP/lab1.py:89), so scores are cosines; callers apply logit scaling.

`cosine_topk(..., impl=)` follows ops/dispatch.py: "pallas" (the GPU
kernel), "pallas_interpret", "xla" (the f32 oracle), "auto".
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from mmrs_tpu.ops.dispatch import resolve_impl

NEG_INF = float("-inf")
HIGHEST = jax.lax.Precision.HIGHEST

_MAX_QUERY_BLOCK = 64   # queries scored per block; more go to a 2nd grid axis


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def candidate_width(k: int) -> int:
    """Candidates a tile writes per query: k, padded to a power of two
    (Triton's block rule) and to at least 16."""
    return max(16, pl.next_power_of_2(k))


def tile_topk(vals, k: int, kp: int, ids=None, base=0):
    """The k largest entries of each row of vals [R, T] as ([R, kp] f32,
    [R, kp] int32), sorted descending, -inf / -1 past k and past the
    row's finite entries. The id of an entry is `ids[r, t]` when given,
    else `base + t`. Ties go to the lowest position first. Written with reductions and selects only, so
    the same code runs inside a Triton kernel and in plain XLA."""
    r, t = vals.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (r, t), 1)
    slot = jax.lax.broadcasted_iota(jnp.int32, (r, kp), 1)
    out_v = jnp.full((r, kp), NEG_INF, jnp.float32)
    out_i = jnp.full((r, kp), -1, jnp.int32)
    for j in range(k):
        best = jnp.max(vals, axis=1)                                  # [R]
        at = jnp.min(jnp.where(vals == best[:, None], pos, t), axis=1)
        hit = pos == at[:, None]
        if ids is None:
            got = at + base
        else:
            got = jnp.sum(jnp.where(hit, ids, 0), axis=1)
        # a row with nothing left yields (-inf, -1), never a spent id
        got = jnp.where(best == NEG_INF, -1, got)
        out_v = jnp.where(slot == j, best[:, None], out_v)
        out_i = jnp.where(slot == j, got[:, None], out_i)
        vals = jnp.where(hit, NEG_INF, vals)
    return out_v, out_i


def _scan_kernel(*refs, n: int, d: int, k: int, kp: int, tile_n: int,
                 bk: int, quant: bool):
    if quant:
        q_ref, qs_ref, g_ref, s_ref, ov_ref, oi_ref = refs
    else:
        q_ref, g_ref, ov_ref, oi_ref = refs
    t = pl.program_id(0)
    qb = q_ref.shape[0]
    start = t * tile_n
    rows = start + jnp.arange(tile_n, dtype=jnp.int32)
    rmask = rows < n
    f32 = g_ref.dtype == jnp.float32

    def chunk(c, acc):
        gmask = rmask[:, None]
        if d % bk:
            gmask = gmask & (c * bk + jnp.arange(bk) < d)[None, :]
        q = q_ref[:, pl.ds(c * bk, bk)]
        g = plt.load(g_ref.at[pl.ds(start, tile_n), pl.ds(c * bk, bk)],
                     mask=gmask, other=0)
        return acc + pl.dot(q, g, trans_b=True,
                            precision=HIGHEST if f32 else None)

    acc0 = jnp.zeros((qb, tile_n), jnp.int32 if quant else jnp.float32)
    acc = jax.lax.fori_loop(0, pl.cdiv(d, bk), chunk, acc0)
    if quant:
        s = plt.load(s_ref.at[pl.ds(start, tile_n)], mask=rmask, other=0.0)
        scores = acc.astype(jnp.float32) * qs_ref[...][:, None] * s[None, :]
    else:
        scores = acc
    scores = jnp.where(rmask[None, :], scores, NEG_INF)
    ov, oi = tile_topk(scores, k, kp, base=start)
    ov_ref[...] = ov
    oi_ref[...] = oi


def scan_topk_pallas(
    queries: jnp.ndarray,               # [Q, D] (int8 when scales given)
    gallery: jnp.ndarray,               # [N, D] bf16 | f32 | int8
    k: int,
    tile_n: int = 256,
    bk: int = 64,
    q_scale: Optional[jnp.ndarray] = None,   # [Q] f32 (int8 gallery)
    scales: Optional[jnp.ndarray] = None,    # [N] f32 (int8 gallery)
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Two-pass top-k over gallery rows (module docstring). With `scales`,
    scores are int32 dots times q_scale[q] * scales[n]; otherwise the
    queries are cast to the gallery's dtype."""
    quant = scales is not None
    q, d = queries.shape
    n = gallery.shape[0]
    if n == 0:
        raise ValueError("empty gallery")
    tile_n = min(pl.next_power_of_2(tile_n), max(16, pl.next_power_of_2(n)))
    bk = min(bk, max(16, pl.next_power_of_2(d)))
    kp = candidate_width(k)
    qb = min(_MAX_QUERY_BLOCK, max(16, pl.next_power_of_2(q)))
    qp = _round_up(q, qb)
    dq = _round_up(d, bk)
    queries = queries.astype(gallery.dtype)
    queries = jnp.zeros((qp, dq), queries.dtype).at[:q, :d].set(queries)
    nt = pl.cdiv(n, tile_n)

    in_specs = [pl.BlockSpec((qb, dq), lambda t, j: (j, 0))]
    args = [queries]
    if quant:
        qs = jnp.zeros((qp,), jnp.float32).at[:q].set(q_scale)
        in_specs.append(pl.BlockSpec((qb,), lambda t, j: (j,)))
        args.append(qs)
    in_specs.append(pl.no_block_spec)
    args.append(gallery)
    if quant:
        in_specs.append(pl.no_block_spec)
        args.append(scales.astype(jnp.float32))
    out_spec = pl.BlockSpec((qb, None, kp), lambda t, j: (j, t, 0))
    ov, oi = pl.pallas_call(
        functools.partial(_scan_kernel, n=n, d=d, k=k, kp=kp, tile_n=tile_n,
                          bk=bk, quant=quant),
        grid=(nt, qp // qb),
        in_specs=in_specs,
        out_specs=(out_spec, out_spec),
        out_shape=(jax.ShapeDtypeStruct((qp, nt, kp), jnp.float32),
                   jax.ShapeDtypeStruct((qp, nt, kp), jnp.int32)),
        compiler_params=plt.CompilerParams(
            num_warps=8 if qb * tile_n >= 8192 else 4, num_stages=3),
        interpret=interpret,
        name="scan_topk_int8" if quant else "scan_topk",
    )(*args)
    ov = ov[:q].reshape(q, nt * kp)
    oi = oi[:q].reshape(q, nt * kp)
    vals, at = jax.lax.top_k(ov, k)
    return vals, jnp.take_along_axis(oi, at, axis=1)


def exact_dot_t(a, b):
    """a @ b.T with f32 accumulation at HIGHEST precision, so that an f32
    dot does not run as TF32 on the GPU. bf16 operands stay bf16: their
    products are exact in f32, so nothing is upcast in device memory."""
    dt = jnp.promote_types(a.dtype, b.dtype)
    return jax.lax.dot_general(
        a.astype(dt), b.astype(dt), (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32, precision=HIGHEST)


def _cosine_topk_xla(queries, gallery, k):
    scores = exact_dot_t(queries, gallery)
    vals, idxs = jax.lax.top_k(scores, k)
    return vals, idxs.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k", "impl", "tile_n"))
def cosine_topk(
    queries: jnp.ndarray,
    gallery: jnp.ndarray,
    k: int = 10,
    impl: str = "auto",
    tile_n: int = 256,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k cosine scores and gallery row indices for each query.

    queries [Q, D], gallery [N, D] (both L2-normalized).
    Returns (values [Q, k] f32, indices [Q, k] int32), sorted descending.
    """
    impl = resolve_impl("topk", impl)
    if impl == "xla":
        return _cosine_topk_xla(queries, gallery, k)
    return scan_topk_pallas(queries, gallery, k, tile_n=tile_n,
                            interpret=impl == "pallas_interpret")
