"""Tiled all-pairs similarity with threshold: a Pallas kernel for the GPU.

The semantic-dedup engine replacing the reference's O(N^2) Python hash loops:
  - intra-set dedup (tool/find_repeated_in_same_folder.py:56-106): for each
    row i, find the FIRST earlier row j < i with cosine >= tau. Rows with a
    match are duplicates of an earlier keeper ("keep-first" semantics; the
    chain is resolved on host).
  - cross-set leakage (tool/delete repeated.py:11-162): for each train row,
    find the first test row with cosine >= tau.

The N x M similarity matrix is never materialized. In the kernel
(Triton) each block owns one row tile and walks the column tiles in a
loop, scoring each [TILE, D] x [D, TILE] block on the tensor cores (bf16
operands, f32 accumulation) and folding it at once into a per-row
running minimum matching column kept in registers. The output is a
fixed-shape [N] int32 vector (first matching column, or -1).

The XLA form walks column blocks with `lax.map` and the same
min-reduction, so its working set is [N, block] and not [N, M]. The
untiled `_first_match_xla` is the test oracle.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from mmrs_tpu.ops.dispatch import resolve_impl
from mmrs_tpu.ops.topk import exact_dot_t

BIG = 2**30
HIGHEST = jax.lax.Precision.HIGHEST


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _kernel(tau_ref, offs_ref, a_ref, b_ref, out_ref, *, n: int, m: int,
            d: int, tile: int, bk: int, intra: bool):
    i = pl.program_id(0)
    row_ids = i * tile + jnp.arange(tile, dtype=jnp.int32)
    rmask = row_ids < n
    tau = tau_ref[0]
    f32 = a_ref.dtype == jnp.float32

    def col_tile(j, run_min):
        col_ids = j * tile + jnp.arange(tile, dtype=jnp.int32)
        cmask = col_ids < m

        def chunk(c, acc):
            kmask = c * bk + jnp.arange(bk) < d
            a = plt.load(a_ref.at[pl.ds(i * tile, tile), pl.ds(c * bk, bk)],
                         mask=rmask[:, None] & kmask[None, :], other=0)
            b = plt.load(b_ref.at[pl.ds(j * tile, tile), pl.ds(c * bk, bk)],
                         mask=cmask[:, None] & kmask[None, :], other=0)
            return acc + pl.dot(a, b, trans_b=True,
                                precision=HIGHEST if f32 else None)

        sims = jax.lax.fori_loop(0, pl.cdiv(d, bk), chunk,
                                 jnp.zeros((tile, tile), jnp.float32))
        mask = (sims >= tau) & cmask[None, :]
        if intra:
            # Global ordering constraint: only earlier GLOBAL rows count as
            # keepers. Offsets place this shard's rows/cols in the full
            # matrix (sharded ring dedup passes non-zero offsets).
            mask &= ((col_ids + offs_ref[1])[None, :]
                     < (row_ids + offs_ref[0])[:, None])
        cand = jnp.where(mask, col_ids[None, :], BIG)
        return jnp.minimum(run_min, jnp.min(cand, axis=1))

    run_min = jax.lax.fori_loop(0, pl.cdiv(m, tile), col_tile,
                                jnp.full((tile,), BIG, jnp.int32))
    out_ref[...] = jnp.where(run_min >= BIG, -1, run_min)


def _first_match_pallas(
    a: jnp.ndarray,        # [N, D] rows to test
    b: jnp.ndarray,        # [M, D] candidate keepers
    tau,
    intra: bool,
    row_offset=0,
    col_offset=0,
    tile: int = 128,
    bk: int = 64,
    interpret: bool = False,
) -> jnp.ndarray:
    n, d = a.shape
    m = b.shape[0]
    b = b.astype(a.dtype)
    tile = pl.next_power_of_2(tile)
    bk = min(bk, max(16, pl.next_power_of_2(d)))
    offs = jnp.stack([jnp.asarray(row_offset, jnp.int32),
                      jnp.asarray(col_offset, jnp.int32)])
    nt = pl.cdiv(n, tile)
    out = pl.pallas_call(
        functools.partial(_kernel, n=n, m=m, d=d, tile=tile, bk=bk,
                          intra=intra),
        grid=(nt,),
        in_specs=[pl.no_block_spec] * 4,
        out_specs=pl.BlockSpec((tile,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((nt * tile,), jnp.int32),
        compiler_params=plt.CompilerParams(num_warps=8, num_stages=3),
        interpret=interpret,
        name="first_match",
    )(jnp.asarray(tau, jnp.float32).reshape(1), offs, a, b)
    return out[:n]


def _first_match_xla(a, b, tau, intra, row_offset=0, col_offset=0):
    """Untiled oracle: builds the whole [N, M] f32 score matrix."""
    sims = exact_dot_t(a, b)
    n, m = sims.shape
    mask = sims >= tau
    if intra:
        col = jax.lax.broadcasted_iota(jnp.int32, (n, m), 1) + jnp.asarray(col_offset, jnp.int32)
        row = jax.lax.broadcasted_iota(jnp.int32, (n, m), 0) + jnp.asarray(row_offset, jnp.int32)
        mask &= col < row
    col_ids = jax.lax.broadcasted_iota(jnp.int32, (n, m), 1)
    cand = jnp.where(mask, col_ids, BIG)
    first = jnp.min(cand, axis=1)
    return jnp.where(first >= BIG, -1, first)


def _first_match_blocked_xla(a, b, tau, intra, row_offset=0, col_offset=0,
                             block: int = 8192):
    """`_first_match_xla` over column blocks of b under `lax.map`, with the
    same min-reduction: the working set is [N, block], so corpus-size
    dedup fits on one card."""
    m, d = b.shape
    block = min(block, m)
    nb = -(-m // block)
    bp = jnp.zeros((nb * block, d), b.dtype).at[:m].set(b)

    def one(jb):
        start = jb * block
        blk = jax.lax.dynamic_slice_in_dim(bp, start, block)
        first = _first_match_xla(a, blk, tau, intra, row_offset,
                                 jnp.asarray(col_offset, jnp.int32) + start)
        ok = (first >= 0) & (first + start < m)
        return jnp.where(ok, first + start, BIG)

    first = jnp.min(jax.lax.map(one, jnp.arange(nb, dtype=jnp.int32)),
                    axis=0)
    return jnp.where(first >= BIG, -1, first)


@functools.partial(jax.jit, static_argnames=("intra", "impl", "tile"))
def first_match(
    a: jnp.ndarray,
    b: jnp.ndarray,
    tau: float,
    intra: bool = False,
    row_offset=0,
    col_offset=0,
    impl: str = "auto",
    tile: int = 128,
) -> jnp.ndarray:
    """For each row of `a`, LOCAL index of the first row of `b` with
    cosine >= tau (or -1). With `intra=True`, only columns whose GLOBAL id
    (local + col_offset) precedes the row's global id (local + row_offset)
    count — keep-first dedup semantics; pass offsets of 0 when a and b are
    the same un-sharded matrix.

    Both inputs must be L2-normalized. `impl` follows ops/dispatch.py;
    "xla" is the column-blocked XLA form.
    """
    impl = resolve_impl("first_match", impl)
    if impl == "xla":
        return _first_match_blocked_xla(a, b, tau, intra, row_offset,
                                        col_offset)
    return _first_match_pallas(a, b, tau, intra, row_offset, col_offset,
                               tile=tile,
                               interpret=impl == "pallas_interpret")


def dedup_groups(first: jnp.ndarray) -> Tuple[list, dict]:
    """Resolve first-match chains on host: returns (keeper row list,
    {dup_row: keeper_row}). A row whose first-match is -1 is a keeper;
    otherwise it is a duplicate of its (transitively resolved) keeper."""
    import numpy as np

    f = np.asarray(first)
    keeper_of = {}
    keepers = []
    for i in range(len(f)):
        j = int(f[i])
        if j < 0:
            keepers.append(i)
        else:
            keeper_of[i] = keeper_of.get(j, j)
    return keepers, keeper_of
