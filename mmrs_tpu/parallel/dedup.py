"""Distributed all-pairs dedup via ring-permuted column blocks.

The O(N^2) dedup similarity matrix is covered without ever holding more
than one [N/S, D] column block per chip: each device owns a row block of
the (row-sharded) embedding matrix and circulates its block around the ring
with `jax.lax.ppermute` (S steps). At each step every device runs the
fused `first_match` kernel of its row block against the visiting column
block and folds the result into a running per-row minimum global column
index. This is the scale-out replacement for the reference's O(N^2)
Python hash-comparison loops (tool/find_repeated_in_same_folder.py:83-87,
tool/delete repeated.py:127-135) at gallery scale.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from mmrs_tpu.ops.allpairs import first_match
from mmrs_tpu.parallel.mesh import DATA_AXIS

BIG = 2**30


def sharded_first_match(
    x: jnp.ndarray,           # [N, D] row-sharded; L2-normalized
    tau: float,
    mesh: Mesh,
    axis: str = DATA_AXIS,
    intra: bool = True,
    impl: str = "auto",
) -> jnp.ndarray:
    """For each row, the first (lowest-index) other row with cosine >= tau,
    or -1; with intra=True only earlier rows count (keep-first dedup).
    Output is row-sharded like the input.

    Ragged N is zero-padded to the next shard multiple; padding columns sit
    after every real column, are excluded by the `< n` mask, and padding
    rows are sliced off the output."""
    from mmrs_tpu.parallel.topk import _pad_rows, padded_rows

    n = x.shape[0]
    s = mesh.shape[axis]
    n_pad = padded_rows(n, s)
    x = _pad_rows(x, n_pad)
    rows_per = n_pad // s

    def local(x_shard):
        my = jax.lax.axis_index(axis)
        row_base = my * rows_per
        row_ids = row_base + jnp.arange(rows_per, dtype=jnp.int32)

        def step(carry, step_idx):
            block, run = carry
            # The visiting block originated at shard (my + step_idx) % s.
            src = (my + step_idx) % s
            col_base = src * rows_per

            # Local first-match of my rows vs the visiting block; the global
            # keep-first constraint is enforced INSIDE the kernel via offsets
            # (filtering afterwards would drop valid later in-block columns).
            fm = first_match(
                x_shard, block, tau, intra=intra,
                row_offset=row_base, col_offset=col_base, impl=impl,
            )
            # Padding columns (global id >= n) live at the very end of the
            # last block, so masking the match away cannot hide an earlier
            # real match in the same block.
            global_col = jnp.where((fm >= 0) & (fm + col_base < n),
                                   fm + col_base, BIG)
            run = jnp.minimum(run, global_col)

            # Pass the block to the left neighbor (ring).
            block = jax.lax.ppermute(
                block, axis, [(i, (i - 1) % s) for i in range(s)]
            )
            return (block, run), None

        init = (x_shard, jnp.full((rows_per,), BIG, jnp.int32))
        (_, run), _ = jax.lax.scan(step, init, jnp.arange(s))
        return jnp.where(run >= BIG, -1, run)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None),),
        out_specs=P(axis),
        check_vma=False,
    )
    return fn(x)[:n]
