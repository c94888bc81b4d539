"""Int8 gallery quantization for the top-k scan.

The 1M x 512 bf16 gallery read is the query path's entire cost (the scan is
bound by device-memory bandwidth). Symmetric per-row int8 quantization halves
the bytes:

    g_q[i] = round(127 * g[i] / max|g[i]|),  scale[i] = max|g[i]| / 127
    score(q, i) ≈ (q_q · g_q[i]) * q_scale * scale[i]

With L2-normalized rows the quantization error is ~0.3% of the score —
enough to perturb ranks only between near-ties; `cosine_topk_quantized`
is OPT-IN while the bf16 kernel remains the rank-parity default
(BASELINE.md's exact-parity target).

The sure win is capacity: the int8 gallery halves device residency (0.5 GB
vs 1 GB for 1M x 512 -> 2x rows per card). Its time on an H100 is in
PERF.md.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from mmrs_tpu.ops.dispatch import resolve_impl
from mmrs_tpu.ops.topk import scan_topk_pallas


@jax.jit
def quantize_rows(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """[N, D] float -> ([N, D] int8, [N] f32 scales)."""
    x32 = x.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(x32), axis=-1)
    scale = jnp.maximum(absmax, 1e-12) / 127.0
    q = jnp.clip(jnp.round(x32 / scale[:, None]), -127, 127).astype(jnp.int8)
    return q, scale


def _topk_quant_xla(q_q, q_scale, gallery_q, scales, k):
    acc = jax.lax.dot_general(
        q_q, gallery_q, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32, precision=jax.lax.Precision.HIGHEST,
    )                                                    # [Q, N] int32
    scores = acc.astype(jnp.float32) * q_scale[:, None] * scales[None, :]
    vals, idxs = jax.lax.top_k(scores, k)
    return vals, idxs.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k", "impl", "tile_n"))
def cosine_topk_quantized(
    queries: jnp.ndarray,     # [Q, D] float (L2-normalized)
    gallery_q: jnp.ndarray,   # [N, D] int8
    scales: jnp.ndarray,      # [N] f32
    k: int = 10,
    impl: str = "auto",
    tile_n: int = 256,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k over an int8 gallery: int8 x int8 matmul with int32
    accumulation, rescaled to approximate cosines. `impl` as in
    ops/topk.cosine_topk; the kernel is ops/topk's scan with the scale
    epilogue."""
    q_q, q_scale = quantize_rows(queries)
    impl = resolve_impl("topk", impl)
    if impl == "xla":
        return _topk_quant_xla(q_q, q_scale, gallery_q, scales, k)
    return scan_topk_pallas(q_q, gallery_q, k, tile_n=tile_n,
                            q_scale=q_scale, scales=scales,
                            interpret=impl == "pallas_interpret")
