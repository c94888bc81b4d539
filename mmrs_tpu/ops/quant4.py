"""Int4 packed gallery for the top-k scan — 4x rows per card vs bf16.

Extends the int8 capacity ladder (ops/quant.py) one more step: symmetric
per-row int4 quantization (codes in [-7, 7]) with two embedding dims per
byte, shipped as int32 WORDS so the nibble masks run at i32 width.

Layout: the packed gallery is stored TRANSPOSED, `[D/8, N]` int32. Dim d
of the lo half packs into word row d//4 byte d%4; the hi nibble of that
byte is dim D/2 + d. Unpacking is two masks and a byte bitcast:

    byte      = ((g_hi & 0xF) << 4) | ((g_lo + 8) & 0xF)
    b & 0x0F  == g_lo + 8                 } two int8 dots against the
    b & 0xF0  == 16 * g_hi                } int8-quantized query halves
    q . g     == (dot_lo - 8*rowsum(q_lo)) + dot_hi/16   (exact in int32)

The offset-8 correction is a per-QUERY scalar (one rowsum per query,
broadcast over all N). Per-row scales keep full quality semantics — no
group machinery needed at D=512/768.

The scan is plain XLA on every backend; a fused unpack kernel for the GPU
is an open item (ROADMAP.md). Like int8, the win is CAPACITY: 1M x 512 is
0.25 GB here vs 0.5 int8 / 1.0 bf16. Opt-in via
SearchEngine(quantize="int4"); bf16 remains the rank-parity default
(BASELINE.md). Reference equivalent: none — the reference
(code/search_image.py:105-117) holds a torch f32 gallery.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from mmrs_tpu.ops.quant import quantize_rows

MASK_LO = 0x0F0F0F0F
MASK_HI = -252645136          # 0xF0F0F0F0 as int32


@jax.jit
def quantize_rows_int4(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """[N, D] float -> ([D//8, N] int32 packed words, [N] f32 scales).

    D must be a multiple of 8 (serving dims 512/768 are). Codes are
    symmetric int4 in [-7, 7]; the lo half of each row (dims [0, D/2))
    is stored offset-8 in the low nibble, the hi half signed in the
    high nibble, 4 byte-rows per int32 word (little-endian).
    """
    n, d = x.shape
    if d % 8:
        raise ValueError(f"D={d} must be a multiple of 8 for int4 packing")
    x32 = x.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(x32), axis=-1)
    scale = jnp.maximum(absmax, 1e-12) / 7.0
    q = jnp.clip(jnp.round(x32 / scale[:, None]), -7, 7).astype(jnp.int32)
    h = d // 2
    lo = (q[:, :h] + 8) & 0xF                     # [N, D/2] in 1..15
    hi = q[:, h:] & 0xF                           # [N, D/2] signed nibble
    byte = lo | (hi << 4)                         # [N, D/2] in 0..255
    w = byte.reshape(n, d // 8, 4)
    words = (w[:, :, 0] | (w[:, :, 1] << 8) | (w[:, :, 2] << 16)
             | (w[:, :, 3] << 24)).astype(jnp.int32)
    return words.T, scale                         # [D/8, N], [N]


def _unpack_planes_xla(packed: jnp.ndarray):
    """[D/8, N] words -> (lo_masked [D/2, N], hi_masked [D/2, N]) int8,
    the two dot operands (lo_masked = g_lo + 8, hi_masked = 16 * g_hi).
    XLA's bitcast_convert_type appends a trailing little-endian byte
    dim."""
    def planes(words):
        b = jax.lax.bitcast_convert_type(words, jnp.int8)   # [D/8, N, 4]
        return b.transpose(0, 2, 1).reshape(-1, words.shape[1])
    return (planes(packed & MASK_LO), planes(packed & MASK_HI))


def _score_f32(dlo, dhi, rs_q, q_scale, scales_tile):
    """Shared f32 epilogue — ONE expression used by the flat scan, the
    IVF probe and the spill scan, so their scores agree bit for bit."""
    s = (dlo.astype(jnp.float32) - 8.0 * rs_q) + dhi.astype(jnp.float32) / 16.0
    return s * q_scale * scales_tile


def _topk_int4_xla(q_q, q_scale, rs_q, packed, scales, k):
    lo, hi = _unpack_planes_xla(packed)
    h = lo.shape[0]
    dlo = jax.lax.dot_general(q_q[:, :h], lo, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    dhi = jax.lax.dot_general(q_q[:, h:], hi, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    scores = _score_f32(dlo, dhi, rs_q[:, None], q_scale[:, None],
                        scales[None, :])
    vals, idxs = jax.lax.top_k(scores, k)
    return vals, idxs.astype(jnp.int32)


def _prep_queries(queries: jnp.ndarray):
    """Per-row int8 query quantization + the lo-half rowsum the offset
    correction needs. Queries must already be L2-normalized."""
    q_q, q_scale = quantize_rows(queries.astype(jnp.float32))
    h = q_q.shape[1] // 2
    rs_q = jnp.sum(q_q[:, :h].astype(jnp.int32), axis=1).astype(jnp.float32)
    return q_q, q_scale, rs_q


@functools.partial(jax.jit, static_argnames=("k",))
def cosine_topk_int4(
    queries: jnp.ndarray,     # [Q, D] float (L2-normalized)
    packed: jnp.ndarray,      # [D//8, N] int32 (quantize_rows_int4)
    scales: jnp.ndarray,      # [N] f32
    k: int = 10,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k over an int4 packed gallery (the XLA form on every
    backend)."""
    q_q, q_scale, rs_q = _prep_queries(queries)
    return _topk_int4_xla(q_q, q_scale, rs_q, packed, scales, k)


@jax.jit
def similarities_int4(queries: jnp.ndarray, packed: jnp.ndarray,
                      scales: jnp.ndarray) -> jnp.ndarray:
    """UNscaled [Q, N] cosine approximations against the packed gallery
    (engine.device_similarities for quantize="int4"; calibration is an
    offline step so the [D/2, N] unpacked planes XLA materializes here
    are acceptable)."""
    q_q, q_scale, rs_q = _prep_queries(queries)
    lo, hi = _unpack_planes_xla(packed)
    h = lo.shape[0]
    dlo = jax.lax.dot_general(q_q[:, :h], lo, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    dhi = jax.lax.dot_general(q_q[:, h:], hi, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    return _score_f32(dlo, dhi, rs_q[:, None], q_scale[:, None],
                      scales[None, :])
