"""Shared transformer building blocks (functional, tensor-core friendly).

Design rules:
  - matmuls run in the compute dtype (bf16 by default) with f32 accumulation
    via `preferred_element_type`;
  - LayerNorm and softmax run in f32 regardless of compute dtype;
  - per-layer parameters are STACKED along a leading layer axis so the whole
    transformer body is one `lax.scan` — a single compiled layer, minimal
    compile time, and XLA can pipeline weight prefetch.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

Params = Dict[str, Any]


class QTensor(NamedTuple):
    """int8 weight + per-output-channel f32 scale (w ~= q * s).

    Tensor cores run int8 x int8 -> int32 at twice the bf16 rate, so the
    serving towers can trade one elementwise dynamic-quantization pass per
    matmul for half the matmul time. A NamedTuple
    is already a pytree, so stacked per-layer QTensors scan like plain
    arrays and ship through jit argument trees unchanged.
    """

    q: jnp.ndarray                 # int8 [..., K, N]
    s: jnp.ndarray                 # f32  [..., N]


def quantize_weight(w: jnp.ndarray) -> QTensor:
    """Per-output-channel symmetric int8 quantization of a [..., K, N] kernel."""
    w32 = jnp.asarray(w, jnp.float32)
    amax = jnp.max(jnp.abs(w32), axis=-2, keepdims=True)      # [..., 1, N]
    s = jnp.maximum(amax, 1e-12) / 127.0
    q = jnp.round(w32 / s).astype(jnp.int8)
    return QTensor(q, jnp.squeeze(s, -2))


class QTensor4(NamedTuple):
    """int4 weight (two nibbles per int8 byte) + per-(K-group, out-channel)
    scales (w ~= unpack(packed) * s[group]).

    Decode is weight-bandwidth-bound (the 7B int8 weights are streamed once
    per step), so int4 halves the bytes that set the decode floor.
    Group-wise scales along the contraction dim (AWQ/GPTQ convention,
    default 128) keep the quantization usable where one per-channel scale
    cannot. Rows 2i/2i+1 of the logical [K, N] kernel pack into byte row i
    (low/high nibble); the dot runs bf16 after an unpack fused into the
    operand read — the matmul rate is not the bottleneck, the weight
    stream is."""

    packed: jnp.ndarray            # int8 [..., K//2, N]
    s: jnp.ndarray                 # f32/bf16 [..., K//G, N]


def quantize_weight_int4(w: jnp.ndarray, group: int = 128) -> QTensor4:
    """Symmetric int4 (-7..7) group quantization of a [..., K, N] kernel."""
    w32 = jnp.asarray(w, jnp.float32)
    k = w32.shape[-2]
    if k % (2 * group) and k != group:
        raise ValueError(f"K={k} must be a multiple of 2*group={2*group}")
    g = w32.reshape(*w32.shape[:-2], k // group, group, w32.shape[-1])
    amax = jnp.max(jnp.abs(g), axis=-2, keepdims=True)    # [..., K/G, 1, N]
    s = jnp.maximum(amax, 1e-12) / 7.0
    q = jnp.clip(jnp.round(g / s), -7, 7).astype(jnp.int8)
    q = q.reshape(*w32.shape[:-2], k, w32.shape[-1])
    lo = q[..., 0::2, :] & 0xF
    hi = q[..., 1::2, :] & 0xF
    packed = jnp.left_shift(hi, 4) | lo
    return QTensor4(packed.astype(jnp.int8), jnp.squeeze(s, -2))


def unpack_int4(kernel: QTensor4, dtype=jnp.bfloat16) -> jnp.ndarray:
    """Dequantized [..., K, N] kernel. Under jit XLA fuses this into the
    consuming dot's operand read where it can; the packed form is what
    crosses HBM."""
    b = kernel.packed
    lo = jnp.right_shift(jnp.left_shift(b, 4), 4)         # sign-extended
    hi = jnp.right_shift(b, 4)                            # arithmetic
    kh = b.shape[-2]
    n = b.shape[-1]
    w = jnp.stack([lo, hi], axis=-2)                      # [..., K/2, 2, N]
    w = w.reshape(*b.shape[:-2], kh * 2, n)
    groups = kernel.s.shape[-2]
    w = w.reshape(*b.shape[:-2], groups, (kh * 2) // groups, n)
    w = w.astype(dtype) * kernel.s[..., :, None, :].astype(dtype)
    return w.reshape(*b.shape[:-2], kh * 2, n)


def _quantize_act(x: jnp.ndarray):
    """Dynamic per-row symmetric int8 quantization of activations.

    XLA fuses the f32 upcast feeding both the reduce and the round."""
    x32 = x.astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True),
                     1e-12) / 127.0
    return jnp.round(x32 / sx).astype(jnp.int8), sx


def _int8_matmul(xq: jnp.ndarray, sx: jnp.ndarray, kernel: QTensor, bias,
                 compute_dtype: jnp.dtype) -> jnp.ndarray:
    acc = jax.lax.dot_general(
        xq, kernel.q,
        (((xq.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    y = acc.astype(jnp.float32) * sx * kernel.s.astype(jnp.float32)
    if bias is not None:
        y = y + bias.astype(jnp.float32)
    return y.astype(compute_dtype)


def _dense_int8(x: jnp.ndarray, kernel: QTensor, bias,
                compute_dtype: jnp.dtype) -> jnp.ndarray:
    """Dynamic per-row activation quant -> int8 matmul -> rescale."""
    xq, sx = _quantize_act(x)
    return _int8_matmul(xq, sx, kernel, bias, compute_dtype)


def matmul(x: jnp.ndarray, kernel, compute_dtype: jnp.dtype,
           out_dtype=None) -> jnp.ndarray:
    """Bias-free matmul dispatching on QTensor vs plain kernels.

    Accumulates in f32 (int32 for int8 kernels) and returns `out_dtype`
    (default: compute_dtype). The LLaMA/LLaVA stack routes its projections
    through this so int8 serving weights (models/quantize.py) drop in —
    decode is weight-bandwidth-bound, so halving the bytes ~doubles
    tokens/s at small batch.
    """
    out_dtype = out_dtype or compute_dtype
    if isinstance(kernel, QTensor):
        xq, sx = _quantize_act(x)
        acc = jax.lax.dot_general(
            xq, kernel.q, (((x.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        return (acc.astype(jnp.float32) * sx
                * kernel.s.astype(jnp.float32)).astype(out_dtype)
    if isinstance(kernel, QTensor4):
        w = unpack_int4(kernel, compute_dtype)
        return jax.lax.dot_general(
            x.astype(compute_dtype), w, (((x.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        ).astype(out_dtype)
    return jnp.dot(
        x.astype(compute_dtype), kernel.astype(compute_dtype),
        preferred_element_type=jnp.float32,
    ).astype(out_dtype)


def layer_norm(x: jnp.ndarray, scale: jnp.ndarray, bias: jnp.ndarray,
               eps: float = 1e-5) -> jnp.ndarray:
    dtype = x.dtype
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x32 - mean), axis=-1, keepdims=True)
    y = (x32 - mean) * jax.lax.rsqrt(var + eps)
    return (y * scale.astype(jnp.float32) + bias.astype(jnp.float32)).astype(dtype)


def dense(x: jnp.ndarray, kernel: jnp.ndarray, bias: jnp.ndarray | None,
          compute_dtype: jnp.dtype) -> jnp.ndarray:
    if isinstance(kernel, QTensor):
        return _dense_int8(x, kernel, bias, compute_dtype)
    y = jnp.dot(
        x.astype(compute_dtype),
        kernel.astype(compute_dtype),
        preferred_element_type=jnp.float32,
    )
    if bias is not None:
        y = y + bias.astype(jnp.float32)
    return y.astype(compute_dtype)


def quick_gelu(x: jnp.ndarray) -> jnp.ndarray:
    """OpenAI CLIP activation: x * sigmoid(1.702 x)."""
    return x * jax.nn.sigmoid(1.702 * x.astype(jnp.float32)).astype(x.dtype)


def gelu(x: jnp.ndarray) -> jnp.ndarray:
    return jax.nn.gelu(x.astype(jnp.float32), approximate=False).astype(x.dtype)


def _mask_hb(mask: jnp.ndarray) -> jnp.ndarray:
    """Additive mask in the caller contract ([B, H, Q, K]-broadcastable)
    re-axised for the head-outermost [H, B, Q, K] logits: 4-D masks swap
    their two leading axes (bert's [B,1,1,T] -> [1,B,1,T], the causal
    [1,1,T,T] is unchanged); <=2-D masks broadcast the same either way."""
    m = mask.astype(jnp.float32)
    return m.transpose(1, 0, 2, 3) if m.ndim == 4 else m


def attention(
    x: jnp.ndarray,             # [B, T, W]
    p: Params,                  # {wq, wk, wv, wo: [W, W]; bq, bk, bv, bo: [W]}
    heads: int,
    mask: jnp.ndarray | None,   # additive f32 mask broadcastable to [B, H, Q, K]
    compute_dtype: jnp.dtype,
) -> jnp.ndarray:
    b, t, w = x.shape
    hd = w // heads
    cd = compute_dtype
    # 1/sqrt(d) folded into q BEFORE the score matmul (one [H,B,T,hd]
    # multiply instead of a [B,H,T,T] f32 multiply).
    scale = jnp.asarray(1.0 / np.sqrt(hd), cd)

    # HEAD-OUTERMOST projections: einsum btw,whd->hbtd asks the matmul for
    # the [H,B,T,hd] output whose two MAJOR dims are the score einsum's
    # batch dims — the layout a standard batched matmul wants — so layout
    # assignment keeps the operand copies cheap.
    int8 = isinstance(p["wq"], QTensor)

    if int8:
        # quantize the (shared) layer input once for all three projections
        xq, sx = _quantize_act(x)
        sxh = sx.reshape(1, b, t, 1)

        def proj(kernel: QTensor, bias):
            acc = jnp.einsum(
                "btw,whd->hbtd", xq, kernel.q.reshape(w, heads, hd),
                preferred_element_type=jnp.int32)
            y = (acc.astype(jnp.float32) * sxh
                 * kernel.s.astype(jnp.float32)
                 .reshape(heads, 1, 1, hd))
            return y + bias.astype(jnp.float32).reshape(heads, 1, 1, hd)
    else:
        xc = x.astype(cd)

        def proj(kernel, bias):
            y = jnp.einsum("btw,whd->hbtd", xc,
                           kernel.astype(cd).reshape(w, heads, hd),
                           preferred_element_type=jnp.float32)
            return y + bias.astype(jnp.float32).reshape(heads, 1, 1, hd)

    q = proj(p["wq"], p["bq"]).astype(cd) * scale        # [H, B, T, hd]
    k = proj(p["wk"], p["bk"]).astype(cd)
    v = proj(p["wv"], p["bv"]).astype(cd)

    logits = jnp.einsum("hbtd,hbsd->hbts", q, k,
                        preferred_element_type=jnp.float32)
    if mask is not None:
        logits = logits + _mask_hb(mask)
    # Softmax in the compute dtype: with bf16 serving this removes the
    # [H,B,T,T] f32 materialization. f32 compute keeps f32 softmax, so CPU
    # parity tests see the exact reference math.
    probs = jax.nn.softmax(logits.astype(cd), axis=-1)
    out = jnp.einsum("hbts,hbsd->hbtd", probs, v,
                     preferred_element_type=jnp.float32).astype(cd)
    if int8:
        # per-(b,t)-row dynamic quant needs the W-contiguous layout; one
        # transpose here replaces the three the projections used to pay
        out = out.transpose(1, 2, 0, 3).reshape(b, t, w)
        return dense(out, p["wo"], p["bo"], cd)
    wo = p["wo"].astype(cd).reshape(heads, hd, w)
    y = jnp.einsum("hbtd,hdw->btw", out, wo,
                   preferred_element_type=jnp.float32)
    return (y + p["bo"].astype(jnp.float32)).astype(cd)


def mlp(x: jnp.ndarray, p: Params, act,
        compute_dtype: jnp.dtype) -> jnp.ndarray:
    h = dense(x, p["w1"], p["b1"], compute_dtype)
    h = act(h)
    return dense(h, p["w2"], p["b2"], compute_dtype)


def pre_ln_block(
    x: jnp.ndarray,
    p: Params,
    heads: int,
    mask: jnp.ndarray | None,
    act,
    compute_dtype: jnp.dtype,
) -> jnp.ndarray:
    """CLIP-style pre-LayerNorm residual block."""
    x = x + attention(layer_norm(x, p["ln1_scale"], p["ln1_bias"]), p["attn"],
                      heads, mask, compute_dtype)
    x = x + mlp(layer_norm(x, p["ln2_scale"], p["ln2_bias"]), p["mlp"],
                act, compute_dtype)
    return x


def scan_blocks(
    x: jnp.ndarray,
    stacked: Params,            # every leaf has leading layer axis L
    heads: int,
    mask: jnp.ndarray | None,
    act,
    compute_dtype: jnp.dtype,
    unroll: int = 1,
) -> jnp.ndarray:
    """Run all transformer blocks over stacked per-layer params in one
    lax.scan (a single compiled layer, minimal compile time)."""

    def body(h, layer_params):
        return pre_ln_block(h, layer_params, heads, mask, act,
                            compute_dtype), None

    out, _ = jax.lax.scan(body, x, stacked, unroll=unroll)
    return out


def init_block_params(key, layers: int, width: int, mlp_ratio: int = 4,
                      dtype=jnp.float32) -> Params:
    """Random init of stacked pre-LN block params (for tests / from-scratch)."""
    ks = jax.random.split(key, 8)
    s = 0.02
    hidden = width * mlp_ratio

    def nrm(k, shape):
        return (jax.random.normal(k, (layers, *shape)) * s).astype(dtype)

    def zeros(shape):
        return jnp.zeros((layers, *shape), dtype)

    def ones(shape):
        return jnp.ones((layers, *shape), dtype)

    return {
        "ln1_scale": ones((width,)), "ln1_bias": zeros((width,)),
        "ln2_scale": ones((width,)), "ln2_bias": zeros((width,)),
        "attn": {
            "wq": nrm(ks[0], (width, width)), "bq": zeros((width,)),
            "wk": nrm(ks[1], (width, width)), "bk": zeros((width,)),
            "wv": nrm(ks[2], (width, width)), "bv": zeros((width,)),
            "wo": nrm(ks[3], (width, width)), "bo": zeros((width,)),
        },
        "mlp": {
            "w1": nrm(ks[4], (width, hidden)), "b1": zeros((hidden,)),
            "w2": nrm(ks[5], (hidden, width)), "b2": zeros((width,)),
        },
    }
