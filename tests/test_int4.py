"""int4 grouped-quant weights (QTensor4): pack/unpack exactness, matmul
dispatch, and the full llama decode path running on int4 weights.

Decode is weight-bandwidth-bound: int4 halves the stream
that sets the floor. These tests pin the MECHANICS (pack/unpack is
lossless for representable values; the model runs and tracks its own
dequantized-oracle exactly); int4 QUALITY needs real weights, same as
the int8 rank gates.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mmrs_tpu.models.layers import (QTensor4, matmul, quantize_weight_int4,
                                    unpack_int4)


def test_pack_unpack_exact_roundtrip():
    """Every representable int4 value survives pack -> unpack exactly."""
    rng = np.random.default_rng(0)
    k, n, g = 256, 128, 128
    w = rng.integers(-7, 8, (k, n)).astype(np.float32)
    qt = quantize_weight_int4(jnp.asarray(w) * (1.0 / 7.0), group=g)
    # scales become amax/7 per group; unpack must reproduce w/7 exactly
    got = np.asarray(unpack_int4(qt, jnp.float32))
    np.testing.assert_allclose(got, w / 7.0, rtol=1e-6, atol=1e-7)
    assert qt.packed.shape == (k // 2, n) and qt.packed.dtype == jnp.int8
    assert qt.s.shape == (k // g, n)


def test_group_scales_follow_magnitude():
    """A group with 10x larger weights gets a 10x scale, not clipping."""
    k, n, g = 256, 128, 128
    w = np.ones((k, n), np.float32) * 0.01
    w[:g] *= 10.0
    qt = quantize_weight_int4(jnp.asarray(w), group=g)
    got = np.asarray(unpack_int4(qt, jnp.float32))
    np.testing.assert_allclose(got, w, rtol=0.08)
    s = np.asarray(qt.s)
    assert np.allclose(s[0], 10 * s[1])


def test_matmul_dispatch_matches_dequant_oracle():
    rng = np.random.default_rng(1)
    k, n = 512, 384
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    x = jnp.asarray(rng.standard_normal((8, k)).astype(np.float32))
    qt = quantize_weight_int4(jnp.asarray(w), group=128)
    got = matmul(x, qt, jnp.float32)
    want = jnp.dot(x, unpack_int4(qt, jnp.float32),
                   preferred_element_type=jnp.float32)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_quantize_rejects_bad_group():
    with pytest.raises(ValueError, match="multiple"):
        quantize_weight_int4(jnp.ones((96, 64)), group=64)


@pytest.mark.slow
def test_llama_decode_runs_on_int4_and_matches_dequant_model():
    """greedy_generate on int4 weights == the same model with explicitly
    dequantized bf16 weights (the dispatch is the ONLY difference)."""
    from mmrs_tpu.models import llama
    from mmrs_tpu.models.llama import LlamaConfig
    from mmrs_tpu.models.quantize import quantize_llama_int4

    cfg = LlamaConfig(dim=256, heads=4, kv_heads=4, mlp_dim=512, layers=2,
                      vocab_size=128, max_seq=64)
    params = llama.init(jax.random.key(0), cfg)
    p4 = quantize_llama_int4(params, group=128)

    # oracle: same tree with QTensor4 leaves explicitly dequantized
    def deq(node):
        if isinstance(node, dict):
            return {k: deq(v) for k, v in node.items()}
        if isinstance(node, QTensor4):
            return unpack_int4(node, jnp.bfloat16)
        return node

    p_ref = deq(p4)
    tokens = jax.random.randint(jax.random.key(1), (2, 9), 3, 100,
                                jnp.int32)
    emb4 = llama.embed_tokens(p4, tokens)
    emb_ref = llama.embed_tokens(p_ref, tokens)
    out4 = llama.greedy_generate(p4, emb4, cfg, max_new_tokens=6,
                                 eos_token=-1)
    out_ref = llama.greedy_generate(p_ref, emb_ref, cfg, max_new_tokens=6,
                                    eos_token=-1)
    np.testing.assert_array_equal(np.asarray(out4), np.asarray(out_ref))


def test_int4_halves_int8_bytes():
    from mmrs_tpu.models import llama
    from mmrs_tpu.models.llama import LlamaConfig
    from mmrs_tpu.models.quantize import quantize_llama, quantize_llama_int4

    cfg = LlamaConfig(dim=256, heads=4, kv_heads=4, mlp_dim=512, layers=2,
                      vocab_size=128, max_seq=64)
    params = llama.init(jax.random.key(0), cfg)

    def nbytes(tree, dtypes):
        return sum(x.size * x.dtype.itemsize
                   for x in jax.tree.leaves(tree)
                   if x.dtype in dtypes)

    b8 = nbytes(quantize_llama(params), (jnp.dtype(jnp.int8),))
    b4 = nbytes(quantize_llama_int4(params), (jnp.dtype(jnp.int8),))
    assert b4 * 2 == b8