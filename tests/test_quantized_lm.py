"""int8 serving weights for the LLaMA decoder / LLaVA verifier.

The reference serves its verifier in 8-bit (load_8bit=True,
code/test_llava.py:13); here int8 weights run int8 matmuls with per-channel weight
scales + dynamic activation quant (models/quantize.py). These tests pin
the numerics contract at tiny scale: logits stay close to the f32 decoder
and a decisively-peaked next-token distribution keeps its argmax.
"""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from mmrs_tpu.models import llama, llava
from mmrs_tpu.models.configs import VITConfig
from mmrs_tpu.models.layers import QTensor
from mmrs_tpu.models.llama import LlamaConfig
from mmrs_tpu.models.quantize import quantize_llama, quantize_llava

LCFG = LlamaConfig(vocab_size=128, dim=64, layers=2, heads=4, kv_heads=2,
                   mlp_dim=128, max_seq=64)


@pytest.mark.slow
def test_llama_int8_logits_close():
    params = llama.init(jax.random.key(0), LCFG)
    qparams = quantize_llama(params)
    assert isinstance(qparams["blocks"]["w_gate"], QTensor)
    assert isinstance(qparams["lm_head"], QTensor)
    assert not isinstance(qparams["embed"], QTensor)

    emb = llama.embed_tokens(params, jnp.arange(10)[None, :] % 128)
    cache = llama.init_cache(LCFG, 1, jnp.float32)
    ref, _ = llama.forward(params, emb, cache, 0, LCFG, jnp.float32)
    out, _ = llama.forward(qparams, emb, cache, 0, LCFG, jnp.float32)
    ref = np.asarray(ref)
    out = np.asarray(out)
    denom = np.linalg.norm(ref, axis=-1, keepdims=True)
    rel = np.linalg.norm(out - ref, axis=-1, keepdims=True) / denom
    assert rel.max() < 0.05, rel.max()


def test_llama_int8_greedy_keeps_decisive_argmax():
    """Plant a strongly-peaked lm_head row direction: the int8 decoder must
    pick the same next token as f32 when the margin is real (the verifier's
    yes/no regime), even if near-tie tokens could flip."""
    params = llama.init(jax.random.key(1), LCFG)
    # shrink all output embeddings, then give tokens 7 and 9 opposite large
    # ones: argmax(h @ lm_head) is decisively 7 or 9 (sign of h.g), with a
    # margin far above int8 quantization noise — the verifier's yes/no regime
    lm_head = np.asarray(params["lm_head"]).copy() * 0.01
    g = np.asarray(jax.random.normal(jax.random.key(9), (LCFG.dim,))) * 0.5
    lm_head[:, 7] = g
    lm_head[:, 9] = -g
    params = dict(params, lm_head=jnp.asarray(lm_head))
    qparams = quantize_llama(params)

    emb = llama.embed_tokens(params, jnp.arange(6)[None, :])
    toks_f32 = np.asarray(llama.greedy_generate(
        params, emb, LCFG, max_new_tokens=4, compute_dtype=jnp.float32))
    toks_int8 = np.asarray(llama.greedy_generate(
        qparams, emb, LCFG, max_new_tokens=4, compute_dtype=jnp.float32))
    assert toks_f32.shape == toks_int8.shape == (1, 4)
    np.testing.assert_array_equal(toks_f32, toks_int8)


@pytest.mark.slow
def test_llava_int8_generate_runs():
    vcfg = VITConfig(image_size=32, patch_size=16, width=64, layers=3,
                     heads=4, embed_dim=32)
    cfg = llava.LLaVAConfig(vision=vcfg, lm=LCFG)
    params = llava.init(jax.random.key(2), cfg)
    qparams = quantize_llava(params)
    assert isinstance(qparams["visual"]["blocks"]["attn"]["wq"], QTensor)
    assert isinstance(qparams["lm"]["blocks"]["w_down"], QTensor)
    assert not isinstance(qparams["proj_w1"], QTensor)

    imgs = jax.random.normal(jax.random.key(3), (2, 32, 32, 3)) * 0.5
    pre = jnp.ones((2, 3), jnp.int32)
    post = jnp.ones((2, 2), jnp.int32)
    toks = llava.generate(qparams, imgs, pre, post, cfg, max_new_tokens=3)
    assert np.asarray(toks).shape == (2, 3)


def test_quantized_checkpoint_roundtrip(tmp_path):
    """QTensor trees survive npz save/load (int8 verifier loads directly)."""
    from mmrs_tpu.models import checkpoint

    params = quantize_llama(llama.init(jax.random.key(4), LCFG))
    path = str(tmp_path / "llama_int8.npz")
    checkpoint.save_npz(params, path)
    loaded = checkpoint.load_npz(path)
    assert isinstance(loaded["blocks"]["wq"], QTensor)
    assert loaded["blocks"]["wq"].q.dtype == jnp.int8

    emb = llama.embed_tokens(params, jnp.arange(5)[None, :])
    cache = llama.init_cache(LCFG, 1, jnp.float32)
    a, _ = llama.forward(params, emb, cache, 0, LCFG, jnp.float32)
    b, _ = llama.forward(loaded, emb, cache, 0, LCFG, jnp.float32)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow
def test_checkpoint_loads_into_tp_placement(tmp_path):
    """load_npz(placement=llava_checkpoint_placement(mesh)) streams a
    (quantized) llava checkpoint straight into the Megatron layout: int8
    weights and their scales land sharded, tower replicated, and the TP
    generate matches the single-device decode of the same checkpoint."""
    from jax.sharding import Mesh

    from mmrs_tpu.models import checkpoint
    from mmrs_tpu.models.quantize import quantize_llava
    from mmrs_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from mmrs_tpu.parallel.vlm import (
        llava_checkpoint_placement, make_tp_llava_generate,
    )

    lcfg = LlamaConfig(vocab_size=96, dim=64, layers=2, heads=4, kv_heads=4,
                       mlp_dim=128, max_seq=64)
    vcfg = VITConfig(image_size=32, patch_size=8, width=48, layers=2,
                     heads=4, embed_dim=32)
    cfg = llava.LLaVAConfig(vision=vcfg, lm=lcfg)
    params = quantize_llava(llava.init(jax.random.key(6), cfg))
    path = str(tmp_path / "llava_int8.npz")
    checkpoint.save_npz(params, path)

    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4),
                (DATA_AXIS, MODEL_AXIS))
    loaded = checkpoint.load_npz(path,
                                 placement=llava_checkpoint_placement(mesh))
    wq = loaded["lm"]["blocks"]["wq"]
    assert isinstance(wq, QTensor)
    assert not wq.q.sharding.is_fully_replicated          # out-ch split
    assert not wq.s.sharding.is_fully_replicated          # scales follow
    assert loaded["lm"]["blocks"]["attn_norm"].sharding.is_fully_replicated
    assert loaded["proj_w1"].sharding.is_fully_replicated

    imgs = jax.random.normal(jax.random.key(7), (2, 32, 32, 3),
                             jnp.float32) * 0.5
    pre = jnp.ones((2, 3), jnp.int32)
    post = jnp.ones((2, 2), jnp.int32)
    ref = np.asarray(llava.generate(
        checkpoint.load_npz(path), imgs, pre, post, cfg, max_new_tokens=3,
        eos_token=-1, compute_dtype=jnp.float32))
    gen = make_tp_llava_generate(cfg, mesh, max_new_tokens=3, eos_token=-1,
                                 compute_dtype=jnp.float32)
    out = np.asarray(gen(loaded, imgs, pre, post))
    np.testing.assert_array_equal(out, ref)
