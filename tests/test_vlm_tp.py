"""TP-sharded LLaMA decode matches single-device decode on the CPU mesh."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from mmrs_tpu.models import llama
from mmrs_tpu.models.llama import LlamaConfig
from mmrs_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
from mmrs_tpu.parallel.vlm import (
    draft_tp_divisible, make_tp_generate, make_tp_speculative_generate,
    replicate_llama_params, shard_llama_params,
)

LCFG = LlamaConfig(vocab_size=96, dim=64, layers=2, heads=4, kv_heads=2,
                   mlp_dim=128, max_seq=64)


@pytest.mark.slow
def test_tp_generate_matches_single_device():
    # B=2 on the 2x2 mesh: batch rows must divide the data axis (the
    # factories shard the batch dim when the mesh has one wider than 1)
    params = llama.init(jax.random.key(0), LCFG)
    rng = np.random.default_rng(0)
    prompt = jnp.asarray(rng.integers(3, 90, (2, 5)), jnp.int32)
    embeds = llama.embed_tokens(params, prompt)

    ref = np.asarray(llama.greedy_generate(
        params, embeds, LCFG, max_new_tokens=6, eos_token=-1,
        compute_dtype=jnp.float32))

    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devices, (DATA_AXIS, MODEL_AXIS))
    sharded = shard_llama_params(params, mesh)
    gen = make_tp_generate(LCFG, mesh, max_new_tokens=6, eos_token=-1,
                           compute_dtype=jnp.float32)
    out = np.asarray(gen(sharded, embeds))
    np.testing.assert_array_equal(out, ref)


def test_tp_generate_int8_kv_matches_single_device():
    """TP decode with the int8 KV cache == single-device int8-KV decode
    (the quantized cache and its scales shard over kv-heads via GSPMD)."""
    params = llama.init(jax.random.key(1), LCFG)
    rng = np.random.default_rng(1)
    prompt = jnp.asarray(rng.integers(3, 90, (2, 5)), jnp.int32)
    embeds = llama.embed_tokens(params, prompt)

    ref = np.asarray(llama.greedy_generate(
        params, embeds, LCFG, max_new_tokens=6, eos_token=-1,
        compute_dtype=jnp.float32, kv_dtype=jnp.int8))

    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devices, (DATA_AXIS, MODEL_AXIS))
    sharded = shard_llama_params(params, mesh)
    gen = make_tp_generate(LCFG, mesh, max_new_tokens=6, eos_token=-1,
                           compute_dtype=jnp.float32, kv_dtype=jnp.int8)
    out = np.asarray(gen(sharded, embeds))
    np.testing.assert_array_equal(out, ref)


def test_tp4_generate_matches_single_device():
    """TP=4 (full model axis, 1x4 mesh): the Megatron shardings hold
    beyond TP=2 — kv-heads, attention heads, and MLP all split 4 ways
    (VERDICT r2 Next #5: TP>=4 decode exercised)."""
    cfg = LlamaConfig(vocab_size=96, dim=64, layers=2, heads=4, kv_heads=4,
                      mlp_dim=128, max_seq=64)
    params = llama.init(jax.random.key(3), cfg)
    rng = np.random.default_rng(3)
    prompt = jnp.asarray(rng.integers(3, 90, (2, 5)), jnp.int32)
    embeds = llama.embed_tokens(params, prompt)

    ref = np.asarray(llama.greedy_generate(
        params, embeds, cfg, max_new_tokens=6, eos_token=-1,
        compute_dtype=jnp.float32, kv_dtype=jnp.int8))

    devices = np.asarray(jax.devices()[:4]).reshape(1, 4)
    mesh = Mesh(devices, (DATA_AXIS, MODEL_AXIS))
    sharded = shard_llama_params(params, mesh)
    gen = make_tp_generate(cfg, mesh, max_new_tokens=6, eos_token=-1,
                           compute_dtype=jnp.float32, kv_dtype=jnp.int8)
    out = np.asarray(gen(sharded, embeds))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.slow
def test_tp_generate_fast_decode_options_compose():
    """unroll + chunked prefill + decode_window + early_stop under TP ==
    the plain single-device decode (the options restructure the position
    loop only; shardings are untouched)."""
    params = llama.init(jax.random.key(2), LCFG)
    rng = np.random.default_rng(2)
    prompt = jnp.asarray(rng.integers(3, 90, (2, 9)), jnp.int32)
    embeds = llama.embed_tokens(params, prompt)

    ref = np.asarray(llama.greedy_generate(
        params, embeds, LCFG, max_new_tokens=6, eos_token=-1,
        compute_dtype=jnp.float32, kv_dtype=jnp.int8))

    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devices, (DATA_AXIS, MODEL_AXIS))
    sharded = shard_llama_params(params, mesh)
    gen = make_tp_generate(LCFG, mesh, max_new_tokens=6, eos_token=-1,
                           compute_dtype=jnp.float32, kv_dtype=jnp.int8,
                           layers="unroll", prefill_chunk=4,
                           decode_window=4, early_stop=True)
    out = np.asarray(gen(sharded, embeds))
    np.testing.assert_array_equal(out, ref)


def test_tp_generate_fori_layers_compose():
    """layers="fori" (the measured-fast serving form: stacked cache in the
    loop carry, in-place (layer, ..., pos) updates) under TP == the plain
    single-device decode — dynamic_index_in_dim over the replicated L axis
    and the carry updates leave GSPMD's kv-head/dim shardings untouched."""
    params = llama.init(jax.random.key(3), LCFG)
    rng = np.random.default_rng(3)
    prompt = jnp.asarray(rng.integers(3, 90, (2, 9)), jnp.int32)
    embeds = llama.embed_tokens(params, prompt)

    ref = np.asarray(llama.greedy_generate(
        params, embeds, LCFG, max_new_tokens=6, eos_token=-1,
        compute_dtype=jnp.float32, kv_dtype=jnp.int8))

    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devices, (DATA_AXIS, MODEL_AXIS))
    sharded = shard_llama_params(params, mesh)
    gen = make_tp_generate(LCFG, mesh, max_new_tokens=6, eos_token=-1,
                           compute_dtype=jnp.float32, kv_dtype=jnp.int8,
                           layers="fori", prefill_chunk=4, early_stop=True)
    out = np.asarray(gen(sharded, embeds))
    np.testing.assert_array_equal(out, ref)


def test_tp_generate_int8_weights_matches_single_device():
    """int8 serving WEIGHTS (QTensor leaves) TP-shard like bf16: the
    per-output-channel scale vectors place with the weight's N-axis
    sharding (shard_llama_params._scale_spec) — the --verifier-int8 --tp
    production config."""
    from mmrs_tpu.models.quantize import quantize_llama

    params = quantize_llama(llama.init(jax.random.key(7), LCFG))
    rng = np.random.default_rng(7)
    prompt = jnp.asarray(rng.integers(3, 90, (2, 5)), jnp.int32)
    embeds = llama.embed_tokens(params, prompt)

    ref = np.asarray(llama.greedy_generate(
        params, embeds, LCFG, max_new_tokens=6, eos_token=-1,
        compute_dtype=jnp.float32, kv_dtype=jnp.int8))

    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devices, (DATA_AXIS, MODEL_AXIS))
    sharded = shard_llama_params(params, mesh)
    # the Megatron layout actually took: wq int8 values split their
    # out-channel axis, scales split alongside, wo splits its in axis
    wq = sharded["blocks"]["wq"]
    assert not wq.q.sharding.is_fully_replicated
    assert not wq.s.sharding.is_fully_replicated
    gen = make_tp_generate(LCFG, mesh, max_new_tokens=6, eos_token=-1,
                           compute_dtype=jnp.float32, kv_dtype=jnp.int8)
    out = np.asarray(gen(sharded, embeds))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.slow
def test_tp_speculative_matches_single_device_replicated_draft():
    """TP-sharded target + REPLICATED draft (its kv_heads=1 can't split
    the model axis — the auto rule must pick replication): the speculative
    output equals plain single-device greedy decode of the target."""
    tparams = llama.init(jax.random.key(4), LCFG)
    dcfg = LlamaConfig(vocab_size=96, dim=32, layers=1, heads=2, kv_heads=1,
                       mlp_dim=64, max_seq=64)
    dparams = llama.init(jax.random.key(5), dcfg)
    rng = np.random.default_rng(4)
    prompt = jnp.asarray(rng.integers(3, 90, (2, 5)), jnp.int32)
    te = llama.embed_tokens(tparams, prompt)
    de = llama.embed_tokens(dparams, prompt)

    ref = np.asarray(llama.greedy_generate(
        tparams, te, LCFG, max_new_tokens=8, eos_token=-1,
        compute_dtype=jnp.float32, kv_dtype=jnp.int8))

    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devices, (DATA_AXIS, MODEL_AXIS))
    assert not draft_tp_divisible(dcfg, mesh)
    gen = make_tp_speculative_generate(
        LCFG, dcfg, mesh, max_new_tokens=8, draft_tokens=3, eos_token=-1,
        compute_dtype=jnp.float32, kv_dtype=jnp.int8)
    out = np.asarray(gen(shard_llama_params(tparams, mesh),
                         replicate_llama_params(dparams, mesh), te, de))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.slow
def test_tp_speculative_sharded_draft_ideal_rounds():
    """Target and draft both TP-sharded (draft == target, so every
    proposal is accepted): output matches greedy and the round count is
    the full-acceptance ideal — the frontier-KV repair works under TP."""
    params = llama.init(jax.random.key(6), LCFG)
    rng = np.random.default_rng(6)
    prompt = jnp.asarray(rng.integers(3, 90, (2, 5)), jnp.int32)
    emb = llama.embed_tokens(params, prompt)
    k, max_new = 3, 12

    ref = np.asarray(llama.greedy_generate(
        params, emb, LCFG, max_new_tokens=max_new, eos_token=-1,
        compute_dtype=jnp.float32))

    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devices, (DATA_AXIS, MODEL_AXIS))
    assert draft_tp_divisible(LCFG, mesh)
    gen = make_tp_speculative_generate(
        LCFG, LCFG, mesh, max_new_tokens=max_new, draft_tokens=k,
        eos_token=-1, compute_dtype=jnp.float32, return_stats=True)
    sharded = shard_llama_params(params, mesh)
    out, stats = gen(sharded, sharded, emb, emb)
    np.testing.assert_array_equal(np.asarray(out), ref)
    assert int(stats["rounds"]) == -(-(max_new - 1) // (k + 1))


@pytest.mark.slow
def test_tp8_generate_matches_single_device():
    """TP=8 (the whole 8-device mesh on the model axis): heads, kv-heads,
    and MLP split 8 ways — the widest single-host TP an 8-card host
    serves."""
    cfg = LlamaConfig(vocab_size=96, dim=128, layers=2, heads=8,
                      kv_heads=8, mlp_dim=256, max_seq=64)
    params = llama.init(jax.random.key(5), cfg)
    rng = np.random.default_rng(5)
    prompt = jnp.asarray(rng.integers(3, 90, (2, 5)), jnp.int32)
    embeds = llama.embed_tokens(params, prompt)

    ref = np.asarray(llama.greedy_generate(
        params, embeds, cfg, max_new_tokens=6, eos_token=-1,
        compute_dtype=jnp.float32, kv_dtype=jnp.int8))

    devices = np.asarray(jax.devices()[:8]).reshape(1, 8)
    mesh = Mesh(devices, (DATA_AXIS, MODEL_AXIS))
    sharded = shard_llama_params(params, mesh)
    gen = make_tp_generate(cfg, mesh, max_new_tokens=6, eos_token=-1,
                           compute_dtype=jnp.float32, kv_dtype=jnp.int8)
    out = np.asarray(gen(sharded, embeds))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.slow
def test_dp_tp_generate_matches_single_device():
    """2x2 mesh = batch-DP x decoder-TP in one program: prompt rows split
    over the data axis while the Megatron decoder shards over model —
    token-exact vs single-device decode."""
    params = llama.init(jax.random.key(8), LCFG)
    rng = np.random.default_rng(8)
    prompt = jnp.asarray(rng.integers(3, 90, (4, 5)), jnp.int32)  # B=4
    embeds = llama.embed_tokens(params, prompt)

    ref = np.asarray(llama.greedy_generate(
        params, embeds, LCFG, max_new_tokens=6, eos_token=-1,
        compute_dtype=jnp.float32, kv_dtype=jnp.int8))

    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devices, (DATA_AXIS, MODEL_AXIS))
    sharded = shard_llama_params(params, mesh)
    gen = make_tp_generate(LCFG, mesh, max_new_tokens=6, eos_token=-1,
                           compute_dtype=jnp.float32, kv_dtype=jnp.int8)
    out = np.asarray(gen(sharded, embeds))
    np.testing.assert_array_equal(out, ref)
