"""Tensor-parallel hosting of the VLM verifier decoder.

SURVEY.md §2.6 item 3: ViT towers fit on one chip, but the mesh keeps a
`model` axis reserved so the 7B LLaVA decoder can be TP-sharded.
Megatron-style layout, applied as jit in_shardings (GSPMD inserts the
all-reduces after the row-parallel matmuls):

  wq/wk/wv   [L, D, H*hd]  -> P(None, None, "model")   column-parallel
  wo         [L, D, D]     -> P(None, "model", None)   row-parallel
  w_gate/up  [L, D, M]     -> P(None, None, "model")   column-parallel
  w_down     [L, M, D]     -> P(None, "model", None)   row-parallel
  lm_head    [D, V]        -> P(None, "model")         vocab-parallel
  embeddings / norms       -> replicated

The KV cache shards with the kv-head axis implicitly via GSPMD propagation
from the column-parallel wk/wv outputs. Requires heads % model_size == 0 and
kv_heads % model_size == 0.
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mmrs_tpu.models import llama
from mmrs_tpu.models.llama import LlamaConfig
from mmrs_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS


def llama_param_specs() -> Dict[str, Any]:
    return {
        "embed": P(),
        "blocks": {
            "attn_norm": P(),
            "wq": P(None, None, MODEL_AXIS),
            "wk": P(None, None, MODEL_AXIS),
            "wv": P(None, None, MODEL_AXIS),
            "wo": P(None, MODEL_AXIS, None),
            "mlp_norm": P(),
            "w_gate": P(None, None, MODEL_AXIS),
            "w_up": P(None, None, MODEL_AXIS),
            "w_down": P(None, MODEL_AXIS, None),
        },
        "final_norm": P(),
        "lm_head": P(None, MODEL_AXIS),
    }


def _scale_spec(spec: P) -> P:
    """Spec for a QTensor's per-output-channel scales: the int8 weight is
    [..., K, N] and its scale vector [..., N], so drop the spec's K axis."""
    return P(*spec[:-2], spec[-1]) if len(spec) >= 2 else spec


def shard_llama_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """Place llama params per `llama_param_specs`. int8 serving weights
    (layers.QTensor, models/quantize.quantize_llama) place their scales
    with the weight's output-channel sharding (`_scale_spec`), so the
    int8 path TP-shards exactly like bf16."""
    from mmrs_tpu.models.layers import QTensor

    specs = llama_param_specs()

    def walk(s, v):
        if isinstance(v, QTensor):
            return QTensor(
                jax.device_put(v.q, NamedSharding(mesh, s)),
                jax.device_put(v.s, NamedSharding(mesh, _scale_spec(s))))
        if isinstance(s, P):
            return jax.device_put(v, NamedSharding(mesh, s))
        return {k: walk(s[k], v[k]) for k in v}

    return walk(specs, params)


def replicate_llama_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """Host params replicated on every mesh device (the draft-model layout
    when its head counts don't divide the model axis)."""
    return jax.device_put(params, NamedSharding(mesh, P()))


def make_tp_generate(cfg: LlamaConfig, mesh: Mesh, max_new_tokens: int,
                     eos_token: int = 2, compute_dtype=jnp.bfloat16,
                     kv_dtype=None, layers: str = "scan",
                     prefill_chunk: int | None = None,
                     decode_window: int | None = None,
                     early_stop: bool = False):
    """Returns a jitted greedy_generate with TP shardings over `mesh`.

    `kv_dtype=jnp.int8` serves with the quantized KV cache
    (llama.QKVCache); the per-shard k/v quantization is elementwise over
    head_dim, so GSPMD propagates the kv-head sharding into both the int8
    values and their scales unchanged. The single-chip decode options
    (`layers`/`prefill_chunk`/`decode_window`/`early_stop`, see
    llama.greedy_generate) compose: they only restructure the loop over
    positions, never the sharded tensor layouts.

    Pass params through `shard_llama_params(params, mesh)` — the jit
    inherits their committed placement (a static in_shardings tree can't
    express QTensor int8 weights, whose scale vectors shed the K axis).

    A mesh with a >1 `data` axis additionally splits the BATCH dim of the
    prompt (and the whole decode state) across the data replicas — the
    2-D batch-DP × decoder-TP serving shape. Batch must divide the data
    axis."""
    repl = NamedSharding(mesh, P())
    inp = _batch_sharding(mesh)

    def gen(params, prompt_embeds):
        return llama.greedy_generate(params, prompt_embeds, cfg,
                                     max_new_tokens, eos_token, compute_dtype,
                                     kv_dtype=kv_dtype, layers=layers,
                                     prefill_chunk=prefill_chunk,
                                     decode_window=decode_window,
                                     early_stop=early_stop)

    return jax.jit(gen, in_shardings=(None, inp), out_shardings=repl)


def _batch_sharding(mesh: Mesh) -> NamedSharding:
    """Input sharding for [B, ...] prompt tensors: rows split over the
    data axis when the mesh has one wider than 1, replicated otherwise."""
    if DATA_AXIS in mesh.shape and mesh.shape[DATA_AXIS] > 1:
        return NamedSharding(mesh, P(DATA_AXIS))
    return NamedSharding(mesh, P())


def shard_llava_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """Place llava params on `mesh`: vision tower and projector replicated
    (the 336px tower is ~0.3 GB — TP-sharding it buys little and costs
    per-layer collectives at T=577), the LM decoder Megatron-sharded
    (int8 QTensor weights included, see shard_llama_params)."""
    repl = NamedSharding(mesh, P())
    out = {k: jax.device_put(v, repl) for k, v in params.items()
           if k != "lm"}
    out["lm"] = shard_llama_params(params["lm"], mesh)
    return out


def llava_checkpoint_placement(mesh: Mesh):
    """`checkpoint.load_npz` placement fn for the TP llava layout.

    Maps flat checkpoint keys (e.g. "lm/blocks/wq", "lm/blocks/wq@int8q",
    "visual/blocks/w1") to shardings: the decoder Megatron-sharded per
    `llama_param_specs` (int8 scale vectors via `_scale_spec`), everything
    else replicated. Loading a 7B checkpoint straight into its TP
    placement this way keeps host memory at one array instead of the
    whole tree and skips the replicate-then-reshard step."""
    specs = llama_param_specs()
    repl = NamedSharding(mesh, P())

    def place(key: str):
        if not key.startswith("lm/"):
            return repl
        node: Any = specs
        for part in key[3:].split("/"):
            name = part.split("@")[0]
            if isinstance(node, dict) and name in node:
                node = node[name]
            else:
                return repl
        if not isinstance(node, P):
            return repl
        if key.endswith("@int8s"):
            return NamedSharding(mesh, _scale_spec(node))
        return NamedSharding(mesh, node)

    return place


def make_tp_llava_generate(cfg, mesh: Mesh, max_new_tokens: int = 32,
                           eos_token: int = 2, compute_dtype=jnp.bfloat16,
                           kv_dtype=None,
                           layers: str = "scan",
                           prefill_chunk: int | None = None,
                           decode_window: int | None = None,
                           early_stop: bool = False):
    """jitted llava.generate with the decoder TP-sharded over `mesh`.

    The vision tower + projector run replicated (every chip computes
    them — they are ~2% of the 7B step); GSPMD inserts the Megatron
    all-reduces in the decoder. `cfg` is an LLaVAConfig; cfg.lm must
    satisfy the same divisibility rules as make_tp_generate. Shard the
    params to match with `shard_llava_params`."""
    from mmrs_tpu.models import llava

    repl = NamedSharding(mesh, P())
    inp = _batch_sharding(mesh)

    def gen(params, images, pre_tokens, post_tokens):
        return llava.generate(
            params, images, pre_tokens, post_tokens, cfg, max_new_tokens,
            eos_token, compute_dtype,
            kv_dtype=kv_dtype, layers=layers, prefill_chunk=prefill_chunk,
            decode_window=decode_window, early_stop=early_stop)

    return jax.jit(gen, in_shardings=(None, inp, inp, inp),
                   out_shardings=repl)


def make_tp_llava_speculative_generate(
        cfg, draft_cfg, mesh: Mesh, max_new_tokens: int = 32,
        draft_tokens: int = 4, eos_token: int = 2,
        compute_dtype=jnp.bfloat16, kv_dtype=None,
        layers: str = "scan", prefill_chunk: int | None = None,
        return_stats: bool = False):
    """jitted llava.generate_speculative: target decoder TP-sharded,
    draft VLM replicated or its decoder TP-sharded — whichever way the
    caller PLACED the params (shard_llava_params vs
    replicate_llama_params; see make_tp_speculative_generate's trade-off
    note). Output is token-exact vs make_tp_llava_generate of the
    target."""
    from mmrs_tpu.models import llava

    repl = NamedSharding(mesh, P())
    inp = _batch_sharding(mesh)

    def gen(params, dparams, images, pre_tokens, post_tokens):
        return llava.generate_speculative(
            params, dparams, images, pre_tokens, post_tokens, cfg,
            draft_cfg, max_new_tokens, draft_tokens, eos_token,
            compute_dtype, kv_dtype=kv_dtype,
            layers=layers, prefill_chunk=prefill_chunk,
            return_stats=return_stats)

    # target/draft param shardings are inherited from their committed
    # placement (shard_llava_params / replicate_llama_params)
    return jax.jit(gen, in_shardings=(None, None, inp, inp, inp),
                   out_shardings=repl)


def draft_tp_divisible(draft_cfg: LlamaConfig, mesh: Mesh) -> bool:
    """True iff the draft model's shapes admit the Megatron layout on
    `mesh`'s model axis (same divisibility rules as the target)."""
    tp = mesh.shape[MODEL_AXIS]
    return (draft_cfg.heads % tp == 0 and draft_cfg.kv_heads % tp == 0
            and draft_cfg.mlp_dim % tp == 0
            and draft_cfg.vocab_size % tp == 0)


def make_tp_speculative_generate(
        target_cfg: LlamaConfig, draft_cfg: LlamaConfig, mesh: Mesh,
        max_new_tokens: int, draft_tokens: int = 4, eos_token: int = 2,
        compute_dtype=jnp.bfloat16, kv_dtype=None, layers: str = "scan",
        prefill_chunk: int | None = None, return_stats: bool = False):
    """Speculative greedy decode with the TARGET TP-sharded over `mesh`.

    Output is token-exact vs `make_tp_generate` of the target (the
    speculative guarantee, models/speculative.py) — the draft only
    changes speed.

    The draft's hosting is chosen by how its params are PLACED:
      - `shard_llama_params`: Megatron layout like the target — its
        weight stream splits TP-ways but every draft layer pays two tiny
        all-reduce latencies (requires `draft_tp_divisible`);
      - `replicate_llama_params`: each chip redundantly computes the full
        draft (its weights are ~5% of the target's) with zero
        collectives.
    Which wins is a collective-latency vs memory-bandwidth trade — measure on the
    deployment mesh.
    """
    from mmrs_tpu.models.speculative import speculative_generate

    repl = NamedSharding(mesh, P())
    inp = _batch_sharding(mesh)

    def gen(tparams, dparams, target_embeds, draft_embeds):
        return speculative_generate(
            tparams, dparams, target_embeds, draft_embeds,
            target_cfg, draft_cfg, max_new_tokens=max_new_tokens,
            draft_tokens=draft_tokens, eos_token=eos_token,
            compute_dtype=compute_dtype, kv_dtype=kv_dtype, layers=layers,
            prefill_chunk=prefill_chunk, return_stats=return_stats)

    # param shardings inherit from their committed placement
    # (shard_llama_params / replicate_llama_params)
    return jax.jit(gen, in_shardings=(None, None, inp, inp),
                   out_shardings=repl)
