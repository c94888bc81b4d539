"""CLIP contrastive training step, sharded over a (data, model) mesh.

The reference never trains the towers (only the Tip-Adapter linear head,
code/main_custom.py:148-247); this framework adds full-tower contrastive
fine-tuning as the flagship training path so galleries can be domain-adapted.

Sharding layout (SPMD via jit in/out shardings; XLA inserts the collectives):
  - batch (images, tokens)      -> P("data", ...)           [DP]
  - attention wq/wk/wv kernels  -> P(None, None, "model")   [TP: split heads]
  - attention wo kernel         -> P(None, "model", None)   [TP: row-parallel]
  - mlp w1                      -> P(None, None, "model")   [TP: col-parallel]
  - mlp w2                      -> P(None, "model", None)   [TP: row-parallel]
  - embeddings / LN / proj      -> replicated
PP/SP/EP are intentionally absent: sequences are <=77/257 tokens and there
are no MoE layers (SURVEY.md §2.6) — gallery sharding is the scale axis.
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mmrs_tpu.models import clip, text_transformer, vit
from mmrs_tpu.models.clip import CLIPConfig
from mmrs_tpu.ops.normalize import l2_normalize
from mmrs_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS


def _block_specs() -> Dict[str, Any]:
    return {
        "ln1_scale": P(), "ln1_bias": P(),
        "ln2_scale": P(), "ln2_bias": P(),
        "attn": {
            "wq": P(None, None, MODEL_AXIS), "bq": P(None, MODEL_AXIS),
            "wk": P(None, None, MODEL_AXIS), "bk": P(None, MODEL_AXIS),
            "wv": P(None, None, MODEL_AXIS), "bv": P(None, MODEL_AXIS),
            "wo": P(None, MODEL_AXIS, None), "bo": P(),
        },
        "mlp": {
            "w1": P(None, None, MODEL_AXIS), "b1": P(None, MODEL_AXIS),
            "w2": P(None, MODEL_AXIS, None), "b2": P(),
        },
    }


def clip_param_specs() -> Dict[str, Any]:
    """PartitionSpec pytree matching clip.init's param tree."""
    return {
        "visual": {
            "patch_kernel": P(),
            "class_embedding": P(),
            "positional_embedding": P(),
            "ln_pre_scale": P(), "ln_pre_bias": P(),
            "blocks": _block_specs(),
            "ln_post_scale": P(), "ln_post_bias": P(),
            "proj": P(),
        },
        "text": {
            "token_embedding": P(),
            "positional_embedding": P(),
            "blocks": _block_specs(),
            "ln_final_scale": P(), "ln_final_bias": P(),
            "text_projection": P(),
        },
        "logit_scale": P(),
    }


def contrastive_loss(params, images, tokens, cfg: CLIPConfig,
                     compute_dtype=jnp.bfloat16) -> jnp.ndarray:
    img = l2_normalize(vit.apply(params["visual"], images, cfg.vision,
                                 compute_dtype))
    txt = l2_normalize(text_transformer.apply(params["text"], tokens, cfg.text,
                                              compute_dtype))
    scale = jnp.exp(params["logit_scale"])
    logits = scale * jnp.dot(img.astype(jnp.float32), txt.astype(jnp.float32).T,
                             preferred_element_type=jnp.float32)
    labels = jnp.arange(logits.shape[0])
    li = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
    lt = optax.softmax_cross_entropy_with_integer_labels(logits.T, labels).mean()
    return 0.5 * (li + lt)


def make_train_step(
    cfg: CLIPConfig,
    mesh: Mesh,
    learning_rate: float = 1e-5,
    weight_decay: float = 0.01,
    compute_dtype=jnp.bfloat16,
    donate: bool = True,
    remat: bool = False,
):
    """Returns (train_step, init_state). train_step is jitted with full
    DP x TP shardings over `mesh`.

    `donate` (default True) updates params and optimizer state in place,
    halving their device memory.
    `remat=True` rematerializes the loss (activation checkpointing) —
    trades FLOPs for HBM when batch x resolution outgrows memory."""
    tx = optax.adamw(learning_rate, weight_decay=weight_decay)
    loss_fn_base = (jax.checkpoint(contrastive_loss, static_argnums=(3, 4))
                    if remat else contrastive_loss)

    param_specs = clip_param_specs()
    param_sh = jax.tree.map(lambda s: NamedSharding(mesh, s), param_specs,
                            is_leaf=lambda x: isinstance(x, P))
    batch_sh = NamedSharding(mesh, P(DATA_AXIS))
    repl = NamedSharding(mesh, P())

    def init_state(key):
        params = clip.init(key, cfg)
        params = jax.device_put(params, param_sh)
        opt_state = tx.init(params)
        return params, opt_state

    def step(params, opt_state, images, tokens):
        loss, grads = jax.value_and_grad(loss_fn_base)(
            params, images, tokens, cfg, compute_dtype
        )
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    train_step = jax.jit(
        step,
        in_shardings=(param_sh, None, batch_sh, batch_sh),
        out_shardings=(param_sh, None, repl),
        donate_argnums=(0, 1) if donate else (),
    )
    return train_step, init_state
