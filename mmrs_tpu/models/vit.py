"""CLIP ViT image tower (B/32 and L/14).

Replaces the reference's `clip.load("ViT-B/32")` image encoder
(code/test_clip.py:6, CLIP/lab1.py:50) and the HF
openai/clip-vit-large-patch14 image tower (code/test_taiyi.py:17).

Choices:
  - the patch-embedding conv (Conv2d stride=patch) is expressed as
    patchify-reshape + ONE dense matmul — a [B*G*G, P*P*3] x [P*P*3, W]
    contraction that tiles directly onto the tensor cores instead of a
    small-window convolution;
  - all per-layer params are stacked and the encoder body is one lax.scan
    (see models/layers.py);
  - matmuls in bf16 with f32 accumulation; LayerNorm/softmax in f32.

Output contract matches OpenAI CLIP: ln_post over the CLS token, then the
`proj` matrix -> [B, embed_dim] (unnormalized; callers L2-normalize as the
reference does at CLIP/lab1.py:89).
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp

from mmrs_tpu.models.configs import VITConfig
from mmrs_tpu.models.layers import (
    dense,
    gelu,
    init_block_params,
    layer_norm,
    quick_gelu,
    scan_blocks,
)

Params = Dict[str, Any]


def patchify(images: jnp.ndarray, patch: int) -> jnp.ndarray:
    """[B, H, W, 3] -> [B, G*G, P*P*3] (channel-last HWC input).

    Flattening order matches a torch Conv2d(3, W, P, stride=P) with weights
    converted via convert.py: the kernel is reordered there so that this
    (h, w, c)-ordered flatten contracts identically.
    """
    b, h, w, c = images.shape
    g = h // patch
    x = images.reshape(b, g, patch, g, patch, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)  # [B, G, G, P, P, C]
    return x.reshape(b, g * g, patch * patch * c)


def apply(
    params: Params,
    images: jnp.ndarray,           # [B, H, W, 3] float, already CLIP-normalized
    cfg: VITConfig,
    compute_dtype=jnp.bfloat16,
    unroll: int = 1,               # lax.scan unroll for the block stack
) -> jnp.ndarray:                   # [B, embed_dim]
    x = patchify(images, cfg.patch_size)                       # [B, N, P*P*3]
    x = dense(x, params["patch_kernel"], None, compute_dtype)  # [B, N, W]

    cls = params["class_embedding"].astype(compute_dtype)
    cls = jnp.broadcast_to(cls[None, None, :], (x.shape[0], 1, cfg.width))
    x = jnp.concatenate([cls, x], axis=1)                      # [B, N+1, W]
    x = x + params["positional_embedding"].astype(compute_dtype)[None]

    x = layer_norm(x, params["ln_pre_scale"], params["ln_pre_bias"])
    act = quick_gelu if cfg.quick_gelu else gelu
    x = scan_blocks(x, params["blocks"], cfg.heads, None, act, compute_dtype,
                    unroll=unroll)

    cls_tok = x[:, 0, :]
    cls_tok = layer_norm(cls_tok, params["ln_post_scale"], params["ln_post_bias"])
    out = jnp.dot(
        cls_tok.astype(compute_dtype),
        params["proj"].astype(compute_dtype),
        preferred_element_type=jnp.float32,
    )
    return out  # f32 [B, embed_dim]


def init(key: jax.Array, cfg: VITConfig, dtype=jnp.float32) -> Params:
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    s = cfg.width ** -0.5
    return {
        "patch_kernel": (
            jax.random.normal(k1, (cfg.patch_size * cfg.patch_size * 3, cfg.width)) * 0.02
        ).astype(dtype),
        "class_embedding": (jax.random.normal(k2, (cfg.width,)) * s).astype(dtype),
        "positional_embedding": (
            jax.random.normal(k3, (cfg.seq_len, cfg.width)) * s
        ).astype(dtype),
        "ln_pre_scale": jnp.ones((cfg.width,), dtype),
        "ln_pre_bias": jnp.zeros((cfg.width,), dtype),
        "blocks": init_block_params(k4, cfg.layers, cfg.width, dtype=dtype),
        "ln_post_scale": jnp.ones((cfg.width,), dtype),
        "ln_post_bias": jnp.zeros((cfg.width,), dtype),
        "proj": (jax.random.normal(k5, (cfg.width, cfg.embed_dim)) * s).astype(dtype),
    }
