"""Dual-tower CLIP wrapper: encode_image / encode_text / similarity logits.

The reference's scoring contracts, all reproduced:
  - softmax classification: `(100. * image @ text.T).softmax(-1)`
    (CLIP/lab1.py:90-91, code/test_clip.py);
  - logit-scaled cosine with threshold: `logit_scale.exp() * cosine`
    (code/merge_dataset.py:275-279, clip_en.ipynb cell 65);
  - raw cosine for the lab3-style sweeps (CLIP/lab3.py:107-117).

logit_scale is kept in f32 (bf16 would quantize exp(4.6052)=100.0 visibly).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mmrs_tpu.models import bert, text_transformer, vit
from mmrs_tpu.models.configs import BertConfig, TextConfig, VITConfig
from mmrs_tpu.ops.normalize import l2_normalize

Params = Dict[str, Any]


@dataclass(frozen=True)
class CLIPConfig:
    vision: VITConfig
    text: TextConfig
    logit_scale_init: float = float(np.log(1.0 / 0.07))  # OpenAI default


def init(key: jax.Array, cfg: CLIPConfig, dtype=jnp.float32) -> Params:
    kv, kt = jax.random.split(key)
    return {
        "visual": vit.init(kv, cfg.vision, dtype),
        "text": text_transformer.init(kt, cfg.text, dtype),
        "logit_scale": jnp.asarray(cfg.logit_scale_init, jnp.float32),
    }


@partial(jax.jit,
         static_argnames=("cfg", "compute_dtype", "normalize", "unroll"))
def encode_image(
    params: Params,
    images: jnp.ndarray,
    cfg: CLIPConfig,
    compute_dtype=jnp.bfloat16,
    normalize: bool = True,
    unroll: int = 1,
) -> jnp.ndarray:
    feats = vit.apply(params["visual"], images, cfg.vision, compute_dtype,
                      unroll=unroll)
    return l2_normalize(feats) if normalize else feats


@partial(jax.jit, static_argnames=("cfg", "compute_dtype", "normalize"))
def encode_text(
    params: Params,
    tokens: jnp.ndarray,
    cfg: CLIPConfig,
    compute_dtype=jnp.bfloat16,
    normalize: bool = True,
) -> jnp.ndarray:
    feats = text_transformer.apply(params["text"], tokens, cfg.text, compute_dtype)
    return l2_normalize(feats) if normalize else feats


def similarity_logits(
    image_feats: jnp.ndarray,   # [B, D] L2-normalized
    text_feats: jnp.ndarray,    # [C, D] L2-normalized
    logit_scale: Optional[jnp.ndarray] = None,
    scale: float = 100.0,
) -> jnp.ndarray:
    """Scaled cosine logits [B, C]; f32 accumulation for stable ranking."""
    s = jnp.exp(logit_scale) if logit_scale is not None else jnp.float32(scale)
    return s * jnp.dot(
        image_feats.astype(jnp.float32),
        text_feats.astype(jnp.float32).T,
        preferred_element_type=jnp.float32,
    )


def zeroshot_probs(image_feats, text_feats, scale: float = 100.0) -> jnp.ndarray:
    """The test_clip.py contract: softmax over `100 * cosine` per image."""
    return jax.nn.softmax(similarity_logits(image_feats, text_feats, scale=scale), axis=-1)


# --- Chinese (Taiyi) pair -------------------------------------------------

@dataclass(frozen=True)
class TaiyiCLIPConfig:
    vision: VITConfig
    text: BertConfig
    logit_scale_init: float = float(np.log(1.0 / 0.07))


def taiyi_init(key: jax.Array, cfg: TaiyiCLIPConfig, dtype=jnp.float32) -> Params:
    kv, kt = jax.random.split(key)
    return {
        "visual": vit.init(kv, cfg.vision, dtype),
        "text": bert.init(kt, cfg.text, dtype),
        "logit_scale": jnp.asarray(cfg.logit_scale_init, jnp.float32),
    }


@partial(jax.jit, static_argnames=("cfg", "compute_dtype", "normalize"))
def taiyi_encode_text(
    params: Params,
    tokens: jnp.ndarray,
    attention_mask: jnp.ndarray,
    cfg: TaiyiCLIPConfig,
    compute_dtype=jnp.bfloat16,
    normalize: bool = True,
) -> jnp.ndarray:
    feats = bert.apply(params["text"], tokens, attention_mask, cfg.text, compute_dtype)
    return l2_normalize(feats) if normalize else feats
