"""Glue layer: config -> towers -> encode callables -> index/search/report.

This is where the CLI (and notebooks) assemble the pieces. Encoders are
plain callables `pixels_u8 [B,S,S,3] -> np.ndarray [B,D]` so every consumer
(index build, cascade scorer, eval harness) composes the same way the
reference's scripts reuse `encode_image` loops.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mmrs_tpu.config import Config
from mmrs_tpu.models import clip
from mmrs_tpu.models.clip import CLIPConfig, TaiyiCLIPConfig
from mmrs_tpu.models.configs import (
    CLIP_TEXT_B32,
    CLIP_TEXT_L14,
    CLIP_TEXT_TINY,
    IMAGE_TOWERS,
    TAIYI_ROBERTA_LARGE,
)
from mmrs_tpu.ops.preprocess import normalize_images


@dataclass
class Towers:
    """A ready pair of encode callables + the underlying params/config."""

    image_encode: Callable[[np.ndarray], np.ndarray]
    text_encode: Optional[Callable] = None
    params: Optional[dict] = None
    clip_config: Optional[object] = None
    tokenizer: Optional[object] = None
    # pure jittable (params, images_u8) -> [B, D]; feed parallel.embed
    encode_fn: Optional[Callable] = None
    # UNnormalized features — the Tip-Adapter cache contract
    # (code/utils.py:113-121 means raw encodes before the final L2-norm)
    image_encode_raw: Optional[Callable] = None


def build_towers(cfg: Config, tokenizer=None) -> Towers:
    """Construct the configured tower pair. Weights come from
    cfg.model.checkpoint_path (an npz saved from models/convert.py output);
    without one, randomly-initialized towers are used (bring-up mode)."""
    from mmrs_tpu.models import checkpoint

    vision = IMAGE_TOWERS[cfg.model.image_tower]
    if cfg.model.text_tower == "taiyi_roberta":
        from mmrs_tpu.models.configs import TAIYI_TINY

        # the text head's projection must match the image embed dim; the
        # tiny pair exists for CI/smoke runs
        taiyi = (TAIYI_TINY if cfg.model.image_tower == "vit_tiny"
                 else TAIYI_ROBERTA_LARGE)
        if taiyi.num_labels != vision.embed_dim:
            # fail NOW with a clear message, not later with an opaque
            # [B,512] @ [C,768].T shape error deep in the search path
            raise ValueError(
                f"text tower 'taiyi_roberta' projects to "
                f"{taiyi.num_labels}-d but image tower "
                f"{cfg.model.image_tower!r} embeds {vision.embed_dim}-d; "
                f"pair Taiyi with vit_l14 (the reference's pairing) or "
                f"vit_tiny")
        ccfg = TaiyiCLIPConfig(vision=vision, text=taiyi)
    else:
        text = {"vit_b32": CLIP_TEXT_B32, "vit_l14": CLIP_TEXT_L14,
                "vit_tiny": CLIP_TEXT_TINY}[cfg.model.image_tower]
        ccfg = CLIPConfig(vision=vision, text=text)

    if cfg.model.checkpoint_path:
        params = checkpoint.load_npz(cfg.model.checkpoint_path)
    elif isinstance(ccfg, TaiyiCLIPConfig):
        params = clip.taiyi_init(jax.random.key(cfg.seed), ccfg)
    else:
        params = clip.init(jax.random.key(cfg.seed), ccfg)
    # weights live on the device once; host arrays passed to the jitted
    # encoders would be copied over on every call
    params = jax.device_put(params)

    # dtype "int8": bf16 compute mix with the vision-tower matmuls running
    # int8 x int8 with int32 accumulation — see models/quantize.py
    compute_dtype = jnp.float32 if cfg.model.dtype == "float32" else jnp.bfloat16
    if cfg.model.dtype == "int8":
        from mmrs_tpu.models.quantize import quantize_clip_visual

        params = quantize_clip_visual(params)

    @functools.partial(jax.jit, static_argnums=())
    def _embed_images(p, images_u8):
        x = normalize_images(images_u8, dtype=compute_dtype)
        return clip.encode_image(p, x, ccfg, compute_dtype=compute_dtype)

    def image_encode(pixels_u8: np.ndarray) -> np.ndarray:
        out = _embed_images(params, jnp.asarray(pixels_u8))
        return np.asarray(out, dtype=np.float32)

    @functools.partial(jax.jit, static_argnums=())
    def _embed_images_raw(p, images_u8):
        x = normalize_images(images_u8, dtype=compute_dtype)
        return clip.encode_image(p, x, ccfg, compute_dtype=compute_dtype,
                                 normalize=False)

    def image_encode_raw(pixels_u8: np.ndarray) -> np.ndarray:
        out = _embed_images_raw(params, jnp.asarray(pixels_u8))
        return np.asarray(out, dtype=np.float32)

    text_encode = None
    if tokenizer is not None:
        if isinstance(ccfg, TaiyiCLIPConfig):
            def text_encode(texts):
                ids, mask = tokenizer(texts)
                out = clip.taiyi_encode_text(
                    params, jnp.asarray(ids), jnp.asarray(mask), ccfg,
                    compute_dtype=compute_dtype)
                return np.asarray(out, dtype=np.float32)
        else:
            def text_encode(texts):
                ids = tokenizer(texts)
                out = clip.encode_text(params, jnp.asarray(ids), ccfg,
                                       compute_dtype=compute_dtype)
                return np.asarray(out, dtype=np.float32)

    return Towers(image_encode=image_encode, text_encode=text_encode,
                  params=params, clip_config=ccfg, tokenizer=tokenizer,
                  encode_fn=_embed_images, image_encode_raw=image_encode_raw)
