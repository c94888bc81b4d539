"""L2 normalization used everywhere in the retrieval path.

The reference normalizes every embedding before similarity
(`image_features /= image_features.norm(dim=-1, keepdim=True)`,
CLIP/lab1.py:89). We match that contract, with f32 math even for bf16
inputs so that downstream cosine rankings are stable.
"""

from __future__ import annotations

import jax.numpy as jnp


def l2_normalize(x: jnp.ndarray, axis: int = -1, eps: float = 1e-12) -> jnp.ndarray:
    orig_dtype = x.dtype
    x32 = x.astype(jnp.float32)
    norm = jnp.sqrt(jnp.sum(x32 * x32, axis=axis, keepdims=True))
    return (x32 / jnp.maximum(norm, eps)).astype(orig_dtype)
