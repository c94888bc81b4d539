"""Image preprocessing: host decode/resize (PIL-parity) + device normalize.

Split follows SURVEY.md §7 "hard parts": PIL's bicubic resample cannot be
bit-matched cheaply on device, and rank parity with the reference depends on
it — so decode + resize + center-crop stay on host with PIL-identical math
(CLIP/lab1.py:26 `preprocess(img)`), while the per-pixel affine
(uint8 -> scale -> CLIP mean/std normalize -> bf16) runs on device; the
batch travels host->device as uint8 (4x smaller).

The normalize is plain XLA: XLA fuses the affine into its consumer (the
patchify transpose + patch matmul), so the normalized image is never
materialized in device memory and a separate kernel could only add a
round trip.

CLIP normalization constants from code/custom.py:28.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# OpenAI CLIP constants (code/custom.py:28)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


# --------------------------------------------------------------------------
# Host side: PIL-parity resize + center crop (matches clip.load preprocess)
# --------------------------------------------------------------------------

def resize_center_crop(img, size: int = 224):
    """PIL path of OpenAI CLIP preprocess: BICUBIC resize of the SHORT side
    to `size`, then center crop size x size. Returns HWC uint8 ndarray."""
    from PIL import Image

    w, h = img.size
    # torchvision Resize floors the long side (int(), not round()):
    # _compute_resized_output_size -> int(size * long / short).
    if w < h:
        nw, nh = size, int(size * h / w)
    else:
        nw, nh = int(size * w / h), size
    img = img.resize((nw, nh), Image.BICUBIC)
    left = (nw - size) // 2
    top = (nh - size) // 2
    img = img.crop((left, top, left + size, top + size))
    return np.asarray(img.convert("RGB"), dtype=np.uint8)


def hf_resize_center_crop(img, size: int = 224):
    """HF CLIPImageProcessor path (used by the Chinese tower,
    CLIP-Chinese/lab_chinese.py:29). Differentially verified byte-
    identical to resize_center_crop against the real transformers
    CLIPImageProcessor across aspect ratios (tests/test_bilingual_
    augment.py) — HF's shortest-edge resize + center crop coincides
    with the torchvision stack, so this is an alias, not a duplicate
    implementation."""
    return resize_center_crop(img, size)


# --------------------------------------------------------------------------
# Device side: uint8 -> normalized compute dtype
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("dtype",))
def normalize_images(
    images_u8: jnp.ndarray,        # [B, H, W, 3] uint8
    dtype=jnp.bfloat16,
) -> jnp.ndarray:
    """(x/255 - mean) / std on device, output in compute dtype."""
    mean = jnp.asarray(CLIP_MEAN, jnp.float32)
    inv_std = 1.0 / jnp.asarray(CLIP_STD, jnp.float32)
    x = images_u8.astype(jnp.float32) / 255.0
    return ((x - mean) * inv_std).astype(dtype)
