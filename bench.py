"""Headline benchmark on one GPU: ViT-B/32 image-embedding throughput, plus
the exact top-k scan, the IVF probe and all-pairs dedup.

Prints ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": "images/sec", "device": {...},
   "card": "<name>, <power limit>", ... per-metric distributions ...}
Progress lines go to stderr.

Timing: every trial times calls that end in `block_until_ready`, after
warmup calls that absorb compilation; each metric runs TRIALS trials and
reports median / min / max / IQR (utils/trials.py). Every op runs its
default path (`impl="auto"`, ops/dispatch.py). A failing measurement fails
the run. Without a GPU the script exits non-zero before measuring.

Run: `python bench.py` (one process; it reserves most of the card).
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from mmrs_tpu.utils.compile_cache import enable_compile_cache
from mmrs_tpu.utils.trials import call_seconds, fmt

TRIALS = 5
EMBED_BATCH = 224


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_embed(int8: bool = False, batch: int = EMBED_BATCH):
    """Per-batch seconds of normalize + ViT-B/32 on uint8 batches made on
    the device (host upload is ingest, not embed)."""
    from mmrs_tpu.models import clip
    from mmrs_tpu.models.clip import CLIPConfig
    from mmrs_tpu.models.configs import CLIP_TEXT_B32, VIT_B32
    from mmrs_tpu.ops.preprocess import normalize_images

    cfg = CLIPConfig(vision=VIT_B32, text=CLIP_TEXT_B32)
    # params are jit ARGUMENTS, not closure constants, so they are not
    # baked into the executable
    params = clip.init(jax.random.key(0), cfg)
    params = jax.tree.map(
        lambda x: x.astype(jnp.bfloat16)
        if x.dtype == jnp.float32 and x.ndim > 1 else x, params)
    if int8:
        from mmrs_tpu.models.quantize import quantize_clip_visual

        params = quantize_clip_visual(params)

    @jax.jit
    def embed(params, images_u8):
        x = normalize_images(images_u8, dtype=jnp.bfloat16)
        return clip.encode_image(params, x, cfg)

    images = jax.random.randint(jax.random.key(1), (batch, 224, 224, 3), 0,
                                256, jnp.uint8)
    dist = call_seconds(embed, params, images, n=TRIALS, reps=8)
    tag = "int8" if int8 else "bf16"
    log(fmt(f"embed[{tag}] per-batch", dist, "ms", 1e3)
        + f" -> median {batch / dist['median']:.0f} images/sec")
    return dist


def bench_query():
    from mmrs_tpu.ops.topk import cosine_topk

    n, d = 1_048_576, 512
    g = jax.random.normal(jax.random.key(0), (n, d), jnp.bfloat16)
    q = jax.random.normal(jax.random.key(1), (8, d), jnp.bfloat16)
    dist = call_seconds(lambda q: cosine_topk(q, g, 10), q, n=TRIALS,
                        reps=16)
    log(fmt("query: top-10 over 1M x 512 bf16, Q=8", dist, "ms", 1e3)
        + f" ({n * d * 2 / dist['median'] / 1e9:.0f} GB/s of gallery)")
    return dist


def bench_ivf():
    """256k x 512 IVF (C=512, nprobe=32), Q=8: probe-latency distribution
    and recall@10 against the exact scan."""
    from mmrs_tpu.index.ivf import build_ivf_streaming, ivf_topk
    from mmrs_tpu.ops.topk import cosine_topk

    n_chunks, chunk, d = 4, 65536, 512
    n = n_chunks * chunk

    @jax.jit
    def gen(key):
        k1, k2 = jax.random.split(key)
        anchors = jax.random.normal(jax.random.key(7), (2048, d),
                                    jnp.float32)
        anchors = anchors / jnp.linalg.norm(anchors, axis=1, keepdims=True)
        which = jax.random.randint(k1, (chunk,), 0, 2048)
        x = anchors[which] + (0.9 / d ** 0.5) * jax.random.normal(
            k2, (chunk, d), jnp.float32)
        return (x / jnp.linalg.norm(x, axis=1, keepdims=True)).astype(
            jnp.bfloat16)

    def chunks():
        for i in range(n_chunks):
            yield gen(jax.random.key(i))

    ivf = build_ivf_streaming(chunks, n, d, n_clusters=512, iters=5,
                              chunk=chunk, dtype=jnp.bfloat16)
    q = gen(jax.random.key(999))[:8]
    gallery = jnp.concatenate(list(chunks()), axis=0)
    _, exact = cosine_topk(q, gallery, 10)
    del gallery
    _, got = ivf_topk(q, ivf, k=10, nprobe=32)
    exact, got = np.asarray(exact), np.asarray(got)
    recall = float(np.mean([len(set(got[r]) & set(exact[r])) / 10
                            for r in range(8)]))
    dist = call_seconds(lambda x: ivf_topk(x, ivf, k=10, nprobe=32), q,
                        n=TRIALS, reps=16)
    log(fmt("ivf[256k, C=512, nprobe=32] Q=8", dist, "ms", 1e3)
        + f", recall@10 {recall:.3f}")
    return dist, recall


def bench_dedup():
    from mmrs_tpu.ops.allpairs import first_match

    n, d = 131_072, 512
    x = jax.random.normal(jax.random.key(0), (n, d), jnp.float32)
    x = (x / jnp.linalg.norm(x, axis=1, keepdims=True)).astype(jnp.bfloat16)
    dist = call_seconds(lambda a: first_match(a, a, tau=0.99, intra=True),
                        x, warmup=1, n=TRIALS)
    log(fmt("dedup: 131072^2 all-pairs", dist, "ms", 1e3)
        + f" -> {n * n / dist['median'] / 1e9:.1f} Gpairs/s at the median")
    return dist


def _dist_json(dist, scale=1.0):
    return {k: (v * scale if k != "n" else v) if not isinstance(v, list)
            else [x * scale for x in v] for k, v in dist.items()}


def main():
    enable_compile_cache()
    from mmrs_tpu.utils.device import (card_name_and_power, device_record,
                                       require_gpu)

    log(f"devices: {require_gpu()}")
    card = card_name_and_power()
    log(f"card: {card}")
    extras = {"query_ms": _dist_json(bench_query(), 1e3)}
    ivf_dist, ivf_recall = bench_ivf()
    extras["ivf_q8_ms"] = _dist_json(ivf_dist, 1e3)
    extras["ivf_recall_at_10"] = ivf_recall
    extras["dedup_ms"] = _dist_json(bench_dedup(), 1e3)
    d_bf16 = bench_embed(int8=False)
    d_int8 = bench_embed(int8=True)
    extras["embed_bf16_ms"] = _dist_json(d_bf16, 1e3)
    extras["embed_int8_ms"] = _dist_json(d_int8, 1e3)
    ips_bf16 = EMBED_BATCH / d_bf16["median"]
    ips_int8 = EMBED_BATCH / d_int8["median"]
    print(json.dumps({
        "metric": "vit_b32_embed_throughput",
        "value": max(ips_bf16, ips_int8),
        "unit": "images/sec",
        "bf16": ips_bf16,
        "int8": ips_int8,
        "trials": TRIALS,
        "device": device_record(),
        "card": card,
        **extras,
    }))


if __name__ == "__main__":
    main()
