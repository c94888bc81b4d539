"""End-to-end demo: the `code/search_image.py` flow on this framework.

Builds a synthetic color gallery, indexes it with a jitted ViT-B/32 tower
(random weights — swap in a converted checkpoint via Config for real use),
runs k-shot prototype search with every reference strategy, and calibrates
an F1-optimal threshold.

    python examples/search_demo.py [--root DIR]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def make_gallery(root: str) -> None:
    from PIL import Image

    rng = np.random.default_rng(0)
    for cls, color in [("lychee", (220, 40, 60)), ("guitar", (150, 100, 40)),
                       ("baozi", (240, 230, 210))]:
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for i in range(12):
            arr = np.clip(np.full((64, 64, 3), color, int)
                          + rng.integers(-25, 25, (64, 64, 3)), 0, 255)
            Image.fromarray(arr.astype(np.uint8)).save(
                os.path.join(root, cls, f"{cls}{i}.jpg"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    args = ap.parse_args()

    import jax.numpy as jnp

    from mmrs_tpu.config import Config
    from mmrs_tpu.index.gallery import build_index
    from mmrs_tpu.io.dataset import FolderDataset, few_shot_sample
    from mmrs_tpu.pipeline import build_towers
    from mmrs_tpu.search.calibrate import find_thresholds
    from mmrs_tpu.search.engine import SearchEngine

    workdir = args.root or tempfile.mkdtemp(prefix="mmrs_demo_")
    gallery_dir = os.path.join(workdir, "gallery")
    index_dir = os.path.join(workdir, "index")
    if not os.path.isdir(gallery_dir):
        make_gallery(gallery_dir)

    cfg = Config()
    towers = build_towers(cfg)
    print("indexing...")
    ds = FolderDataset.from_root(gallery_dir)
    idx = build_index(ds, towers.image_encode, index_dir, batch_size=16)
    print(f"indexed {len(idx)} images -> {index_dir}")

    engine = SearchEngine(idx, cfg.search)

    # k-shot prototype search, all four reference strategies
    shots = few_shot_sample(ds.samples, shots=4, seed=0)
    lychee_shots = [p for p, c in shots if c == "lychee"]
    rows = idx.rows_for_paths(lychee_shots)
    shot_embeds = jnp.asarray(np.asarray(idx.embeddings)[rows], jnp.float32)

    for strategy in ["mean", "image_text_mean", "cluster", "robust_mean"]:
        kwargs = {}
        if strategy == "image_text_mean":
            kwargs["text_embed"] = shot_embeds.mean(0)  # stand-in text embed
        hits = engine.query_prototype(shot_embeds, strategy=strategy,
                                      **kwargs)[0][:3]
        print(f"\n{strategy} top-3:")
        for h in hits:
            print(f"  {h.score:8.3f}  {h.cls:8s}  {os.path.basename(h.path)}")

    # threshold calibration for 'lychee'
    labels = np.asarray([c == "lychee" for c in idx.classes])
    proto = np.array(shot_embeds.mean(0))
    proto /= np.linalg.norm(proto)
    sims = engine.similarities(proto[None])[0]
    res = find_thresholds(sims[labels], sims[~labels])
    print(f"\ncalibrated lychee threshold: {res.best_threshold:.4f} "
          f"(F1 {res.best_f1:.4f}, P {res.best_precision:.4f}, "
          f"R {res.best_recall:.4f})")


if __name__ == "__main__":
    main()
