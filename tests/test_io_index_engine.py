"""End-to-end: synthetic image tree -> dataset -> index build -> search."""

import json
import os

import numpy as np
import pytest
import jax.numpy as jnp
from PIL import Image

from mmrs_tpu.index.gallery import GalleryIndex, build_index
from mmrs_tpu.io.dataset import FolderDataset, few_shot_sample, merge_class_map, scan_folder
from mmrs_tpu.io.images import load_image, pil_loader
from mmrs_tpu.ops.preprocess import CLIP_MEAN, CLIP_STD, normalize_images
from mmrs_tpu.search.engine import SearchEngine


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """3 classes x 4 images, each class a distinct solid color (so embeddings
    from a mean-pixel 'encoder' cluster by class), plus one corrupt file."""
    root = tmp_path_factory.mktemp("gallery")
    colors = {"red": (255, 0, 0), "green": (0, 255, 0), "blue": (0, 0, 255)}
    rng = np.random.default_rng(0)
    for cls, rgb in colors.items():
        d = root / cls
        d.mkdir()
        for i in range(4):
            arr = np.zeros((48, 64, 3), np.uint8)
            arr[..., :] = rgb
            noise = rng.integers(0, 30, arr.shape, dtype=np.uint8)
            arr = np.clip(arr.astype(int) + noise, 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(d / f"{cls}{i}.jpg", quality=95)
    (root / "red" / "broken.jpg").write_bytes(b"not an image at all")
    return str(root)


def _toy_encoder(pixels_u8: np.ndarray) -> np.ndarray:
    """Deterministic 'encoder': per-channel mean + constant pad -> L2 norm."""
    x = pixels_u8.astype(np.float32) / 255.0
    feats = x.mean(axis=(1, 2))                      # [B, 3]
    feats = np.concatenate([feats, np.full((len(feats), 5), 0.1, np.float32)], 1)
    return feats / np.linalg.norm(feats, axis=1, keepdims=True)


def test_scan_and_class_map(image_tree):
    samples = scan_folder(image_tree)
    assert len(samples) == 13  # 12 good + 1 corrupt
    classes = sorted({c for _, c in samples})
    assert classes == ["blue", "green", "red"]
    m = merge_class_map(classes, positives=["red"])
    assert m == {"red": "red", "green": "others", "blue": "others"}
    mb = merge_class_map(classes, positives=[], binary_positive="blue")
    assert mb == {"blue": "blue", "green": "not_blue", "red": "not_blue"}


def test_few_shot_sample_deterministic(image_tree):
    samples = scan_folder(image_tree)
    a = few_shot_sample(samples, shots=2, seed=7)
    b = few_shot_sample(samples, shots=2, seed=7)
    assert a == b
    per_class = {}
    for _, c in a:
        per_class[c] = per_class.get(c, 0) + 1
    assert all(v == 2 for v in per_class.values())


def test_load_image_quarantines_corrupt(image_tree):
    bad = os.path.join(image_tree, "red", "broken.jpg")
    r = load_image(bad)
    assert not r.ok and r.error is not None
    assert r.pixels.shape == (224, 224, 3) and (r.pixels == 0).all()


def test_transparency_composited_white(tmp_path):
    rgba = np.zeros((10, 10, 4), np.uint8)
    rgba[..., 3] = 0  # fully transparent
    p = tmp_path / "t.png"
    Image.fromarray(rgba, "RGBA").save(p)
    img = pil_loader(str(p))
    arr = np.asarray(img)
    assert (arr == 255).all()  # composited onto white


def test_normalize_images_matches_reference_constants():
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    out = np.asarray(
        normalize_images(jnp.asarray(u8), dtype=jnp.float32)
    )
    mean = np.asarray(CLIP_MEAN, np.float32)
    std = np.asarray(CLIP_STD, np.float32)
    expected = (u8.astype(np.float32) / 255.0 - mean) / std
    np.testing.assert_allclose(out, expected, atol=1e-5)


def test_build_index_and_search(image_tree, tmp_path):
    ds = FolderDataset.from_root(image_tree, image_size=32)
    out_dir = str(tmp_path / "idx")
    idx = build_index(ds, _toy_encoder, out_dir, batch_size=5, shard_rows=8)

    # corrupt image dropped
    assert len(idx) == 12
    assert not any("broken" in p for p in idx.paths)

    # multiple shards were written
    with open(os.path.join(out_dir, "manifest.json")) as f:
        man = json.load(f)
    assert len(man["shards"]) >= 2
    assert man["entries"] == 12

    # reload & search: a red query must return redNN paths first
    idx2 = GalleryIndex.load(out_dir)
    engine = SearchEngine(idx2)
    red = np.zeros((1, 32, 32, 3), np.uint8)
    red[..., 0] = 255
    qvec = _toy_encoder(red)
    hits = engine.query_image(jnp.asarray(qvec), top_k=4)[0]
    assert len(hits) == 4
    assert all(h.cls == "red" for h in hits)
    assert hits[0].score >= hits[-1].score


def test_multi_shard_consolidated_memmap(image_tree, tmp_path):
    ds = FolderDataset.from_root(image_tree, image_size=32)
    out_dir = str(tmp_path / "idx3")
    build_index(ds, _toy_encoder, out_dir, batch_size=5, shard_rows=4)

    idx = GalleryIndex.load(out_dir)                 # writes combined.npy
    assert os.path.exists(os.path.join(out_dir, "combined.npy"))
    assert isinstance(idx.embeddings, np.memmap)

    ref = GalleryIndex.load(out_dir, consolidate=False)
    np.testing.assert_array_equal(np.asarray(idx.embeddings),
                                  np.asarray(ref.embeddings))
    assert idx.paths == ref.paths

    # growing the index invalidates the consolidated file
    ds_bigger = FolderDataset(ds.samples + ds.samples[:2], image_size=32)
    build_index(ds_bigger, _toy_encoder, out_dir, batch_size=5, shard_rows=4)
    idx2 = GalleryIndex.load(out_dir)
    assert len(idx2) == 14
    assert idx2.embeddings.shape[0] == 14


def test_inplace_rebuild_invalidates_combined(image_tree, tmp_path):
    """Same row COUNT, different embeddings: an in-place rebuild (new
    checkpoint, --no-resume) must not serve the stale combined.npy
    (ADVICE r1 medium finding)."""
    ds = FolderDataset.from_root(image_tree, image_size=32)
    out_dir = str(tmp_path / "idx4")
    build_index(ds, _toy_encoder, out_dir, batch_size=5, shard_rows=4)
    GalleryIndex.load(out_dir)  # materializes combined.npy
    old = np.array(GalleryIndex.load(out_dir).embeddings)

    def scaled_encoder(pixels):
        return _toy_encoder(pixels) * np.float32(-1.0)

    build_index(ds, scaled_encoder, out_dir, batch_size=5, shard_rows=4,
                resume=False)
    new = np.array(GalleryIndex.load(out_dir).embeddings)
    assert new.shape == old.shape
    np.testing.assert_allclose(new, -old, atol=1e-6)


def test_index_resume(image_tree, tmp_path):
    ds = FolderDataset.from_root(image_tree, image_size=32)
    out_dir = str(tmp_path / "idx2")

    # First pass: only the first 8 samples (simulated interruption)
    partial = FolderDataset(ds.samples[:8], image_size=32)
    build_index(partial, _toy_encoder, out_dir, batch_size=4, shard_rows=4)

    # Resume with the full dataset: previously-complete shards are skipped
    idx = build_index(ds, _toy_encoder, out_dir, batch_size=4, shard_rows=4)
    assert len(idx) == 12
    assert len(set(idx.paths)) == 12  # no duplicated rows from the resume
