"""`mmrs index build --sharded` over the 8-device CPU mesh matches unsharded."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_gallery")
    rng = np.random.default_rng(0)
    d = root / "cls"
    d.mkdir()
    for i in range(9):
        arr = rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)
        Image.fromarray(arr).save(d / f"img{i}.jpg")
    return str(root)


def _run(args, extra_env=None):
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
    })
    if extra_env:
        env.update(extra_env)
    return subprocess.run([sys.executable, "-m", "mmrs_tpu.cli.main"] + args,
                          capture_output=True, text=True, env=env)


@pytest.mark.slow
def test_sharded_index_build_matches(tree, tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("model:\n  image_tower: vit_tiny\n  dtype: float32\n"
                   "gallery:\n  batch_size: 8\n")

    out_a = str(tmp_path / "idx_plain")
    out_b = str(tmp_path / "idx_sharded")
    r = _run(["index", "build", "--root", tree, "--out", out_a,
              "--config", str(cfg)])
    assert r.returncode == 0, r.stderr[-2000:]
    r = _run(["index", "build", "--root", tree, "--out", out_b,
              "--config", str(cfg), "--sharded"])
    assert r.returncode == 0, r.stderr[-2000:]

    from mmrs_tpu.index.gallery import GalleryIndex

    a = GalleryIndex.load(out_a)
    b = GalleryIndex.load(out_b)
    assert a.paths == b.paths
    np.testing.assert_allclose(np.asarray(a.embeddings),
                               np.asarray(b.embeddings), atol=2e-3)
