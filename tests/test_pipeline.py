"""pipeline.build_towers: checkpoint round-trip and tokenizer wiring."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mmrs_tpu.config import Config, ModelConfig
from mmrs_tpu.models import checkpoint
from mmrs_tpu.pipeline import build_towers


def test_checkpoint_roundtrip_through_pipeline(tmp_path):
    """Random towers saved to npz then reloaded must encode identically."""
    cfg = Config(model=ModelConfig(image_tower="vit_tiny", dtype="float32"))
    towers = build_towers(cfg)
    ckpt = str(tmp_path / "clip.npz")
    checkpoint.save_npz(towers.params, ckpt)

    cfg2 = Config(model=ModelConfig(image_tower="vit_tiny", dtype="float32", checkpoint_path=ckpt))
    towers2 = build_towers(cfg2)

    img = np.random.default_rng(0).integers(0, 255, (2, 224, 224, 3),
                                            dtype=np.uint8)
    np.testing.assert_allclose(towers.image_encode(img),
                               towers2.image_encode(img), atol=1e-5)


def test_text_encode_clip_tokenizer():
    from mmrs_tpu.models.tokenizer import CLIPTokenizer

    tok = CLIPTokenizer.synthetic(["photo", "cat"], context_length=77)
    cfg = Config(model=ModelConfig(image_tower="vit_tiny", dtype="float32"))
    towers = build_towers(cfg, tokenizer=tok)
    out = towers.text_encode(["a photo of a cat", "a cat"])
    assert out.shape == (2, 64)
    assert np.isfinite(out).all()


@pytest.mark.slow
def test_cli_text_search(tmp_path):
    """mmrs search --text with a synthetic merges file end-to-end."""
    from PIL import Image

    from mmrs_tpu.models.tokenizer import CLIPTokenizer

    root = tmp_path / "g"
    (root / "cat").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
                        ).save(root / "cat" / f"c{i}.jpg")

    # synthetic merges file in the standard layout
    ours = CLIPTokenizer.synthetic(["photo", "cat"])
    merges = tmp_path / "merges.txt"
    with open(merges, "w") as f:
        f.write("#version: 0.2\n")
        for pair, _ in sorted(ours.bpe_ranks.items(), key=lambda kv: kv[1]):
            f.write(" ".join(pair) + "\n")
        # pad so from_file's fixed slice bound is harmless
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu",
                "XLA_FLAGS": "--xla_force_host_platform_device_count=1"})

    cfgp = str(tmp_path / "tiny.yaml")
    open(cfgp, "w").write("model:\n  image_tower: vit_tiny\n  dtype: float32\n")
    out = str(tmp_path / "idx")
    r = subprocess.run([sys.executable, "-m", "mmrs_tpu.cli.main", "index",
                        "build", "--root", str(root), "--out", out,
                        "--config", cfgp],
                       capture_output=True, text=True, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    r = subprocess.run([sys.executable, "-m", "mmrs_tpu.cli.main", "search",
                        "--index", out, "--text", "a photo of a cat",
                        "--merges", str(merges), "-k", "2",
                        "--config", cfgp],
                       capture_output=True, text=True, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [l.split("\t") for l in r.stdout.strip().splitlines()]
    assert len(rows) == 2 and rows[0][3] == "cat"
