"""Capacity planner (VERDICT r5 #5): residency arithmetic pinned to
measured index sizes, and the memory budget's source."""

import numpy as np
import pytest

from mmrs_tpu import plan as P

TEN_M, DIM = 10_000_000, 512


def test_flat_residency_pins():
    # 10M x 512 bf16 = 10.24 GB resident (measured, bench_stream.py)
    assert P.flat_resident_gb(TEN_M, DIM, "bf16") == pytest.approx(10.24)
    # int8 = rows * (dim + 4B scale); int4 packs two dims per byte
    assert P.flat_resident_gb(TEN_M, DIM, "int8") == pytest.approx(5.16)
    assert P.flat_resident_gb(TEN_M, DIM, "int4") == pytest.approx(2.60)
    # sharding divides rows per chip
    assert P.flat_resident_gb(TEN_M, DIM, "bf16", shards=8) == pytest.approx(
        10.24 / 8)


def test_ivf_residency_pins():
    # measured: bf16 C=4096 slots 1.25 spill 7.9% -> 14.2 GB
    got = P.ivf_resident_gb(TEN_M, DIM, "bf16", clusters=4096,
                            slots_frac=1.25, spill_frac=0.079)
    assert got == pytest.approx(14.2, rel=0.10)
    # measured: int8 same knobs -> 7.2 GB
    got = P.ivf_resident_gb(TEN_M, DIM, "int8", clusters=4096,
                            slots_frac=1.25, spill_frac=0.079)
    assert got == pytest.approx(7.2, rel=0.10)
    # measured: int8 slots 1.6 spill 2.4% -> 8.48 GB
    got = P.ivf_resident_gb(TEN_M, DIM, "int8", clusters=4096,
                            slots_frac=1.6, spill_frac=0.024)
    assert got == pytest.approx(8.48, rel=0.10)
    # measured OOM pin: bf16 slots 1.6 -> 16.4 GB buckets, over 16 GB
    got = P.ivf_resident_gb(TEN_M, DIM, "bf16", clusters=4096,
                            slots_frac=1.6, spill_frac=0.024)
    assert got > 16.0


def test_memory_budget_comes_from_the_device():
    class Dev:
        def memory_stats(self):
            return {"bytes_limit": 60_000_000_000, "bytes_in_use": 0}

    assert P.device_memory_gb(Dev()) == pytest.approx(60.0)

    class NoStats:
        def memory_stats(self):
            return None

    with pytest.raises(ValueError, match="hbm_gb"):
        P.device_memory_gb(NoStats())
    # an explicit budget never asks the device
    assert P.plan(1_000_000, DIM, hbm_gb=80.0).hbm_gb == 80.0


def test_plan_recommendations():
    # 1M x 512 fits everywhere -> bf16 flat (the rank-parity default)
    r = P.plan(1_000_000, DIM, hbm_gb=16.0)
    assert r.recommended is not None
    assert (r.recommended.quant, r.recommended.index) == ("bf16", "flat")

    # 10M fits bf16 flat on one 16 GB chip (10.24 < 14.4 budget)
    r = P.plan(TEN_M, DIM, hbm_gb=16.0)
    assert (r.recommended.quant, r.recommended.index) == ("bf16", "flat")

    # 40M x 512 = 41 GB bf16: single chip must drop down the ladder
    r = P.plan(40_000_000, DIM, hbm_gb=16.0)
    assert (r.recommended.quant, r.recommended.index) != ("bf16", "flat")
    assert r.recommended.fits
    assert r.min_chips_exact_bf16 == 3
    # ...and 8 chips restore exact bf16
    r8 = P.plan(40_000_000, DIM, chips=8, hbm_gb=16.0)
    assert (r8.recommended.quant, r8.recommended.index) == ("bf16", "flat")

    # 400M on one chip: nothing fits but the int4 rungs... not even those
    # at 512 dims (104 GB int4) -> planner says add chips
    r = P.plan(400_000_000, DIM, hbm_gb=16.0)
    assert r.recommended is None
    assert r.min_chips_exact_bf16 == 29


def test_render_mentions_cli_flags():
    txt = P.plan(40_000_000, DIM, hbm_gb=16.0).render()
    assert "--gallery-quant" in txt or "--ann-nprobe" in txt
    assert "GB/chip" in txt


def test_oom_hint_names_plan():
    msg = P.oom_hint(123, 45)
    assert "mmrs plan" in msg and "--rows 123" in msg


def test_engine_init_oom_references_plan(monkeypatch):
    """A RESOURCE_EXHAUSTED during engine init is re-raised pointing the
    user at `mmrs plan` (the VERDICT r5 #5 'discover OOM at init' fix)."""
    from mmrs_tpu.index.gallery import GalleryIndex
    from mmrs_tpu.search import engine as eng

    rng = np.random.default_rng(0)
    emb = rng.normal(size=(8, 16)).astype(np.float32)
    idx = GalleryIndex(embeddings=emb, paths=[f"p{i}" for i in range(8)],
                       classes=["c"] * 8)

    def boom(self, *a, **k):
        raise RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating "
                           "16384 bytes")

    monkeypatch.setattr(eng.SearchEngine, "_init", boom)
    with pytest.raises(RuntimeError, match="mmrs plan --rows 8 --dim 16"):
        eng.SearchEngine(idx)


def test_engine_still_constructs_and_queries():
    """The __init__ -> _init refactor keeps the engine functional."""
    from mmrs_tpu.index.gallery import GalleryIndex
    from mmrs_tpu.search.engine import SearchEngine

    rng = np.random.default_rng(1)
    emb = rng.normal(size=(32, 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    idx = GalleryIndex(embeddings=emb, paths=[f"p{i}" for i in range(32)],
                       classes=["c"] * 32)
    e = SearchEngine(idx)
    hits = e.query_vectors(emb[[5]], top_k=3)
    assert hits[0][0].path == "p5"
