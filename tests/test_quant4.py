"""Int4 packed gallery (ops/quant4.py): packing semantics, kernel vs
oracle exactness, recall vs f32, and engine integration."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mmrs_tpu.config import SearchConfig
from mmrs_tpu.index.gallery import GalleryIndex
from mmrs_tpu.ops.quant4 import (
    cosine_topk_int4,
    quantize_rows_int4,
    similarities_int4,
    _unpack_planes_xla,
)
from mmrs_tpu.ops.topk import cosine_topk
from mmrs_tpu.search.engine import SearchEngine


def _unit_rows(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_pack_roundtrip_semantics():
    """The masked planes reconstruct the int4 codes exactly: lo plane is
    code+8, hi plane is 16*code."""
    g = _unit_rows(64, 32)
    packed, scales = quantize_rows_int4(jnp.asarray(g))
    assert packed.shape == (4, 64) and packed.dtype == jnp.int32
    lo, hi = _unpack_planes_xla(packed)
    lo = np.asarray(lo, np.int32)        # [D/2, N] = code_lo + 8
    hi = np.asarray(hi, np.int32)        # [D/2, N] = 16 * code_hi
    codes = np.round(g / np.asarray(scales)[:, None]).clip(-7, 7)
    np.testing.assert_array_equal(lo, codes[:, :16].T.astype(np.int32) + 8)
    np.testing.assert_array_equal(hi, 16 * codes[:, 16:].T.astype(np.int32))
    # dequantized reconstruction within half a quantization step
    deq = codes * np.asarray(scales)[:, None]
    step = np.asarray(scales)[:, None]
    assert np.all(np.abs(deq - g) <= 0.5 * step + 1e-7)


def test_scores_close_to_f32():
    g = _unit_rows(256, 512, seed=1)
    q = _unit_rows(8, 512, seed=2)
    packed, scales = quantize_rows_int4(jnp.asarray(g))
    sims = np.asarray(similarities_int4(jnp.asarray(q), packed, scales))
    want = q @ g.T
    # int4 per-dim error is ~(max/7)/sqrt(12) -> cosine error std ~0.006
    # at D=512 (per-row scales, unit vectors); bound rms and 5-sigma max
    err = np.abs(sims - want)
    assert np.sqrt((err ** 2).mean()) < 0.012
    assert err.max() < 0.04


def test_recall_vs_f32_oracle():
    """Recall@10 against the exact f32 scan with realistic neighbor
    geometry (bench_ivf convention: true neighbors sit sigma~1/sqrt(D)
    from the query, the rest are iid background). Pure-iid galleries are
    the degenerate near-tie case — int4 measures ~0.80 there, which is a
    property of the data (every score within quantization noise of every
    other), not of the index."""
    rng = np.random.default_rng(5)
    d, n_q, per_q, n_bg = 512, 16, 12, 3000
    queries = _unit_rows(n_q, d, seed=6)
    planted = [
        queries[i][None, :]
        + rng.normal(size=(per_q, d)).astype(np.float32) / np.sqrt(d)
        for i in range(n_q)
    ]
    g = np.concatenate(planted + [_unit_rows(n_bg, d, seed=7)])
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    packed, scales = quantize_rows_int4(jnp.asarray(g))
    _, idx4 = cosine_topk_int4(jnp.asarray(queries), packed, scales, k=10)
    _, idxf = cosine_topk(jnp.asarray(queries), jnp.asarray(g), k=10,
                          impl="xla")
    idx4, idxf = np.asarray(idx4), np.asarray(idxf)
    recall = np.mean([
        len(set(idx4[i]) & set(idxf[i])) / 10 for i in range(n_q)
    ])
    assert recall >= 0.95, recall
    # top-1 identity is meaningless under near-exact ties (planted
    # neighbors sit within ~0.01 cosine of each other); the meaningful
    # claim is zero score REGRET: the row int4 returns first scores
    # within quantization noise of the true best row.
    want = queries @ g.T
    regret = np.max(want[np.arange(n_q), idxf[:, 0]]
                    - want[np.arange(n_q), idx4[:, 0]])
    assert regret < 0.03, regret


def test_bad_dim_rejected():
    with pytest.raises(ValueError, match="multiple of 8"):
        quantize_rows_int4(jnp.zeros((4, 12)))


def _make_index(n=512, d=32, seed=0):
    emb = _unit_rows(n, d, seed)
    return GalleryIndex(emb, [f"img{i}.jpg" for i in range(n)],
                        [f"c{i % 4}" for i in range(n)])


def test_engine_int4_mode():
    idx = _make_index(seed=7)
    eng = SearchEngine(idx, SearchConfig(), device_dtype=jnp.float32,
                       quantize="int4")
    assert eng.quantized == "int4"
    assert eng.gallery.dtype == jnp.int32
    q = jnp.asarray(np.asarray(idx.embeddings)[[3]])
    hits = eng.query_vectors(q, top_k=3)[0]
    assert hits[0].path == "img3.jpg"
    assert hits[0].score == pytest.approx(100.0, abs=2.0)
    # device_similarities serves the calibration path
    sims = np.asarray(eng.device_similarities(q))
    assert sims.shape == (1, len(idx))
    assert abs(sims[0, 3] - 1.0) < 0.03


def test_engine_int4_guards():
    idx = _make_index()
    with pytest.raises(ValueError, match="quantize"):
        SearchEngine(idx, SearchConfig(), quantize="int2")


def test_engine_int4_mesh_matches_single():
    """quantize='int4' + mesh: the sharded packed scan + candidate merge
    returns the single-device int4 engine's hits exactly (VERDICT r3 #6 —
    the capacity ladder's top rung composes with the mesh). Ragged N
    exercises the pad-to-shard-multiple path."""
    from mmrs_tpu.config import MeshConfig
    from mmrs_tpu.parallel import make_mesh

    idx = _make_index(n=1001, d=64, seed=11)
    single = SearchEngine(idx, SearchConfig(), device_dtype=jnp.float32,
                          quantize="int4")
    mesh = make_mesh(MeshConfig())
    sharded = SearchEngine(idx, SearchConfig(), mesh=mesh,
                           device_dtype=jnp.float32, quantize="int4")
    assert sharded.gallery.shape[1] % mesh.shape["data"] == 0
    q = jnp.asarray(np.asarray(idx.embeddings)[[3, 1000, 500]])
    h1 = single.query_vectors(q, top_k=5)
    h2 = sharded.query_vectors(q, top_k=5)
    for a, b in zip(h1, h2):
        assert [x.path for x in a] == [x.path for x in b]
        for x, y in zip(a, b):
            assert x.score == pytest.approx(y.score, abs=1e-3)
    assert h2[0][0].path == "img3.jpg"
    assert h2[1][0].path == "img1000.jpg"  # tail row survives padding


def test_sharded_similarities_int4_matches_single():
    """The calibration path on the int4+mesh engine: device_similarities
    equals the single-device int4 similarities row-for-row."""
    from mmrs_tpu.config import MeshConfig
    from mmrs_tpu.parallel import make_mesh

    idx = _make_index(n=500, d=64, seed=12)
    q = jnp.asarray(_unit_rows(4, 64, seed=13))
    single = SearchEngine(idx, SearchConfig(), device_dtype=jnp.float32,
                          quantize="int4")
    mesh = make_mesh(MeshConfig())
    sharded = SearchEngine(idx, SearchConfig(), mesh=mesh,
                           device_dtype=jnp.float32, quantize="int4")
    np.testing.assert_allclose(np.asarray(single.device_similarities(q)),
                               np.asarray(sharded.device_similarities(q)),
                               atol=1e-6)


def test_chunked_quantize_init_matches_full():
    """Engine init quantizes chunk-by-chunk (peak HBM = packed + one chunk,
    ADVICE r3); numerics must equal the one-shot full-array quantize for
    both rungs, including the L2-normalize of unnormalized inputs."""
    from mmrs_tpu.ops.normalize import l2_normalize
    from mmrs_tpu.ops.quant import quantize_rows
    from mmrs_tpu.search.engine import _quantize_gallery_chunked

    rng = np.random.default_rng(14)
    emb = rng.normal(size=(333, 32)).astype(np.float32) * 1.7
    norm = l2_normalize(jnp.asarray(emb))

    g8, s8 = _quantize_gallery_chunked(emb, jnp.float32, "int8", chunk=128)
    w8, x8 = quantize_rows(norm)
    np.testing.assert_array_equal(np.asarray(g8), np.asarray(w8))
    np.testing.assert_allclose(np.asarray(s8), np.asarray(x8), atol=1e-7)

    g4, s4 = _quantize_gallery_chunked(emb, jnp.float32, "int4", chunk=128)
    w4, x4 = quantize_rows_int4(norm)
    np.testing.assert_array_equal(np.asarray(g4), np.asarray(w4))
    np.testing.assert_allclose(np.asarray(s4), np.asarray(x4), atol=1e-7)


def test_engine_bool_backcompat():
    idx = _make_index(seed=8)
    eng = SearchEngine(idx, SearchConfig(), device_dtype=jnp.float32,
                       quantize=True)
    assert eng.quantized == "int8"
    hits = eng.query_vectors(
        jnp.asarray(np.asarray(idx.embeddings)[[5]]), top_k=1)[0]
    assert hits[0].path == "img5.jpg"
