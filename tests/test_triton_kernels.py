"""The GPU kernels (Pallas through Triton) in interpret mode against their
plain references: the two-pass top-k scan (bf16 / f32 / int8 galleries),
the all-pairs first-match and the IVF bucket probe. Shapes are chosen to
hit the wrappers' edges: ragged N, Q off the query block, k near the tile,
D off the chunk, int8 scales, nonzero keep-first offsets, -1 bucket slots
and empty probed buckets."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mmrs_tpu.index.ivf import _probe_buckets_pallas, _probe_buckets_xla
from mmrs_tpu.ops.allpairs import (_first_match_blocked_xla,
                                   _first_match_pallas, _first_match_xla)
from mmrs_tpu.ops.quant import (_topk_quant_xla, cosine_topk_quantized,
                                quantize_rows)
from mmrs_tpu.ops.topk import (_cosine_topk_xla, candidate_width,
                               scan_topk_pallas, tile_topk)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("q,n,d,k,tile_n,dtype", [
    (3, 1000, 64, 10, 128, jnp.bfloat16),    # ragged N
    (17, 513, 64, 5, 64, jnp.bfloat16),      # Q off the block, N = 8*64+1
    (70, 600, 32, 4, 128, jnp.float32),      # two query blocks, f32 gallery
    (2, 300, 100, 15, 16, jnp.float32),      # k near the tile, D off chunk
    (1, 40, 16, 40, 32, jnp.float32),        # k == N
])
def test_scan_topk_matches_oracle(q, n, d, k, tile_n, dtype):
    rng = np.random.default_rng(q * 1000 + n)
    queries = jnp.asarray(_unit(rng, q, d), dtype)
    gallery = jnp.asarray(_unit(rng, n, d), dtype)
    v, i = scan_topk_pallas(queries, gallery, k, tile_n=tile_n,
                            interpret=True)
    rv, ri = _cosine_topk_xla(queries, gallery, k)
    np.testing.assert_allclose(np.asarray(v), np.asarray(rv), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ri))


@pytest.mark.parametrize("q,n,d,tile_n", [(5, 777, 64, 128), (33, 200, 48, 32)])
def test_scan_topk_int8_scales_match_oracle(q, n, d, tile_n):
    rng = np.random.default_rng(n)
    queries = jnp.asarray(_unit(rng, q, d))
    # rows of different norms give different per-row scales
    g = _unit(rng, n, d) * rng.uniform(0.2, 3.0, (n, 1)).astype(np.float32)
    gq, gs = quantize_rows(jnp.asarray(g))
    v, i = cosine_topk_quantized(queries, gq, gs, 7, impl="pallas_interpret",
                                 tile_n=tile_n)
    q_q, q_s = quantize_rows(queries)
    rv, ri = _topk_quant_xla(q_q, q_s, gq, gs, 7)
    np.testing.assert_array_equal(np.asarray(v), np.asarray(rv))
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ri))


def test_scan_topk_ties_keep_lowest_row():
    """Equal scores across and within tiles come out lowest row first, as
    lax.top_k over the whole score row orders them."""
    d = 16
    base = np.zeros((1, d), np.float32)
    base[0, 0] = 1.0
    g = np.zeros((200, d), np.float32)
    g[:, 1] = 1.0
    for r in (5, 37, 38, 150):          # four exact duplicates of the query
        g[r] = base[0]
    v, i = scan_topk_pallas(jnp.asarray(base), jnp.asarray(g), 6, tile_n=32,
                            interpret=True)
    assert np.asarray(i)[0].tolist()[:4] == [5, 37, 38, 150]
    rv, ri = _cosine_topk_xla(jnp.asarray(base), jnp.asarray(g), 6)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ri))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_tile_topk_plain_xla(k):
    """The in-kernel selection, run as plain XLA, against lax.top_k."""
    rng = np.random.default_rng(k)
    vals = jnp.asarray(rng.standard_normal((4, 64)).astype(np.float32))
    kp = candidate_width(k)
    v, i = tile_topk(vals, k, kp, base=100)
    rv, ri = jax.lax.top_k(vals, k)
    np.testing.assert_array_equal(np.asarray(v)[:, :k], np.asarray(rv))
    np.testing.assert_array_equal(np.asarray(i)[:, :k], np.asarray(ri) + 100)
    assert (np.asarray(v)[:, k:] == -np.inf).all()
    assert (np.asarray(i)[:, k:] == -1).all()


def _with_dups(rng, n, d, pairs):
    x = _unit(rng, n, d)
    for dst, src in pairs:
        x[dst] = x[src]
    return x


@pytest.mark.parametrize("n,m,d,tile,row_off,col_off", [
    (300, 300, 64, 64, 0, 0),       # intra, ragged vs the tile
    (130, 250, 40, 32, 500, 0),     # shard offsets: rows after the cols
    (130, 250, 40, 32, 0, 90),      # cols shifted into the rows' range
    (64, 64, 16, 64, 37, 11),       # one tile each way
])
def test_first_match_intra_offsets_match_oracle(n, m, d, tile, row_off,
                                                col_off):
    rng = np.random.default_rng(n + m + row_off)
    a = _with_dups(rng, n, d, [(n - 1, 3), (n // 2, 1)])
    b = np.concatenate([a[: min(n, m)], _unit(rng, max(0, m - n), d)])[:m]
    got = _first_match_pallas(jnp.asarray(a), jnp.asarray(b), 0.95, True,
                              row_off, col_off, tile=tile, interpret=True)
    ref = _first_match_xla(jnp.asarray(a), jnp.asarray(b), 0.95, True,
                           row_off, col_off)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_first_match_cross_set_matches_oracle(dtype):
    rng = np.random.default_rng(7)
    test_set = _unit(rng, 70, 48)
    train = _unit(rng, 210, 48)
    train[[4, 99, 209]] = test_set[[60, 2, 2]]
    a, b = jnp.asarray(train, dtype), jnp.asarray(test_set, dtype)
    got = _first_match_pallas(a, b, 0.98, False, tile=32, interpret=True)
    ref = _first_match_xla(a, b, 0.98, False)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    assert np.asarray(got)[[4, 99, 209]].tolist() == [60, 2, 2]


@pytest.mark.parametrize("m,block,intra", [
    (500, 128, True), (500, 500, True), (257, 64, False), (100, 1000, True),
])
def test_first_match_blocked_xla_matches_untiled(m, block, intra):
    """The column-blocked XLA form equals the untiled oracle, ragged last
    block included."""
    rng = np.random.default_rng(m + block)
    b = _with_dups(rng, m, 32, [(m - 1, 0), (m // 2, m // 3)])
    a = b if intra else _unit(rng, 90, 32)
    if not intra:
        a[10] = b[m - 2]
    got = _first_match_blocked_xla(jnp.asarray(a), jnp.asarray(b), 0.97,
                                   intra, 0, 0, block=block)
    ref = _first_match_xla(jnp.asarray(a), jnp.asarray(b), 0.97, intra)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _buckets(rng, c, cap, dp, dtype, holes):
    rows = _unit(rng, c * cap, dp).reshape(c, cap, dp)
    ids = np.arange(c * cap, dtype=np.int32).reshape(c, cap)
    for cc, start in holes:            # -1 slots from `start` on
        ids[cc, start:] = -1
        rows[cc, start:] = 0
    return jnp.asarray(rows, dtype), jnp.asarray(ids)


@pytest.mark.parametrize("cap,tile_r,dp,k,quant", [
    (40, 16, 64, 5, False),     # cap off the row tile
    (128, 128, 128, 10, False),
    (33, 32, 64, 16, True),     # int8 rows with per-slot scales
    (8, 16, 32, 20, False),     # fewer probed slots than k: -1 padding
])
def test_ivf_probe_matches_oracle(cap, tile_r, dp, k, quant):
    rng = np.random.default_rng(cap + dp)
    c, qn, p = 6, 5, 3
    # bucket 2 is empty, bucket 4 half full
    rows, ids = _buckets(rng, c, cap, dp, jnp.float32,
                         holes=[(2, 0), (4, cap // 2)])
    scales = None
    if quant:
        rq, s = quantize_rows(rows.reshape(c * cap, dp))
        rows, scales = rq.reshape(c, cap, dp), s.reshape(c, cap)
    q = jnp.asarray(_unit(rng, qn, dp), jnp.bfloat16 if quant else
                    jnp.float32)
    probe = jnp.asarray(np.stack([rng.permutation(c)[:p] for _ in range(qn)])
                        .astype(np.int32))
    probe = probe.at[0].set(jnp.asarray([2, 4, 0], jnp.int32))
    got_v, got_i = _probe_buckets_pallas(q, probe, rows, ids, scales, k,
                                         tile_r=tile_r, interpret=True)
    ref_v, ref_i = _probe_buckets_xla(q, probe, rows, ids, scales, k)
    np.testing.assert_allclose(np.asarray(got_v), np.asarray(ref_v),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got_i), np.asarray(ref_i))
