"""Hybrid cross-host x in-host mesh helpers (single-process degenerate forms on the
8-device CPU mesh; the host grouping itself needs real multiple processes)."""

import jax
import numpy as np
import pytest

from mmrs_tpu.config import MeshConfig
from mmrs_tpu.parallel.multihost import (
    distributed_init,
    make_hybrid_mesh,
    process_local_rows,
)
from mmrs_tpu.parallel.topk import sharded_cosine_topk


def test_distributed_init_single_process_noop():
    assert distributed_init() is False
    assert jax.process_count() == 1


def test_hybrid_mesh_single_process_matches_flat():
    mesh = make_hybrid_mesh(MeshConfig(model_size=2))
    assert mesh.shape == {"data": 4, "model": 2}
    mesh1 = make_hybrid_mesh(MeshConfig())
    assert mesh1.shape == {"data": 8, "model": 1}


def test_hybrid_mesh_validates_model_axis():
    with pytest.raises(ValueError, match="must divide local device count"):
        make_hybrid_mesh(MeshConfig(model_size=3))
    with pytest.raises(ValueError, match="data_size"):
        make_hybrid_mesh(MeshConfig(model_size=2, data_size=8))


def test_process_local_rows_covers_everything():
    mesh = make_hybrid_mesh(MeshConfig())
    a, b = process_local_rows(1000, mesh)
    # single process owns the whole data axis
    assert (a, b) == (0, 1000)


def test_sharded_topk_on_hybrid_mesh():
    """The sharded query path runs unchanged on a hybrid-constructed mesh."""
    mesh = make_hybrid_mesh(MeshConfig(model_size=1))
    rng = np.random.default_rng(0)
    g = rng.normal(size=(1000, 64)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = g[[3, 997]]
    vals, idxs = sharded_cosine_topk(q, g, k=5, mesh=mesh)
    assert list(np.asarray(idxs)[:, 0]) == [3, 997]


@pytest.mark.slow
def test_two_process_distributed_topk(tmp_path):
    """REAL multi-process jax.distributed (2 processes x 4 forced CPU
    devices, TCP coordinator): make_hybrid_mesh's cross-host x in-host grouping,
    disjoint per-process row loading via process_local_rows +
    place_global_rows, and a cross-process sharded top-k that matches the
    numpy oracle (VERDICT r2 Next #4 — no pod required)."""
    import json
    import os
    import socket
    import subprocess
    import sys

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    coord = f"127.0.0.1:{port}"

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        # the worker imports mmrs_tpu by path, not install: script-based
        # python puts tests/ (not cwd) on sys.path, so be explicit
        "PYTHONPATH": repo_root + os.pathsep + env.get("PYTHONPATH", ""),
    })
    worker = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")
    outs = [str(tmp_path / f"out{i}.json") for i in range(2)]
    procs = [
        subprocess.Popen([sys.executable, worker, coord, "2", str(i), outs[i]],
                         env=env)
        for i in range(2)
    ]
    for p in procs:
        assert p.wait(timeout=240) == 0
    r0, r1 = (json.load(open(o)) for o in outs)

    # documented grouping: data axis = 4 (2 procs x 2 local), model = 2
    assert r0["mesh_shape"] == {"data": 4, "model": 2}
    # every model-axis row lives inside ONE process (TP stays inside the host) and
    # the data axis is host-major: process 0 owns data rows 0-1, then 1
    assert r0["proc_grid"] == [[0, 0], [0, 0], [1, 1], [1, 1]]
    assert r0["proc_grid"] == r1["proc_grid"]

    # per-process row loading is disjoint and covers everything
    assert r0["local_rows"] == [0, 500] and r1["local_rows"] == [500, 1000]

    # the sharded top-k is replicated: both processes agree, and match the
    # single-process numpy oracle
    assert r0["idxs"] == r1["idxs"] and r0["vals"] == r1["vals"]
    rng = np.random.default_rng(0)
    g = rng.normal(size=(1000, 32)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    scores = g[[3, 500, 997]] @ g.T
    oracle = np.argsort(-scores, axis=1)[:, :5]
    assert np.array_equal(np.asarray(r0["idxs"]), oracle)

    # the slot-sharded IVF across processes at nprobe == C is exact:
    # same oracle, replicated-identical on both processes
    assert r0["ivf_idxs"] == r1["ivf_idxs"]
    assert np.array_equal(np.asarray(r0["ivf_idxs"]), oracle)

    # the dedup ring across hosts reproduces the keep-first numpy oracle
    # and is replicated-identical across processes
    assert r0["dedup_first"] == r1["dedup_first"]
    np.testing.assert_array_equal(np.asarray(r0["dedup_first"]),
                                  _dedup_oracle())

    # the cross-process DP x TP decode (batch over the cross-host data axis,
    # Megatron TP inside each host) is replicated-identical
    # across processes and token-exact vs the single-process decode
    assert r0["decode"] == r1["decode"]
    np.testing.assert_array_equal(np.asarray(r0["decode"]),
                                  _decode_oracle())


def _spawn_workers(tmp_path, nproc: int, local_devices: int,
                   model_size: int):
    """Launch nproc coordinated jax.distributed worker processes on the
    CPU backend and return their parsed JSON results."""
    import json
    import os
    import socket
    import subprocess
    import sys

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    coord = f"127.0.0.1:{port}"

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS":
            f"--xla_force_host_platform_device_count={local_devices}",
        "PYTHONPATH": repo_root + os.pathsep + env.get("PYTHONPATH", ""),
    })
    worker = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")
    outs = [str(tmp_path / f"out{i}.json") for i in range(nproc)]
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, str(nproc), str(i), outs[i],
             str(local_devices), str(model_size)], env=env)
        for i in range(nproc)
    ]
    rcs = [p.wait(timeout=420) for p in procs]
    assert rcs == [0] * nproc, rcs
    return [json.load(open(o)) for o in outs]


def _dedup_oracle():
    """Numpy keep-first first-match on the worker's planted-dup corpus."""
    rng_d = np.random.default_rng(7)
    xd = rng_d.normal(size=(96, 16)).astype(np.float32)
    xd[41] = xd[3] + 1e-4 * rng_d.normal(size=16).astype(np.float32)
    xd[77] = xd[3] + 1e-4 * rng_d.normal(size=16).astype(np.float32)
    xd[90] = xd[58]
    xd /= np.linalg.norm(xd, axis=1, keepdims=True)
    sims = xd @ xd.T
    out = np.full(96, -1, np.int64)
    for i in range(96):
        js = np.flatnonzero(sims[i, :i] >= 0.999)
        if js.size:
            out[i] = js[0]
    return out


def _decode_oracle():
    import jax.numpy as jnp

    from mmrs_tpu.models import llama
    from mmrs_tpu.models.llama import LlamaConfig

    lcfg = LlamaConfig(vocab_size=96, dim=64, layers=2, heads=4,
                       kv_heads=2, mlp_dim=128, max_seq=64)
    params = llama.init(jax.random.key(3), lcfg)
    prompt = jnp.asarray(np.random.default_rng(4).integers(3, 90, (4, 5)),
                         jnp.int32)
    return np.asarray(llama.greedy_generate(
        params, llama.embed_tokens(params, prompt), lcfg,
        max_new_tokens=6, eos_token=-1, compute_dtype=jnp.float32))


@pytest.mark.slow
def test_four_process_distributed(tmp_path):
    """The remaining pod rehearsal shape (VERDICT r5 #7): 4 coordinated
    processes x 2 forced CPU devices each — model axis (TP=2) fills each
    host, so the ENTIRE data axis (4) spans hosts. Covers the
    slot-sharded IVF, the dedup ring, sharded top-k, and DP x TP decode,
    all asserted oracle-exact and replicated-identical at 4 processes."""
    rs = _spawn_workers(tmp_path, nproc=4, local_devices=2, model_size=2)
    r0 = rs[0]

    assert r0["mesh_shape"] == {"data": 4, "model": 2}
    # TP never crosses a process; each data row is one whole process
    assert r0["proc_grid"] == [[0, 0], [1, 1], [2, 2], [3, 3]]
    # disjoint per-process row loading covers 0..1000
    assert [r["local_rows"] for r in rs] == [
        [0, 250], [250, 500], [500, 750], [750, 1000]]

    for r in rs[1:]:
        assert r["proc_grid"] == r0["proc_grid"]
        assert r["idxs"] == r0["idxs"] and r["vals"] == r0["vals"]
        assert r["ivf_idxs"] == r0["ivf_idxs"]
        assert r["dedup_first"] == r0["dedup_first"]
        assert r["decode"] == r0["decode"]

    rng = np.random.default_rng(0)
    g = rng.normal(size=(1000, 32)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    oracle = np.argsort(-(g[[3, 500, 997]] @ g.T), axis=1)[:, :5]
    assert np.array_equal(np.asarray(r0["idxs"]), oracle)
    assert np.array_equal(np.asarray(r0["ivf_idxs"]), oracle)
    np.testing.assert_array_equal(np.asarray(r0["dedup_first"]),
                                  _dedup_oracle())
    np.testing.assert_array_equal(np.asarray(r0["decode"]),
                                  _decode_oracle())


def test_place_global_rows_single_process_matches_place_gallery():
    """Degenerate single-process form: the per-host loader produces the
    same padded row-sharded layout as parallel.topk.place_gallery."""
    import jax.numpy as jnp

    from mmrs_tpu.parallel.multihost import place_global_rows
    from mmrs_tpu.parallel.topk import place_gallery

    mesh = make_hybrid_mesh(MeshConfig())
    rng = np.random.default_rng(1)
    g = rng.normal(size=(1001, 16)).astype(np.float32)  # ragged tail
    a = place_global_rows(g, 1001, mesh)
    b = place_gallery(jnp.asarray(g), mesh)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_search_hp_on_mesh_matches_single_device():
    """Tip-Adapter HP sweep sharded over the data axis == local sweep."""
    import jax.numpy as jnp

    from mmrs_tpu.adapt.tip_adapter import search_hp
    from mmrs_tpu.config import MeshConfig

    rng = np.random.default_rng(3)
    n, d, c, nk = 64, 16, 4, 20
    feats = rng.normal(size=(n, d)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    keys = rng.normal(size=(nk, d)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    values = np.eye(c, dtype=np.float32)[rng.integers(0, c, nk)]
    cw = rng.normal(size=(d, c)).astype(np.float32)
    cw /= np.linalg.norm(cw, axis=0, keepdims=True)
    labels = rng.integers(0, c, n)

    ref = search_hp(jnp.asarray(feats), jnp.asarray(keys), jnp.asarray(values),
                    jnp.asarray(cw), labels, c, search_step=(50, 10))
    mesh = make_hybrid_mesh(MeshConfig())
    out = search_hp(jnp.asarray(feats), jnp.asarray(keys), jnp.asarray(values),
                    jnp.asarray(cw), labels, c, search_step=(50, 10),
                    mesh=mesh)
    np.testing.assert_allclose(out.grid, ref.grid, rtol=1e-5, atol=1e-6)
    assert (out.beta, out.alpha) == (ref.beta, ref.alpha)
    # non-divisible beta count exercises the pad path (50 % 8 != 0)
    assert out.grid.shape == (50, 10)


def test_place_global_rows_small_awkward_n():
    """n small enough to leave trailing data-axis shards entirely empty
    must still place (review repro: n=9/n=5 on 8 shards raised
    ValueError when padding stopped short of the addressable extent)."""
    import numpy as np
    from mmrs_tpu.parallel.multihost import (make_hybrid_mesh,
                                             place_global_rows,
                                             process_local_rows)

    mesh = make_hybrid_mesh()
    for n in (9, 5, 1, 8, 16):
        lo, hi = process_local_rows(n, mesh)
        assert 0 <= lo <= hi <= n
        g = np.arange((hi - lo) * 4, dtype=np.float32).reshape(hi - lo, 4)
        a = place_global_rows(g, n, mesh)
        got = np.asarray(a)[:n]
        np.testing.assert_array_equal(got[lo:hi], g)
