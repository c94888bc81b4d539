"""Worker for test_multihost.py's real multi-process rehearsals.

Runs as one of N coordinated processes (jax.distributed over TCP on the
CPU backend, `local_devices` forced host devices each): builds the hybrid
cross-host x in-host mesh, loads only ITS process-local gallery rows, and answers a
sharded top-k, a slot-sharded IVF probe, a dedup ring pass, and a DP x TP
decode. Results are written as JSON for the parent test to cross-check
against the single-process numpy oracle.

argv: coord nproc pid out_path [local_devices=4] [model_size=2]
"""

import json
import sys


def main() -> None:
    coord, nproc, pid, out_path = sys.argv[1:5]
    local_devices = int(sys.argv[5]) if len(sys.argv) > 5 else 4
    model_size = int(sys.argv[6]) if len(sys.argv) > 6 else 2

    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from mmrs_tpu.config import MeshConfig
    from mmrs_tpu.parallel.multihost import (
        distributed_init,
        make_hybrid_mesh,
        place_global_rows,
        process_local_rows,
    )
    from mmrs_tpu.parallel.topk import sharded_cosine_topk

    assert distributed_init(coord, int(nproc), int(pid)) is True
    assert jax.process_count() == int(nproc)
    assert jax.local_device_count() == local_devices

    mesh = make_hybrid_mesh(MeshConfig(model_size=model_size))
    dev = np.asarray(mesh.devices)                    # [data, model]
    proc_grid = [[int(d.process_index) for d in row] for row in dev]

    n, dim = 1000, 32
    lo, hi = process_local_rows(n, mesh)
    # deterministic global gallery: every process generates the same
    # values but PLACES only its own row range
    rng = np.random.default_rng(0)
    g = rng.normal(size=(n, dim)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = g[[3, 500, 997]]

    garr = place_global_rows(g[lo:hi], n, mesh)
    vals, idxs = sharded_cosine_topk(q, garr, k=5, mesh=mesh, n_valid=n)

    # slot-sharded IVF across processes: buckets strip over the
    # host-spanning data axis (replicated over model), probed at
    # nprobe == C — exact by contract, so ids must match the same
    # brute-force oracle the flat path was checked against
    from mmrs_tpu.index.ivf import build_ivf
    from mmrs_tpu.parallel.ivf import place_ivf, sharded_ivf_topk

    ivf = place_ivf(build_ivf(g, n_clusters=8, iters=3, seed=1,
                              dtype=np.float32), mesh)
    _, ivf_idxs = sharded_ivf_topk(np.asarray(q), ivf, k=5, nprobe=8,
                                   mesh=mesh, impl="xla")

    # dedup ring across hosts: keep-first first-match over row shards that
    # ppermute around the data axis (planted near-duplicates at known
    # rows; the parent re-derives the oracle with numpy)
    from mmrs_tpu.parallel.dedup import sharded_first_match

    rng_d = np.random.default_rng(7)
    xd = rng_d.normal(size=(96, 16)).astype(np.float32)
    xd[41] = xd[3] + 1e-4 * rng_d.normal(size=16).astype(np.float32)
    xd[77] = xd[3] + 1e-4 * rng_d.normal(size=16).astype(np.float32)
    xd[90] = xd[58]
    xd /= np.linalg.norm(xd, axis=1, keepdims=True)
    dedup_first = sharded_first_match(np.asarray(xd), tau=0.999, mesh=mesh,
                                      intra=True, impl="xla")
    # output is row-sharded across processes; gather it host-side so the
    # parent can compare the FULL vector from every process
    from jax.experimental import multihost_utils

    dedup_first = multihost_utils.process_allgather(dedup_first, tiled=True)

    # The multi-host VLM serving shape: decoder TP over each host
    # (model axis never crosses processes — proc_grid above proves it),
    # batch rows over the host-spanning data axis. Params/prompts are
    # deterministic so both processes hold identical host values; the
    # parent compares the decode against its single-process oracle.
    jax.config.update("jax_default_matmul_precision", "highest")

    from mmrs_tpu.models import llama as llama_m
    from mmrs_tpu.models.llama import LlamaConfig
    from mmrs_tpu.parallel.vlm import make_tp_generate, shard_llama_params

    lcfg = LlamaConfig(vocab_size=96, dim=64, layers=2, heads=4, kv_heads=2,
                       mlp_dim=128, max_seq=64)
    params = llama_m.init(jax.random.key(3), lcfg)
    prompt = np.asarray(np.random.default_rng(4).integers(3, 90, (4, 5)),
                        np.int32)                    # B=4 over data=4
    embeds = llama_m.embed_tokens(params, prompt)
    gen = make_tp_generate(lcfg, mesh, max_new_tokens=6, eos_token=-1,
                           compute_dtype=np.float32, kv_dtype=None)
    toks = gen(shard_llama_params(params, mesh), embeds)

    with open(out_path, "w") as f:
        json.dump({
            "pid": int(pid),
            "mesh_shape": dict(mesh.shape),
            "proc_grid": proc_grid,
            "local_rows": [lo, hi],
            "vals": np.asarray(vals).tolist(),
            "idxs": np.asarray(idxs).tolist(),
            "ivf_idxs": np.asarray(ivf_idxs).tolist(),
            "dedup_first": np.asarray(dedup_first).tolist(),
            "decode": np.asarray(toks).tolist(),
        }, f)


if __name__ == "__main__":
    main()
