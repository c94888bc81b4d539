"""Multi-host (multi-process) mesh construction.

The reference never leaves one GPU; this framework's scale-out axis is
the gallery (SURVEY.md §2.6), and past a single host that means a
two-level mesh:

  - the `data` axis (gallery row shards, DP embedding) spans HOSTS first,
    then the surplus local devices — the only collective that crosses
    hosts is the top-k candidate all-gather ([Q, k*S] floats, a few KB)
    and the psum of batch stats, both tiny;
  - the `model` axis (TP verifier shards) stays INSIDE a host so Megatron
    all-reduces stay on the host's own links (NVLink).

`distributed_init` wraps jax.distributed.initialize: pass the coordinator
address (`host:port`), process count and process id explicitly (or set
JAX_COORDINATOR_ADDRESS etc.); nothing detects a cluster by itself.

Single-process fallback: with one process this degrades exactly to
parallel.mesh.make_mesh, so every sharded code path (parallel/topk.py,
parallel/dedup.py, adapt/contrastive.py) is host-count agnostic.
"""

from __future__ import annotations

from typing import Optional

import os

import jax
import numpy as np
from jax.sharding import Mesh

from mmrs_tpu.config import MeshConfig
from mmrs_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize the JAX distributed runtime (idempotent, safe to skip).

    Returns True if multi-process mode is active after the call. A
    single-process run (tests, one host) returns False without side
    effects.
    """
    # Probe the distributed client WITHOUT touching the XLA backend:
    # jax.process_count() would initialize it, and initialize() must run
    # before any backend-creating call. Public API since jax 0.4.x; the
    # private jax._src.distributed.global_state probe was review-flagged
    # as an upgrade hazard.
    if jax.distributed.is_initialized():
        return jax.process_count() > 1
    if coordinator_address is None and num_processes is None:
        if os.environ.get("JAX_COORDINATOR_ADDRESS"):
            # env-var-configured cluster (the docstring's auto-detect
            # path): initialize() must actually run, or every process
            # silently stays single-host with its own private mesh
            jax.distributed.initialize()
            return jax.process_count() > 1
        # nothing requested and nothing detected: single-process run
        return jax.process_count() > 1
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count() > 1


def make_hybrid_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """(data, model) mesh laid out host-major on the data axis.

    Axis sizes: model = cfg.model_size (must divide the LOCAL device
    count — TP collectives must not cross hosts); data = processes x
    (local_devices / model). With one process this is exactly
    mesh.make_mesh's layout.
    """
    cfg = cfg or MeshConfig()
    model = max(1, cfg.model_size)
    local = jax.local_device_count()
    procs = jax.process_count()
    if local % model:
        raise ValueError(
            f"model axis ({model}) must divide local device count ({local}) "
            "— tensor-parallel collectives must stay inside one host")
    per_host_data = local // model
    if cfg.data_size > 0 and cfg.data_size != procs * per_host_data:
        raise ValueError(
            f"data_size {cfg.data_size} != processes ({procs}) x local data "
            f"({per_host_data})")

    if procs == 1:
        devices = np.asarray(jax.devices()).reshape(per_host_data, model)
    else:
        from jax.experimental import mesh_utils

        # granule = PROCESS: the data axis spans hosts (each host's devices
        # stay contiguous on it), whatever the slice topology — matches the
        # docstring's host-major layout and works on CPU test meshes too.
        devices = mesh_utils.create_hybrid_device_mesh(
            mesh_shape=(per_host_data, model),
            dcn_mesh_shape=(procs, 1),
            process_is_granule=True,
        )
    return Mesh(devices, (cfg.data_axis or DATA_AXIS,
                          cfg.model_axis or MODEL_AXIS))


def place_global_rows(local_rows: np.ndarray, n: int, mesh: Mesh,
                      axis: str = DATA_AXIS):
    """Assemble the GLOBAL row-sharded gallery from THIS process's rows.

    The per-host index-build flow: each host loads only the shard files
    covering its `process_local_rows` range, then this stitches them into
    one global jax.Array (jax.make_array_from_process_local_data) sharded
    P(axis, None) — no host ever materializes the whole gallery. Ragged
    tails are zero-padded on the owning host (mask with n_valid at query
    time, same convention as parallel.topk.place_gallery)."""
    import jax as _jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    shards = mesh.shape[axis]
    per = -(-n // shards)                       # rows per shard (ceil)
    n_pad = per * shards
    lo, hi = process_local_rows(n, mesh, axis)
    local = np.asarray(local_rows, np.float32)
    if local.shape[0] != hi - lo:
        raise ValueError(
            f"process owns rows [{lo}, {hi}) of {n}; got {local.shape[0]}")
    # pad to the process's full ADDRESSABLE extent (every shard its
    # devices touch), not just ceil(hi/per): with a small/awkward n the
    # trailing shards hold only padding but still need local rows — a
    # shorter local makes make_array_from_process_local_data raise
    first, last = _owned_span(mesh, axis)
    extent = (last + 1 - first) * per if last >= first else 0
    pad = extent - local.shape[0]
    if pad:
        local = np.pad(local, ((0, pad), (0, 0)))
    sharding = NamedSharding(mesh, P(axis, None))
    return _jax.make_array_from_process_local_data(
        sharding, local, (n_pad, local.shape[1]))


def process_local_rows(n: int, mesh: Mesh, axis: str = DATA_AXIS):
    """Row range [start, stop) of a globally [N, D] row-sharded gallery that
    THIS process must place locally (for jax.make_array_from_process_local_data
    -style index builds where every host reads only its own shard files)."""
    shards = mesh.shape[axis]
    per = -(-n // shards)                       # ceil
    first, last = _owned_span(mesh, axis)
    if last < first:
        return 0, 0
    # clamp BOTH ends by n: a process whose shards start past the valid
    # rows owns an empty (well-formed) range, not an inverted one
    return min(n, first * per), min(n, (last + 1) * per)


def _owned_span(mesh: Mesh, axis: str):
    """(first, last) data-axis shard positions any of THIS process's
    devices sit on (host-major layout); (0, -1) if none."""
    local_ids = {d.id for d in jax.local_devices()}
    rows = []
    axis_idx = list(mesh.axis_names).index(axis)
    for pos in range(mesh.shape[axis]):
        idx = [slice(None)] * len(mesh.axis_names)
        idx[axis_idx] = pos
        if any(d.id in local_ids
               for d in np.asarray(mesh.devices)[tuple(idx)].ravel()):
            rows.append(pos)
    if not rows:
        return 0, -1
    return min(rows), max(rows)
