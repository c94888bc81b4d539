"""Device-mesh construction and sharding helpers.

The reference has no distributed execution (SURVEY.md §2.6 — single CUDA GPU,
no NCCL/MPI/DDP anywhere). This framework's scaling axis is the GALLERY:
embedding rows are sharded over the `data` mesh axis and queries are
replicated; a `model` axis is reserved for tensor-parallel hosting of a
large VLM verifier. Collectives are compiler-inserted all-gathers /
ppermutes (NCCL over NVLink on a GPU host) — no custom transport. The
cards of one host are joined all to all, so a flat axis is the layout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mmrs_tpu.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    cfg: Optional[MeshConfig] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    cfg = cfg or MeshConfig()
    devices = list(devices) if devices is not None else jax.devices()
    n = len(devices)
    model = max(1, cfg.model_size)
    data = cfg.data_size if cfg.data_size > 0 else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    arr = np.asarray(devices).reshape(data, model)
    return Mesh(arr, (cfg.data_axis, cfg.model_axis))


def shard_rows(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    """Row-shard a [N, D] matrix across the data axis."""
    return NamedSharding(mesh, P(axis, None))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def num_shards(mesh: Mesh, axis: str = DATA_AXIS) -> int:
    return mesh.shape[axis]
