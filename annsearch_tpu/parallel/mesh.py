"""Device mesh helpers.

The reference is single-process (SURVEY §2.7: no NCCL/MPI); its scaling story
is rayon threads + one GPU. This rebuild's multi-card story is a 1-D data
mesh: the vector database is sharded row-wise over devices, queries are
replicated (or batch-sharded), and per-shard top-k results are merged with an
``all_gather`` over NVLink.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh", "make_mesh2d", "shard_rows", "replicate",
    "DB_AXIS", "BATCH_AXIS",
]

#: mesh axis name the database rows are sharded over
DB_AXIS = "db"
#: mesh axis name query batches are sharded over (2-D meshes)
BATCH_AXIS = "batch"


def make_mesh(n_devices: int | None = None, axis: str = DB_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def make_mesh2d(n_batch: int, n_db: int) -> Mesh:
    """2-D ``(batch, db)`` mesh: query batches shard over ``batch`` (pure
    data parallelism, no collective), database rows over ``db`` (the top-k
    merge all_gather rides only this axis)."""
    devices = jax.devices()[: n_batch * n_db]
    if len(devices) < n_batch * n_db:
        raise ValueError(
            f"need {n_batch * n_db} devices, have {len(devices)}"
        )
    return Mesh(
        np.array(devices).reshape(n_batch, n_db), (BATCH_AXIS, DB_AXIS)
    )


def shard_rows(x: jax.Array, mesh: Mesh, axis: str = DB_AXIS) -> jax.Array:
    """Place ``x`` row-sharded over the mesh (rows must divide evenly;
    callers pad)."""
    return jax.device_put(x, NamedSharding(mesh, P(axis)))


def replicate(x: jax.Array, mesh: Mesh) -> jax.Array:
    return jax.device_put(x, NamedSharding(mesh, P()))
