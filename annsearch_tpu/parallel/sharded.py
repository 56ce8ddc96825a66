"""Sharded query execution: database sharded over a device mesh.

New surface vs the reference (which has no distributed backend, SURVEY §2.7):
each device scans its database shard with the same blocked distance+top-k
kernel used single-chip, local indices are offset to global ids, and the
per-shard candidate sets are merged with one ``all_gather`` over NVLink followed
by a log-merge top-k. This is the "ring top-k distance scan" analogue of the
reference's DB-chunk streaming (dist_gpu.rs:550-685) lifted across chips.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

try:  # jax >= 0.6 stabilised name
    from jax import shard_map as _shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map

from ..ops.topk import chunked_topk, topk_smallest
from ..utils.dist import Dist
from .mesh import BATCH_AXIS, DB_AXIS, make_mesh, make_mesh2d

__all__ = [
    "ShardedExhaustive",
    "BatchShardedExhaustive",
    "GridShardedExhaustive",
    "sharded_topk",
    "batch_sharded_topk",
    "grid_sharded_topk",
]


def _pad_to_multiple(x: np.ndarray, m: int) -> np.ndarray:
    pad = (-x.shape[0]) % m
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)
    return x


def sharded_topk(
    q: jax.Array,
    x_sharded: jax.Array,
    k: int,
    metric: Dist,
    n_valid: int,
    mesh,
    db_chunk: int = 16384,
) -> tuple[jax.Array, jax.Array]:
    """Top-k over a row-sharded database. ``q`` replicated, ``x`` sharded on
    rows; returns replicated ``(dists, idx)`` with global indices."""

    shard_rows_n = x_sharded.shape[0] // mesh.devices.size

    @functools.partial(
        _shard_map,
        mesh=mesh,
        in_specs=(P(), P(DB_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def run(qq, x_shard):
        my = jax.lax.axis_index(DB_AXIS)
        base = my * shard_rows_n
        # valid rows in this shard: global row < n_valid
        local_valid = jnp.clip(n_valid - base, 0, shard_rows_n)
        d, i = chunked_topk(
            qq, x_shard, k, metric, n_valid=local_valid, db_chunk=db_chunk
        )
        i = i + base
        dg = jax.lax.all_gather(d, DB_AXIS, axis=1, tiled=True)
        ig = jax.lax.all_gather(i, DB_AXIS, axis=1, tiled=True)
        md, pos = topk_smallest(dg, k)
        return md, jnp.take_along_axis(ig, pos, axis=-1)

    return run(q, x_sharded)


def batch_sharded_topk(
    q_sharded: jax.Array,
    x: jax.Array,
    k: int,
    metric: Dist,
    n_valid: int,
    mesh,
    db_chunk: int = 16384,
) -> tuple[jax.Array, jax.Array]:
    """Top-k with the *query batch* sharded over the mesh and the database
    replicated — pure data parallelism (the reference's rayon par_iter over
    query rows, lib.rs:84-121, lifted across chips). No collective at all:
    each device answers its own query block; outputs stay batch-sharded."""

    @functools.partial(
        _shard_map,
        mesh=mesh,
        in_specs=(P(DB_AXIS), P()),
        out_specs=(P(DB_AXIS), P(DB_AXIS)),
        check_vma=False,
    )
    def run(q_shard, xx):
        return chunked_topk(
            q_shard, xx, k, metric, n_valid=n_valid, db_chunk=db_chunk
        )

    return run(q_sharded, x)


def grid_sharded_topk(
    q_sharded: jax.Array,
    x_sharded: jax.Array,
    k: int,
    metric: Dist,
    n_valid: int,
    mesh,
    db_chunk: int = 16384,
) -> tuple[jax.Array, jax.Array]:
    """Top-k on a 2-D ``(batch, db)`` mesh: each device scores its own
    (query block × database shard) tile; the per-shard candidates merge
    with one ``all_gather`` along the ``db`` axis only — the ``batch``
    axis stays collective-free. This is the dp×tp composition: scale
    query throughput along ``batch`` and database size along ``db``."""

    shard_rows_n = x_sharded.shape[0] // mesh.shape[DB_AXIS]

    @functools.partial(
        _shard_map,
        mesh=mesh,
        in_specs=(P(BATCH_AXIS), P(DB_AXIS)),
        out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
        check_vma=False,
    )
    def run(q_blk, x_shard):
        my = jax.lax.axis_index(DB_AXIS)
        base = my * shard_rows_n
        local_valid = jnp.clip(n_valid - base, 0, shard_rows_n)
        d, i = chunked_topk(
            q_blk, x_shard, k, metric, n_valid=local_valid, db_chunk=db_chunk
        )
        i = i + base
        dg = jax.lax.all_gather(d, DB_AXIS, axis=1, tiled=True)
        ig = jax.lax.all_gather(i, DB_AXIS, axis=1, tiled=True)
        md, pos = topk_smallest(dg, k)
        return md, jnp.take_along_axis(ig, pos, axis=-1)

    return run(q_sharded, x_sharded)


class GridShardedExhaustive:
    """Multi-chip exhaustive index on a 2-D ``(batch, db)`` mesh: database
    rows sharded along ``db``, query batches along ``batch``. The top-k
    merge collective rides only the ``db`` axis."""

    def __init__(self, mat, metric: str = "euclidean", mesh=None,
                 n_batch: int | None = None, n_db: int | None = None):
        from ..models.base import as_f32_matrix
        from ..utils.dist import normalise, parse_ann_dist

        if mesh is None:
            ndev = len(jax.devices())
            if n_batch is None or n_db is None:
                n_db = n_db or max(1, int(np.sqrt(ndev)))
                n_batch = ndev // n_db
            mesh = make_mesh2d(n_batch, n_db)
        self.mesh = mesh
        arr = as_f32_matrix(mat)
        self.metric = parse_ann_dist(metric)
        self.n, self.dim = arr.shape
        arr = _pad_to_multiple(arr, mesh.shape[DB_AXIS])
        x = jnp.asarray(arr)
        if self.metric == Dist.COSINE:
            x = normalise(x).at[self.n :].set(0.0)
        self.vectors = jax.device_put(
            x, NamedSharding(self.mesh, P(DB_AXIS))
        )

    def query(self, query_mat, k: int, db_chunk: int = 16384):
        from ..models.base import as_f32_matrix
        from ..utils.dist import normalise

        q = as_f32_matrix(query_mat)
        nq = q.shape[0]
        q = _pad_to_multiple(q, self.mesh.shape[BATCH_AXIS])
        qj = jnp.asarray(q)
        if self.metric == Dist.COSINE:
            qj = normalise(qj).at[nq:].set(0.0)
        qj = jax.device_put(qj, NamedSharding(self.mesh, P(BATCH_AXIS)))
        k = max(1, min(k, self.n))
        d, i = grid_sharded_topk(
            qj, self.vectors, k, self.metric, self.n, self.mesh, db_chunk
        )
        return np.asarray(i)[:nq], np.asarray(d)[:nq]


class BatchShardedExhaustive:
    """Multi-chip exhaustive index with the database REPLICATED and query
    batches sharded — the right layout when the DB fits on every chip and
    query throughput is the scaling goal (dual of :class:`ShardedExhaustive`,
    which shards the DB and replicates queries)."""

    def __init__(self, mat, metric: str = "euclidean", mesh=None):
        from ..models.base import as_f32_matrix
        from ..utils.dist import normalise, parse_ann_dist

        self.mesh = mesh if mesh is not None else make_mesh()
        arr = as_f32_matrix(mat)
        self.metric = parse_ann_dist(metric)
        self.n, self.dim = arr.shape
        x = jnp.asarray(arr)
        if self.metric == Dist.COSINE:
            x = normalise(x)
        self.vectors = jax.device_put(x, NamedSharding(self.mesh, P()))

    def query(self, query_mat, k: int, db_chunk: int = 16384):
        from ..models.base import as_f32_matrix
        from ..utils.dist import normalise

        q = as_f32_matrix(query_mat)
        nq = q.shape[0]
        ndev = self.mesh.devices.size
        q = _pad_to_multiple(q, ndev)
        qj = jnp.asarray(q)
        if self.metric == Dist.COSINE:
            qj = normalise(qj).at[nq:].set(0.0)
        qj = jax.device_put(qj, NamedSharding(self.mesh, P(DB_AXIS)))
        k = max(1, min(k, self.n))
        d, i = batch_sharded_topk(
            qj, self.vectors, k, self.metric, self.n, self.mesh, db_chunk
        )
        return np.asarray(i)[:nq], np.asarray(d)[:nq]


class ShardedExhaustive:
    """Multi-chip exhaustive index: vectors row-sharded over a 1-D mesh.

    Build = shard + device_put; query = :func:`sharded_topk`. The analogous
    single-chip object is :class:`annsearch_tpu.models.ExhaustiveIndex`.
    """

    def __init__(self, mat, metric: str = "euclidean", mesh=None):
        from ..models.base import as_f32_matrix
        from ..utils.dist import normalise, parse_ann_dist

        self.mesh = mesh if mesh is not None else make_mesh()
        arr = as_f32_matrix(mat)
        self.metric = parse_ann_dist(metric)
        self.n, self.dim = arr.shape
        ndev = self.mesh.devices.size
        arr = _pad_to_multiple(arr, ndev)
        x = jnp.asarray(arr)
        if self.metric == Dist.COSINE:
            x = normalise(x).at[self.n :].set(0.0)
        self.vectors = jax.device_put(
            x, NamedSharding(self.mesh, P(DB_AXIS))
        )

    def query(self, query_mat, k: int, db_chunk: int = 16384):
        from ..models.base import as_f32_matrix
        from ..utils.dist import normalise

        q = jnp.asarray(as_f32_matrix(query_mat))
        if self.metric == Dist.COSINE:
            q = normalise(q)
        q = jax.device_put(q, NamedSharding(self.mesh, P()))
        k = max(1, min(k, self.n))
        d, i = sharded_topk(
            q, self.vectors, k, self.metric, self.n, self.mesh, db_chunk
        )
        return np.asarray(i), np.asarray(d)
