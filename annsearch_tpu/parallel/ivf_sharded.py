"""Multi-chip IVF: distributed k-means build + sharded cell scan.

New surface vs the reference (single-process, SURVEY §2.7): the database is
row-sharded over a 1-D mesh and both phases run SPMD:

  * **build** — Lloyd iterations under ``shard_map``: every device assigns
    its rows to the replicated centroids (local GEMM argmin), computes
    partial ``segment_sum`` sums/counts, and one ``psum`` over NVLink yields
    identical updated centroids everywhere. This is the k-means engine
    (``models/kmeans.py``) distributed the way the scaling-book recipe
    says: shard data, replicate parameters, let the collective do the sum.
  * **query** — routing is replicated (same centroids ⇒ same probe lists,
    built once on host); each device runs the cluster-major scan over its
    *local* cells; per-shard top-k results are ``all_gather``-ed and
    log-merged. Cells exist per shard (each device clusters only its rows),
    so no cross-device data movement happens during the scan — only the
    [nq, k] merge rides NVLink.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

try:
    from jax import shard_map as _shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map

from ..models.base import as_f32_matrix
from ..models.kmeans import build_cells, _dsq_seed_init, _random_init
from ..ops.ivf_scan import build_probe_lists, ivf_cluster_scan
from ..ops.topk import topk_smallest
from ..utils.dist import Dist, normalise, parse_ann_dist, sq_norms
from .mesh import BATCH_AXIS, DB_AXIS, make_mesh

__all__ = [
    "train_centroids_sharded",
    "ShardedIvfIndex",
    "ShardedIvfPqIndex",
]


def train_centroids_sharded(
    x_sharded: jax.Array,   # [n_pad, d] row-sharded over mesh
    init_centroids: jax.Array,  # [k, d] replicated
    n_valid: int,
    mesh,
    iters: int = 15,
) -> jax.Array:
    """Distributed Lloyd: local assign + psum'd segment-sum update.

    Works on 1-D ``db`` meshes and 2-D ``(batch, db)`` grids alike — the
    data shards along ``db`` only; ``batch`` rows of the grid hold
    replicated copies and redundantly compute the same update (build runs
    once; the psum stays on the ``db`` axis)."""
    k = init_centroids.shape[0]
    shard_rows = x_sharded.shape[0] // mesh.shape[DB_AXIS]

    @functools.partial(
        _shard_map,
        mesh=mesh,
        in_specs=(P(DB_AXIS), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(x_shard, c0):
        my = jax.lax.axis_index(DB_AXIS)
        base = my * shard_rows
        row_valid = (
            base + jax.lax.broadcasted_iota(jnp.int32, (shard_rows, 1), 0)[:, 0]
        ) < n_valid
        xs = sq_norms(x_shard)

        def body(_, c):
            d = (
                xs[:, None]
                + sq_norms(c)[None, :]
                - 2.0
                * jax.lax.dot_general(
                    x_shard, c, (((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32,
                )
            )
            a = jnp.argmin(d, axis=1)
            w = row_valid.astype(jnp.float32)
            sums = jax.ops.segment_sum(x_shard * w[:, None], a, num_segments=k)
            counts = jax.ops.segment_sum(w, a, num_segments=k)
            sums = jax.lax.psum(sums, DB_AXIS)
            counts = jax.lax.psum(counts, DB_AXIS)
            return jnp.where(
                counts[:, None] > 0,
                sums / jnp.maximum(counts, 1.0)[:, None],
                c,
            )

        return jax.lax.fori_loop(0, iters, body, c0)

    return run(x_sharded, init_centroids)


class ShardedIvfIndex:
    """IVF index with database and cells sharded over a device mesh.

    Accepts a 1-D ``db`` mesh (queries replicated, the default) or a 2-D
    ``(batch, db)`` grid (``make_mesh2d``): database rows shard along
    ``db``; on a grid, query batches additionally shard along ``batch`` so
    multi-chip query throughput scales with the mesh (the reference's rayon
    query parallelism, lib.rs:84-121, composed with the sharded scan)."""

    def __init__(
        self,
        mat,
        metric: str = "euclidean",
        nlist: int | None = None,
        max_iters: int = 15,
        seed: int = 42,
        mesh=None,
    ):
        self.mesh = mesh if mesh is not None else make_mesh()
        ndev = self.mesh.shape[DB_AXIS]
        arr = as_f32_matrix(mat)
        self.metric = parse_ann_dist(metric)
        self.n, self.dim = arr.shape
        if nlist is None:
            nlist = max(1, int(math.isqrt(self.n)))
        self.nlist = min(nlist, self.n)

        x = jnp.asarray(arr)
        if self.metric == Dist.COSINE:
            x = normalise(x)

        # pad rows to a shard multiple, shard
        pad = (-self.n) % ndev
        if pad:
            x = jnp.concatenate([x, jnp.zeros((pad, self.dim), x.dtype)])
        self.shard_rows = x.shape[0] // ndev

        # init on a host-side sample, then distributed Lloyd
        key = jax.random.key(seed)
        m = min(self.n, min(256 * self.nlist, 250_000))
        key, ks, ki = jax.random.split(key, 3)
        idx = jax.random.choice(ks, self.n, (m,), replace=False)
        sample = x[idx]
        if self.nlist <= 200:
            init = _dsq_seed_init(ki, sample, self.nlist)
        else:
            init = _random_init(ki, sample, self.nlist)

        x_sharded = jax.device_put(x, NamedSharding(self.mesh, P(DB_AXIS)))
        self.centroids = train_centroids_sharded(
            x_sharded, init, self.n, self.mesh, iters=max_iters
        )

        # per-shard cells (host-side layout, like the single-chip path)
        x_np = np.asarray(x)
        c_np = np.asarray(self.centroids)
        sorted_parts, owners_parts = [], []
        offsets, counts, orig = [], [], []
        self._shard_valid = []
        cell_cap = 1
        for s in range(ndev):
            lo, hi = s * self.shard_rows, (s + 1) * self.shard_rows
            xs = x_np[lo:hi]
            valid = min(self.shard_rows, max(0, self.n - lo))
            d = (
                (xs**2).sum(1)[:, None]
                + (c_np**2).sum(1)[None, :]
                - 2.0 * xs @ c_np.T
            )
            a = np.argmin(d, axis=1)
            a[valid:] = 0  # padding rows parked in cell 0 but masked below
            members, cnt, order = build_cells(a[:valid], self.nlist)
            cell_cap = max(cell_cap, members.shape[1])
            sorted_x = np.zeros_like(xs)
            sorted_x[:valid] = xs[order]
            owners = np.zeros(self.shard_rows, np.int32)
            owners[:valid] = a[:valid][order]
            sorted_parts.append(sorted_x)
            owners_parts.append(owners)
            counts.append(cnt)
            offsets.append(
                np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int32)
            )
            om = np.zeros(self.shard_rows, np.int32)
            om[:valid] = order + lo
            orig.append(om)
            self._shard_valid.append(valid)
        self.cell_cap = cell_cap

        storages, sqnorm_parts = self._encode_shards(
            sorted_parts, owners_parts, seed
        )

        # sharded device arrays: leading dim = device axis
        def put(parts, spec):
            return jax.device_put(
                jnp.asarray(np.stack(parts)), NamedSharding(self.mesh, spec)
            )

        # storage is padded with cell_cap rows per shard for static slices
        pads = np.zeros((ndev, cell_cap) + storages[0].shape[1:], storages[0].dtype)
        self.storage = put(
            [np.concatenate([s, p]) for s, p in zip(storages, pads)],
            P(DB_AXIS, None, None),
        )
        self.store_sqnorms = put(
            [
                np.concatenate([sq, np.zeros(cell_cap, np.float32)])
                for sq in sqnorm_parts
            ],
            P(DB_AXIS, None),
        )
        self.offsets = put(offsets, P(DB_AXIS, None))
        self.counts = put(counts, P(DB_AXIS, None))
        self.original_ids = put(orig, P(DB_AXIS, None))

    # -- storage-encoding hook (f32 base; ShardedIvfPqIndex overrides) -------

    mode = "f32"

    def _encode_shards(self, sorted_parts, owners_parts, seed):
        return sorted_parts, [(s**2).sum(1) for s in sorted_parts]

    def _scan_codebooks(self):
        return None

    def _encode_queries(self, q):
        return q

    def default_nprobe(self) -> int:
        return max(1, int(math.isqrt(self.nlist)))

    def _grid_batch(self) -> int:
        """Query-batch shards on 2-D ``(batch, db)`` grids, else 1."""
        names = getattr(self.mesh, "axis_names", ())
        return self.mesh.shape[BATCH_AXIS] if BATCH_AXIS in names else 1

    def query(self, query_mat, k: int, nprobe: int | None = None):
        q = jnp.asarray(as_f32_matrix(query_mat))
        if self.metric == Dist.COSINE:
            q = normalise(q)
        k = max(1, min(k, self.n))
        nprobe = self.default_nprobe() if nprobe is None else nprobe
        nprobe = max(1, min(nprobe, self.nlist))
        if self._grid_batch() > 1:
            return self._query_grid(q, k, nprobe)
        nq = q.shape[0]

        # replicated routing → shared probe lists
        dots = q @ self.centroids.T
        if self.metric == Dist.COSINE:
            cd = 1.0 - dots
        else:
            cd = (
                sq_norms(q)[:, None]
                + sq_norms(self.centroids)[None, :]
                - 2.0 * dots
            )
        _, probes = topk_smallest(cd, nprobe)
        cluster_ids, lists, gmap = build_probe_lists(
            np.asarray(probes), self.nlist, nq
        )
        cluster_ids = jnp.asarray(cluster_ids)
        lists = jnp.asarray(lists)
        gmap = jnp.asarray(gmap)

        metric = self.metric
        cap = self.cell_cap
        mode = self.mode
        codebooks = self._scan_codebooks()
        has_cb = codebooks is not None

        @functools.partial(
            _shard_map,
            mesh=self.mesh,
            in_specs=(
                P(), P(), P(), P(),
                P(DB_AXIS, None, None), P(DB_AXIS, None),
                P(DB_AXIS, None), P(DB_AXIS, None), P(DB_AXIS, None), P(),
            )
            + ((P(),) if has_cb else ()),
            out_specs=(P(), P()),
            check_vma=False,
        )
        def run(qq, cids, plists, pgmap, storage, sqn, offs, cnts, oids,
                cents, *cb):
            d, i = ivf_cluster_scan(
                qq, cids, plists, pgmap, storage[0], sqn[0], offs[0], cnts[0],
                cents, k, metric, cap, mode,
                codebooks=cb[0] if cb else None,
            )
            gids = oids[0][jnp.clip(i, 0, oids.shape[1] - 1)]
            dg = jax.lax.all_gather(d, DB_AXIS, axis=1, tiled=True)
            ig = jax.lax.all_gather(gids, DB_AXIS, axis=1, tiled=True)
            md, pos = topk_smallest(dg, k)
            return md, jnp.take_along_axis(ig, pos, axis=-1)

        args = (
            self._encode_queries(q), cluster_ids, lists, gmap, self.storage,
            self.store_sqnorms, self.offsets, self.counts, self.original_ids,
            self.centroids,
        ) + ((codebooks,) if has_cb else ())
        d, ids = run(*args)
        return np.asarray(ids), np.asarray(d)

    def _query_grid(self, q: jax.Array, k: int, nprobe: int):
        """2-D ``(batch, db)`` query: each device scans its (query block ×
        cell shard) tile; the top-k merge all_gather rides only ``db``.

        Routing is computed once for the whole batch (one [nq, nlist]
        matmul); probe-list inversion happens per query block on the host
        with every block padded to a COMMON (R, maxq, T) so the shard_map
        traces one program. Sentinel conventions are block-local: query pad
        = block rows (bq), cluster pad = nlist, gather pad = -1."""
        nb = self._grid_batch()
        nq = q.shape[0]
        pad = (-nq) % nb
        if pad:
            q = jnp.concatenate([q, jnp.zeros((pad, self.dim), q.dtype)])
        bq = q.shape[0] // nb

        dots = q @ self.centroids.T
        if self.metric == Dist.COSINE:
            cd = 1.0 - dots
        else:
            cd = (
                sq_norms(q)[:, None]
                + sq_norms(self.centroids)[None, :]
                - 2.0 * dots
            )
        _, probes = topk_smallest(cd, nprobe)
        probes_np = np.asarray(probes)

        blocks = [
            build_probe_lists(probes_np[b * bq : (b + 1) * bq], self.nlist, bq)
            for b in range(nb)
        ]
        R = max(c.shape[0] for c, _, _ in blocks)
        maxq = max(l.shape[1] for _, l, _ in blocks)
        T = max(g.shape[1] for _, _, g in blocks)

        def pad_block(c, l, g):
            cp = np.full(R, self.nlist, np.int32)
            cp[: c.shape[0]] = c
            lp = np.full((R, maxq), bq, np.int32)
            lp[: l.shape[0], : l.shape[1]] = l
            gp = np.full((bq, T), -1, np.int32)
            gp[:, : g.shape[1]] = g
            return cp, lp, gp

        padded = [pad_block(*blk) for blk in blocks]
        spec_b = lambda *rest: NamedSharding(self.mesh, P(BATCH_AXIS, *rest))
        cids = jax.device_put(
            jnp.asarray(np.stack([p[0] for p in padded])), spec_b(None)
        )
        lists = jax.device_put(
            jnp.asarray(np.stack([p[1] for p in padded])), spec_b(None, None)
        )
        gmap = jax.device_put(
            jnp.asarray(np.stack([p[2] for p in padded])), spec_b(None, None)
        )
        q_sharded = jax.device_put(q, spec_b(None))

        metric = self.metric
        cap = self.cell_cap
        mode = self.mode
        codebooks = self._scan_codebooks()
        has_cb = codebooks is not None

        @functools.partial(
            _shard_map,
            mesh=self.mesh,
            in_specs=(
                P(BATCH_AXIS), P(BATCH_AXIS, None), P(BATCH_AXIS, None, None),
                P(BATCH_AXIS, None, None),
                P(DB_AXIS, None, None), P(DB_AXIS, None),
                P(DB_AXIS, None), P(DB_AXIS, None), P(DB_AXIS, None), P(),
            )
            + ((P(),) if has_cb else ()),
            out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
            check_vma=False,
        )
        def run(qq, cids_b, plists_b, pgmap_b, storage, sqn, offs, cnts,
                oids, cents, *cb):
            d, i = ivf_cluster_scan(
                qq, cids_b[0], plists_b[0], pgmap_b[0], storage[0], sqn[0],
                offs[0], cnts[0], cents, k, metric, cap, mode,
                codebooks=cb[0] if cb else None,
            )
            gids = oids[0][jnp.clip(i, 0, oids.shape[1] - 1)]
            dg = jax.lax.all_gather(d, DB_AXIS, axis=1, tiled=True)
            ig = jax.lax.all_gather(gids, DB_AXIS, axis=1, tiled=True)
            md, pos = topk_smallest(dg, k)
            return md, jnp.take_along_axis(ig, pos, axis=-1)

        args = (
            self._encode_queries(q_sharded), cids, lists, gmap, self.storage,
            self.store_sqnorms, self.offsets, self.counts, self.original_ids,
            self.centroids,
        ) + ((codebooks,) if has_cb else ())
        d, ids = run(*args)
        return np.asarray(ids)[:nq], np.asarray(d)[:nq]


class ShardedIvfPqIndex(ShardedIvfIndex):
    """Sharded IVF-PQ: distributed coarse quantiser + per-shard residual
    PQ cells (the north-star index, scaled over the mesh).

    Codebooks are trained once on a replicated residual sample (PQ training
    data is capped anyway — reference ivf_pq.rs:195-234); each shard encodes
    its own rows. The ``dim == m`` configuration stores the int8 fast-scan
    decode cache (see ``models/quantised/ivf.py``), so the distributed scan
    is the same int8 matmul as the single-chip flagship; other ``m`` store u8
    codes and decode on the fly.
    """

    def __init__(self, mat, metric="euclidean", nlist=None, m=None,
                 max_iters=15, seed=42, mesh=None):
        self._m = m
        super().__init__(
            mat, metric, nlist=nlist, max_iters=max_iters, seed=seed,
            mesh=mesh,
        )

    def _encode_shards(self, sorted_parts, owners_parts, seed):
        from ..models.quantised.quantisers import ProductQuantiser

        dim = sorted_parts[0].shape[1]
        m = self._m if self._m is not None else dim
        c_np = np.asarray(self.centroids)

        # train codebooks on a capped residual sample across shards
        # (valid rows only — trailing shard rows are zero padding)
        res_parts = [
            s - c_np[o] for s, o in zip(sorted_parts, owners_parts)
        ]
        sample = np.concatenate(
            [r[:v] for r, v in zip(res_parts, self._shard_valid)]
        )[:: max(1, self.n // 100_000)]
        self.pq = ProductQuantiser.train(jnp.asarray(sample), m, seed=seed)

        if self.metric == Dist.COSINE:
            def full_sq(rec, o):
                recon = rec + c_np[o]
                return (recon**2).sum(1).astype(np.float32)
        else:
            def full_sq(rec, o):
                return (rec**2).sum(1).astype(np.float32)

        storages, sqnorms = [], []
        if dim == m:
            # global int8 requantisation scales for the decode cache
            dec_all = []
            for r in res_parts:
                dec_all.append(
                    np.asarray(self.pq.decode(self.pq.encode(jnp.asarray(r))))
                )
            absmax = np.maximum(
                np.abs(
                    np.concatenate(
                        [d[:v] for d, v in zip(dec_all, self._shard_valid)]
                    )
                ).max(axis=0),
                1e-12,
            )
            self.dec_scales = jnp.asarray((absmax / 127.0), jnp.float32)
            self.mode = "i8dec_residual"
            for dec, o in zip(dec_all, owners_parts):
                d8 = np.clip(
                    np.round(dec / np.asarray(self.dec_scales)), -127, 127
                ).astype(np.int8)
                rec = d8.astype(np.float32) * np.asarray(self.dec_scales)
                storages.append(d8)
                sqnorms.append(full_sq(rec, o))
        else:
            self.dec_scales = None
            self.mode = "pq_residual"
            for r, o in zip(res_parts, owners_parts):
                codes = np.asarray(self.pq.encode(jnp.asarray(r)))
                dec = np.asarray(self.pq.decode(jnp.asarray(codes)))
                storages.append(codes)
                sqnorms.append(full_sq(dec, o))
        return storages, sqnorms

    def _scan_codebooks(self):
        if self.mode == "i8dec_residual":
            return self.dec_scales
        return self.pq.codebooks
