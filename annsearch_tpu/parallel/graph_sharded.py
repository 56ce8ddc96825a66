"""Multi-chip CAGRA-style graph index: sharded build + sharded beam query.

BASELINE config 5 ("CAGRA-style graph, 10M vectors sharded over a
mesh") — new surface vs the reference, whose graph machinery is
single-device (``src/gpu/nndescent_gpu.rs:1381-1875`` build loop,
``src/gpu/cagra_gpu_search.rs:818-944`` batched search). Distributed per
SURVEY §7 step 7, but *not* by translating those loops: random cross-shard
gathers are the one shape SPMD programs punish, so the design keeps every
build round and every beam iteration shard-local and moves data only in
dense, schedulable blocks:

  * **build** — the database is row-sharded over a 1-D ``db`` mesh; every
    device builds an independent CAGRA sub-graph over its own rows with the
    single-chip batched-round kernels (``ops/graph``: brute tensor-core scan below
    the per-shard FLOP budget, else RP-forest + NN-descent rounds) under
    one ``shard_map``. No collective at all — construction is
    embarrassingly parallel, the same economics that make the reference's
    locked concurrent inserts unnecessary on one chip.
  * **query** — queries are replicated; each device beam-searches its local
    sub-graph (local routed entries, local sorted beam), local ids are
    offset to global, and one ``all_gather`` + log-merge top-k over NVLink
    combines the per-shard candidates. Searching P sub-graphs of n/P rows
    costs ~the same wall-clock as one n-row search (each walk is shorter)
    and needs no cross-shard frontier traffic at all.
  * **self-kNN / graph extraction** — the only phase that genuinely needs
    cross-shard pairs. Blocks of vectors ride a **ring** (``ppermute``):
    at step s each device scores the visiting block against its shard
    (exact tensor-core scan below budget, else a beam search of its sub-graph) and
    the block's running top-k merges as it travels; after P hops every
    block returns home with its global kNN rows. Collectives are P
    neighbour-to-neighbour block passes over NVLink — the "ring scan" of
    SURVEY §5/§7 — instead of an n×d all-gather.
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
from ..models.graph import BRUTE_BUILD_FLOP_BUDGET
from ..utils.dist import mantissa_split
from ..ops.graph import (
    add_reverse_edges,
    beam_search,
    cagra_prune,
    nnd_round,
    random_init_graph,
    rp_forest_round,
)
from ..ops.topk import chunked_topk, merge_topk, topk_smallest
from ..utils.dist import Dist, normalise, parse_ann_dist, sq_norms
from .mesh import BATCH_AXIS, DB_AXIS, make_mesh

__all__ = ["ring_self_knn", "ShardedGraphIndex"]

_INF = jnp.float32(jnp.inf)


def _ring_perm(ndev: int):
    return [(i, (i + 1) % ndev) for i in range(ndev)]


def ring_self_knn(
    x_sharded: jax.Array,   # [n_pad, d] row-sharded over mesh (pad rows 0)
    k: int,
    metric: Dist,
    n_valid: int,
    mesh,
    db_chunk: int = 8192,
) -> tuple[jax.Array, jax.Array]:
    """Exact self-kNN graph over a row-sharded database via a block ring.

    Each device keeps its shard resident and a *visiting* copy of one other
    shard; at every step it scores the visiting block's rows against its
    own rows (blocked tensor-core scan), merges into the block's travelling top-k,
    and ``ppermute``s block + state to the next device. After P steps each
    block has seen the whole database; outputs come home row-sharded.
    Self-pairs are masked by global id. Distances are f32-grade (HIGHEST).

    Returns (ids [n_pad, k] global asc-by-dist, dists [n_pad, k]) sharded
    like the input; pad rows return sentinel ``n_valid``/+inf columns.
    """
    ndev = mesh.shape[DB_AXIS]
    m = x_sharded.shape[0] // ndev
    k = min(k, max(n_valid - 1, 1))

    @functools.partial(
        _shard_map,
        mesh=mesh,
        in_specs=(P(DB_AXIS),),
        out_specs=(P(DB_AXIS), P(DB_AXIS)),
        check_vma=False,
    )
    def run(x_shard):
        my = jax.lax.axis_index(DB_AXIS)
        x_sq = sq_norms(x_shard)

        # travelling state: (block vectors, owner base, running top-k)
        blk = x_shard
        owner_base = my * m
        best_d = jnp.full((m, k), _INF)
        best_i = jnp.full((m, k), n_valid, jnp.int32)

        def step(s, carry):
            blk, owner_base, best_d, best_i = carry
            host = jax.lax.axis_index(DB_AXIS)
            host_base = host * m
            gid_rows = owner_base + jnp.arange(m, dtype=jnp.int32)
            local_valid = jnp.clip(n_valid - host_base, 0, m)
            d, i = chunked_topk(
                blk, x_shard, min(k + 1, m), metric, x_sqnorm=x_sq,
                n_valid=local_valid, db_chunk=db_chunk,
            )
            gi = i + host_base
            d = jnp.where(gi == gid_rows[:, None], _INF, d)
            best_d, best_i = merge_topk(best_d, best_i, d, gi, k)
            perm = _ring_perm(ndev)
            blk = jax.lax.ppermute(blk, DB_AXIS, perm)
            owner_base = jax.lax.ppermute(owner_base, DB_AXIS, perm)
            best_d = jax.lax.ppermute(best_d, DB_AXIS, perm)
            best_i = jax.lax.ppermute(best_i, DB_AXIS, perm)
            return blk, owner_base, best_d, best_i

        blk, owner_base, best_d, best_i = jax.lax.fori_loop(
            0, ndev, step, (blk, owner_base, best_d, best_i)
        )
        # after P hops the block is home again (owner == my)
        row_pad = (my * m + jnp.arange(m, dtype=jnp.int32)) >= n_valid
        best_d = jnp.where(row_pad[:, None], _INF, best_d)
        best_i = jnp.where(
            row_pad[:, None] | jnp.isinf(best_d), n_valid, best_i
        )
        return best_d, best_i

    d, i = run(x_sharded)
    return i, d


class ShardedGraphIndex:
    """CAGRA-style graph index sharded over a 1-D device mesh.

    Per-shard sub-graphs are built locally (no collectives); queries merge
    per-shard beam results with one ``all_gather``; global self-kNN rows
    come from the block ring. See the module docstring for the layout
    rationale. Single-chip analogue: :class:`annsearch_tpu.models.graph.
    NNDescentIndex` (reference ``NNDescentGpu`` + CAGRA search).
    """

    def __init__(
        self,
        mat,
        metric: str = "euclidean",
        k: int = 30,
        build_k: int | None = None,
        out_deg: int | None = None,
        reverse_extra: int | None = None,
        n_trees: int = 2,
        rounds: int = 8,
        seed: int = 42,
        mesh=None,
    ):
        self.mesh = mesh if mesh is not None else make_mesh()
        ndev = self.mesh.shape[DB_AXIS]
        arr = as_f32_matrix(mat)
        self.metric = parse_ann_dist(metric)
        self.n, self.dim = arr.shape
        pad = (-self.n) % ndev
        if pad:
            arr = np.concatenate(
                [np.asarray(arr), np.zeros((pad, self.dim), np.float32)]
            )
        x = jnp.asarray(arr)
        if self.metric == Dist.COSINE:
            x = normalise(x).at[self.n :].set(0.0)
        self.n_pad = x.shape[0]
        m = self.n_pad // ndev
        self.shard_rows = m

        kk = min(build_k if build_k is not None else 2 * k, max(m - 1, 1))
        self.k_build = kk
        self.out_deg = min(out_deg if out_deg is not None else max(k, 16), kk)
        rex = reverse_extra if reverse_extra is not None else self.out_deg // 2

        # per-shard FLOP budget: same crossover as the single-chip builder
        brute = m * m * self.dim <= BRUTE_BUILD_FLOP_BUDGET

        @functools.partial(
            _shard_map,
            mesh=self.mesh,
            in_specs=(P(DB_AXIS),),
            out_specs=(P(DB_AXIS), P(DB_AXIS), P(DB_AXIS)),
            check_vma=False,
        )
        def build(x_shard):
            my = jax.lax.axis_index(DB_AXIS)
            base = my * m
            local_valid = jnp.clip(self.n - base, 0, m)
            key = jax.random.fold_in(jax.random.key(seed), my)
            vecs = jnp.concatenate(
                [x_shard, jnp.zeros((1, self.dim), jnp.float32)]
            )
            sq = sq_norms(vecs)
            # park pad rows at +BIG sqnorm so no euclidean build step links
            # to them; mask them explicitly below for both metrics
            if brute:
                d, i = chunked_topk(
                    x_shard, x_shard, min(kk + 1, m), self.metric,
                    x_sqnorm=sq[:m], n_valid=local_valid,
                )
                rows = jnp.arange(m, dtype=jnp.int32)
                d = jnp.where(i == rows[:, None], _INF, d)
                nd, pos = jax.lax.top_k(-d, kk)
                ids = jnp.take_along_axis(i, pos, axis=-1)
                dists = -nd
                ids = jnp.where(jnp.isinf(dists), m, ids).astype(jnp.int32)
            else:
                key, k0 = jax.random.split(key)
                ids, dists = random_init_graph(k0, vecs, sq, kk, self.metric)
                leaf = 64
                levels = max(1, int(math.ceil(math.log2(max(m / leaf, 2)))))
                for _ in range(n_trees):
                    key, kt = jax.random.split(key)
                    ids, dists = rp_forest_round(
                        kt, vecs, sq, ids, dists, levels, leaf, kk,
                        self.metric,
                    )
                flags = jnp.ones((m, kk), bool)
                # static full→sampled schedule (the rate-adaptive switch of
                # models/graph.approx_knn_graph needs host-side rate reads,
                # impossible inside a traced shard_map): full-width joins
                # carry the quadratic-convergence phase, sampled blocks
                # polish the tail
                from ..models.graph import _nnd_tile
                from ..ops.graph import (
                    NND_R_NEW, NND_R_OLD, nnd_cand_width,
                )

                base_w = kk + NND_R_NEW + NND_R_OLD
                for r in range(rounds):
                    key, kr = jax.random.split(key)
                    c_act = (base_w if r < 3 else 4) * kk
                    ids, dists, _, flags = nnd_round(
                        kr, vecs, sq, ids, dists, kk, self.metric,
                        new_in=flags, c_active=c_act,
                        tile=_nnd_tile(nnd_cand_width(kk, c_act), self.dim),
                    )
                # drop edges into pad rows (their vectors are zeros)
                pad_edge = ids >= local_valid
                dists = jnp.where(pad_edge, _INF, dists)
                nd, pos = jax.lax.top_k(-dists, kk)
                ids = jnp.where(
                    jnp.isinf(nd), m,
                    jnp.take_along_axis(ids, pos, axis=-1),
                ).astype(jnp.int32)
                dists = -nd
            # pad rows own no edges
            row_pad = jnp.arange(m, dtype=jnp.int32) >= local_valid
            ids = jnp.where(row_pad[:, None], m, ids)
            dists = jnp.where(row_pad[:, None], _INF, dists)

            key, kp = jax.random.split(key)
            pruned = cagra_prune(vecs, sq, ids, dists, self.out_deg,
                                 self.metric)
            nav = add_reverse_edges(kp, pruned, m, max(rex, 1))
            nav = jnp.where(row_pad[:, None], m, nav)
            return ids, dists, nav

        self.vectors = jax.device_put(
            x, NamedSharding(self.mesh, P(DB_AXIS))
        )
        self.knn_ids_local, self.knn_dists, self.nav_local = build(
            self.vectors
        )
        self._seed = seed
        self._router_idx = None

    # -- query ---------------------------------------------------------------

    def _routers(self, m: int) -> np.ndarray:
        if self._router_idx is None:
            rng = np.random.default_rng(self._seed)
            s = min(m, max(64, 4 * int(math.isqrt(m))))
            self._router_idx = np.sort(
                rng.permutation(m)[:s].astype(np.int32)
            )
        return self._router_idx

    def _grid_batch(self) -> int:
        """Query-batch shards on 2-D ``(batch, db)`` grids, else 1."""
        names = getattr(self.mesh, "axis_names", ())
        return self.mesh.shape[BATCH_AXIS] if BATCH_AXIS in names else 1

    def query(
        self,
        query_mat,
        k: int,
        beam: int | None = None,
        iters: int | None = None,
        expand: int = 4,
        n_entries: int = 8,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Per-shard beam search → all_gather merge along ``db``.

        On a 1-D mesh queries are replicated (every device searches every
        query against its sub-graph). On a 2-D ``(batch, db)`` grid the
        query batch additionally shards along ``batch`` — the same walk
        economics per device on 1/nb of the queries, so throughput scales
        with the full mesh instead of only the db axis."""
        q = jnp.asarray(as_f32_matrix(query_mat))
        if self.metric == Dist.COSINE:
            q = normalise(q)
        k = max(1, min(k, self.n))
        m = self.shard_rows
        beam = min(beam if beam is not None else max(32, 2 * k), m)
        iters = iters if iters is not None else max(8, beam // 4)
        routers = jnp.asarray(self._routers(m))
        ne = min(n_entries, beam, m)
        kl = min(k, m)  # per-shard candidates

        nb = self._grid_batch()
        nq_in = q.shape[0]
        if nb > 1:
            pad = (-nq_in) % nb
            if pad:
                q = jnp.concatenate([q, jnp.zeros((pad, self.dim), q.dtype)])
            q = jax.device_put(q, NamedSharding(self.mesh, P(BATCH_AXIS)))
        q_spec = P(BATCH_AXIS) if nb > 1 else P()

        @functools.partial(
            _shard_map,
            mesh=self.mesh,
            in_specs=(q_spec, P(DB_AXIS), P(DB_AXIS), P()),
            out_specs=(q_spec, q_spec),
            check_vma=False,
        )
        def run(qq, x_shard, nav_shard, rt):
            my = jax.lax.axis_index(DB_AXIS)
            base = my * m
            local_valid = jnp.clip(self.n - base, 0, m)
            vecs = jnp.concatenate(
                [x_shard, jnp.zeros((1, self.dim), jnp.float32)]
            )
            sq = sq_norms(vecs)
            graph = jnp.concatenate(
                [nav_shard, jnp.full((1, nav_shard.shape[1]), m, jnp.int32)]
            )
            # routed entries: exact scan of the (valid-masked) router sample
            rt = jnp.where(rt < local_valid, rt, 0)
            rv = vecs[rt]
            dots = jax.lax.dot_general(
                qq, rv, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            if self.metric == Dist.COSINE:
                rd = 1.0 - dots
            else:
                rd = sq[rt][None, :] - 2.0 * dots
            _, pos = jax.lax.top_k(-rd, ne)
            entries = rt[pos]
            # f32-grade candidate scoring (single-pass bf16 dots put
            # ~‖q‖‖x‖·2⁻⁹ of error on every beam distance — self-query
            # came back ≈0.4 off without the split, same reason the
            # single-chip _cagra_query always passes vectors_hl)
            d, i = beam_search(
                qq, vecs, sq, graph, entries, kl, beam, iters, self.metric,
                expand=expand, vectors_hl=mantissa_split(vecs, 2),
            )
            gi = jnp.where(i >= local_valid, self.n, base + i)
            d = jnp.where(gi >= self.n, _INF, d)
            dg = jax.lax.all_gather(d, DB_AXIS, axis=1, tiled=True)
            ig = jax.lax.all_gather(gi, DB_AXIS, axis=1, tiled=True)
            md, pos = topk_smallest(dg, k)
            return md, jnp.take_along_axis(ig, pos, axis=-1)

        d, i = run(q, self.vectors, self.nav_local, routers)
        return (
            np.clip(np.asarray(i)[:nq_in], 0, self.n - 1),
            np.asarray(d)[:nq_in],
        )

    # -- self-kNN ------------------------------------------------------------

    def generate_knn(
        self, k: int, mode: str = "graph", flop_budget: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Global self-kNN rows.

        ``mode="graph"`` routes by per-device FLOP cost: the exact block
        ring (:func:`ring_self_knn`, n²·d/P MACs per device — the
        distributed analogue of the single-chip brute budget) while it fits
        ``flop_budget`` (default ``models.graph.BRUTE_BUILD_FLOP_BUDGET``),
        else the APPROXIMATE beam ring (:meth:`_ring_self_knn_beam`): each
        travelling block is beam-searched against the hosting device's
        sub-graph and the per-hop candidates merge as the block rides the
        ring — walk-cost FLOPs instead of a full scan. ``mode="search"``
        beam-searches every stored vector through :meth:`query` (P×
        redundant compute; use for spot checks).
        """
        k = min(k, self.n - 1)
        if mode == "search":
            return self.query(np.asarray(self.vectors[: self.n]), k)
        budget = (
            flop_budget if flop_budget is not None else BRUTE_BUILD_FLOP_BUDGET
        )
        per_device_macs = self.shard_rows * self.n_pad * self.dim
        if per_device_macs <= budget:
            ids, dists = ring_self_knn(
                self.vectors, k, self.metric, self.n, self.mesh
            )
        else:
            ids, dists = self._ring_self_knn_beam(k)
        return (
            np.clip(np.asarray(ids)[: self.n], 0, self.n - 1),
            np.asarray(dists)[: self.n],
        )

    def _ring_self_knn_beam(
        self,
        k: int,
        beam: int | None = None,
        iters: int | None = None,
        expand: int = 4,
        n_entries: int = 8,
    ) -> tuple[jax.Array, jax.Array]:
        """Approximate self-kNN ring: blocks of vectors ride the ``db``
        ring; at each hop the hosting device BEAM-SEARCHES the visiting
        block against its local sub-graph (routed entries, f32-grade
        scores) instead of exact-scanning it, and the block's travelling
        top-k merges hop by hop. Per-device cost is P walk batches of m
        rows — independent of n per hop — versus the exact ring's
        m·n·d MACs. Self-pairs masked by global id."""
        ndev = self.mesh.shape[DB_AXIS]
        m = self.shard_rows
        n_valid = self.n
        beam = min(beam if beam is not None else max(32, 2 * k), m)
        iters = iters if iters is not None else max(8, beam // 4)
        routers = jnp.asarray(self._routers(m))
        ne = min(n_entries, beam, m)
        kl = min(k + 1, m)
        metric = self.metric

        @functools.partial(
            _shard_map,
            mesh=self.mesh,
            in_specs=(P(DB_AXIS), P(DB_AXIS), P()),
            out_specs=(P(DB_AXIS), P(DB_AXIS)),
            check_vma=False,
        )
        def run(x_shard, nav_shard, rt):
            my = jax.lax.axis_index(DB_AXIS)
            vecs = jnp.concatenate(
                [x_shard, jnp.zeros((1, self.dim), jnp.float32)]
            )
            sq = sq_norms(vecs)
            graph = jnp.concatenate(
                [nav_shard, jnp.full((1, nav_shard.shape[1]), m, jnp.int32)]
            )
            vecs_hl = mantissa_split(vecs, 2)
            local_valid = jnp.clip(n_valid - my * m, 0, m)
            rt_l = jnp.where(rt < local_valid, rt, 0)
            rv = vecs[rt_l]
            rsq = sq[rt_l]

            blk = x_shard
            owner_base = my * m
            best_d = jnp.full((m, k), _INF)
            best_i = jnp.full((m, k), n_valid, jnp.int32)

            def step(s, carry):
                blk, owner_base, best_d, best_i = carry
                host_base = jax.lax.axis_index(DB_AXIS) * m
                gid_rows = owner_base + jnp.arange(m, dtype=jnp.int32)
                # routed entries for the visiting block
                dots = jax.lax.dot_general(
                    blk, rv, (((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32,
                )
                rd = 1.0 - dots if metric == Dist.COSINE else rsq[None, :] - 2.0 * dots
                _, pos = jax.lax.top_k(-rd, ne)
                entries = rt_l[pos]
                d, i = beam_search(
                    blk, vecs, sq, graph, entries, kl, beam, iters, metric,
                    expand=expand, vectors_hl=vecs_hl,
                )
                gi = jnp.where(i >= local_valid, n_valid, host_base + i)
                d = jnp.where(
                    (gi == gid_rows[:, None]) | (gi >= n_valid), _INF, d
                )
                best_d2, best_i2 = merge_topk(best_d, best_i, d, gi, k)
                perm = _ring_perm(ndev)
                return (
                    jax.lax.ppermute(blk, DB_AXIS, perm),
                    jax.lax.ppermute(owner_base, DB_AXIS, perm),
                    jax.lax.ppermute(best_d2, DB_AXIS, perm),
                    jax.lax.ppermute(best_i2, DB_AXIS, perm),
                )

            blk, owner_base, best_d, best_i = jax.lax.fori_loop(
                0, ndev, step, (blk, owner_base, best_d, best_i)
            )
            row_pad = (my * m + jnp.arange(m, dtype=jnp.int32)) >= n_valid
            best_d = jnp.where(row_pad[:, None], _INF, best_d)
            best_i = jnp.where(
                row_pad[:, None] | jnp.isinf(best_d), n_valid, best_i
            )
            return best_d, best_i

        d, i = run(self.vectors, self.nav_local, routers)
        return i, d

    def memory_usage_bytes(self) -> int:
        return 4 * int(
            self.vectors.size
            + self.knn_ids_local.size
            + self.knn_dists.size
            + self.nav_local.size
        )
