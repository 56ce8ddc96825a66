"""Vamana (DiskANN-style) index.

JAX rebuild of the reference ``VamanaIndex`` (``src/cpu/vamana.rs``): a flat
fixed-degree graph built with α-robust pruning, queried by beam search from a
medoid entry point. The reference builds it with two parallel passes of
per-node beam-search + locked reverse-edge insertion (vamana.rs:427-559);
pointer-chasing inserts don't map to batched accelerator programs, so
construction is re-based on the batched NN-descent rounds (the candidate pool a
beam search would find is approximated by the converged kNN neighbourhood),
followed by batched α-robust pruning — the same graph family with the same
α-controlled diversification knob.

Robust prune (vamana.rs:665-700): keep neighbour v unless some already-kept
closer neighbour w has ``α · d(w, v) < d(u, v)``; α > 1 keeps longer-range
"highway" edges that pure kNN graphs lack.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.graph import add_reverse_edges, beam_search, random_init_graph
from ..utils.dist import Dist, normalise, sq_norms
from .base import BaseIndex, as_f32_matrix

__all__ = ["VamanaIndex", "robust_prune"]

_INF = jnp.float32(jnp.inf)


@functools.partial(
    jax.jit,
    static_argnames=("k", "beam", "iters", "expand", "n_entries", "qb",
                     "metric"),
)
def _vamana_query(
    q, vectors, sqnorms, graph, medoid_arr, router_ids, hl, packed,
    *, k, beam, iters, expand, n_entries, qb, metric,
):
    """Routed-entry beam search, ONE jitted dispatch.

    The reference walks from the single medoid (vamana.rs:781-865), paying
    a graph-diameter-long descent per query; here a sampled router set is
    scanned exactly (one [nq, S] matmul — the same entry routing as the
    CAGRA path, models/graph._cagra_query) and the medoid is kept as one
    entry, so the walk starts near the target and the iteration budget
    drops ~2× for the same recall."""
    nq = q.shape[0]
    rv = vectors[router_ids]
    dots = jax.lax.dot_general(
        q, rv, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    if metric == Dist.COSINE:
        rd = 1.0 - dots
    else:
        rd = sqnorms[router_ids][None, :] - 2.0 * dots
    _, pos = jax.lax.top_k(-rd, max(n_entries - 1, 1))
    entries = jnp.concatenate(
        [
            router_ids[pos],
            jnp.broadcast_to(medoid_arr[None, :], (nq, 1)).astype(jnp.int32),
        ],
        axis=-1,
    )
    ne = entries.shape[1]
    pad = (-nq) % qb
    if pad:
        q = jnp.concatenate([q, jnp.zeros((pad, q.shape[1]), q.dtype)])
        entries = jnp.concatenate(
            [entries, jnp.zeros((pad, ne), entries.dtype)]
        )

    def run(args):
        qq, ee = args
        return beam_search(
            qq, vectors, sqnorms, graph, ee, k, beam, iters, metric, expand,
            vectors_hl=hl if hl else None, packed_nbrs=packed,
        )

    d, i = jax.lax.map(
        run, (q.reshape(-1, qb, q.shape[1]), entries.reshape(-1, qb, ne))
    )
    return d.reshape(-1, k)[:nq], i.reshape(-1, k)[:nq]


@functools.partial(jax.jit, static_argnames=("out_deg", "metric", "tile"))
def robust_prune(
    vectors: jax.Array,      # [n+1, d]
    sqnorms: jax.Array,      # [n+1]
    graph_ids: jax.Array,    # [n, kk] asc by dist
    graph_dists: jax.Array,  # [n, kk]
    alpha: float,
    out_deg: int,
    metric: Dist,
    tile: int = 256,
) -> jax.Array:
    """Batched α-robust prune. Sequential dependence on "already kept" is
    approximated by rank order (candidates arrive ascending by distance, so
    "kept earlier" ⊆ "ranked earlier" — the same relaxation as CAGRA's rank
    prune, which the reference GPU path also uses)."""
    n, kk = graph_ids.shape
    n_pad = -(-n // tile) * tile

    def block(u):
        u_safe = jnp.minimum(u, n - 1)
        nbrs = graph_ids[u_safe]
        nd = graph_dists[u_safe]
        safe = jnp.minimum(nbrs, n)
        nv = vectors[safe]
        nsq = sqnorms[safe]
        dots = jnp.einsum(
            "tkd,tmd->tkm",
            nv.astype(jnp.bfloat16),
            nv.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
        if metric == Dist.COSINE:
            pair = 1.0 - dots
        else:
            pair = jnp.maximum(
                nsq[:, :, None] + nsq[:, None, :] - 2.0 * dots, 0.0
            )
        rank_lt = (
            jnp.arange(kk)[None, :, None] < jnp.arange(kk)[None, None, :]
        )
        dominated = (alpha * pair) < nd[:, None, :]
        invalid_w = (nbrs >= n)[:, :, None]
        pruned = jnp.any(rank_lt & dominated & ~invalid_w, axis=1)
        pruned = pruned | (nbrs >= n)
        keep_key = jnp.where(pruned, 1.0, 0.0) * 1e6 + jnp.arange(kk)[None, :]
        order = jnp.argsort(keep_key, axis=-1)
        return jnp.take_along_axis(nbrs, order[:, :out_deg], axis=-1)

    us = jnp.arange(n_pad).reshape(-1, tile)
    out = jax.lax.map(block, us)
    return out.reshape(n_pad, out_deg)[:n]


class VamanaIndex(BaseIndex):
    """Fixed-degree α-pruned graph with medoid entry."""

    _fallback_vectors = BaseIndex._fallback_from_vectors

    _state_arrays = ("vectors", "sqnorms", "graph", "medoid_arr")
    _state_scalars = ("n", "dim", "r_degree")

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        r_degree: int = 32,
        alpha: float = 1.2,
        build_k: int | None = None,
        n_trees: int = 2,
        max_rounds: int = 8,
        seed: int = 42,
        verbose: bool = False,
    ):
        self._capture_f64(mat)  # f64 rescore path (models/base)
        super().__init__(mat, metric)
        n = self.n
        self.r_degree = min(r_degree, max(n - 1, 1))
        # build_k does NOT scale with R: the prune pool is completed by the
        # second-pass visited-set trails below (reference vamana.rs:427-559),
        # so the base kNN graph only needs enough breadth to seed it. NND
        # round cost grows with build_k² (the kk² neighbours-of-neighbours
        # set) — 2·R at R=64 made builds 3× slower for no recall gain.
        build_k = min(
            build_k if build_k is not None else max(48, self.r_degree),
            max(n - 1, 1),
        )

        vecs = jnp.concatenate(
            [self.vectors, jnp.zeros((1, self.dim), jnp.float32)]
        )
        sq = sq_norms(vecs)
        self.vectors = vecs
        self.sqnorms = sq

        import time as _time

        def _mark(label, t0, arr=None):
            if verbose:
                if arr is not None:
                    jax.block_until_ready(arr)
                print(f"vamana build: {label} {_time.time() - t0:.1f}s",
                      flush=True)
            return _time.time()

        key = jax.random.key(seed)
        key, k0 = jax.random.split(key)
        # base kNN pool: exact matmul scan below the FLOP budget, forest+NND
        # rounds above it (same economics inversion as the other graph
        # builds)
        from .hnsw import _build_knn_graph

        t0 = _time.time()
        ids, dists = _build_knn_graph(
            k0, vecs, sq, build_k, self.metric, n_trees, max_rounds
        )
        t0 = _mark("base kNN pool", t0, dists)

        # Mix random long-range candidates into the prune pool: the
        # reference's random-R init (vamana.rs:89-118) is what gives Vamana
        # its cross-cluster "highway" edges — a pure kNN pool has none, and
        # α-pruning can only select, not create. Random far candidates that
        # no kept closer neighbour dominates survive the α test, which is
        # exactly the highway property.
        key, krnd = jax.random.split(key)
        rand_ids, rand_dists = random_init_graph(
            krnd, vecs, sq, self.r_degree, self.metric
        )
        from ..ops.graph import _merge_rows

        pool_k = build_k + self.r_degree
        ids, dists = _merge_rows(ids, dists, rand_ids, rand_dists, pool_k)

        # medoid: closest stored vector to the mean (reference compute_medoid
        # vamana.rs:251-311 — exact argmin of distance to the centroid)
        mean = jnp.mean(vecs[:n], axis=0, keepdims=True)
        d_mean = (
            sq[:n]
            - 2.0 * (vecs[:n] @ mean[0])
        )
        self.medoid_arr = jnp.argmin(d_mean).astype(jnp.int32).reshape(1)

        # first-pass α-robust prune (reference runs α₁=1.0 then α₂,
        # vamana.rs:427-559)
        key, kp = jax.random.split(key)
        pruned = robust_prune(
            vecs, sq, ids, dists, alpha, self.r_degree, self.metric
        )
        graph0 = add_reverse_edges(kp, pruned, n, self.r_degree // 2)
        graph0 = jnp.concatenate(
            [graph0, jnp.full((1, graph0.shape[1]), n, jnp.int32)]
        )
        t0 = _mark("first-pass prune", t0, graph0)

        # second pass (the step that gives Vamana its quality in the
        # reference): each node's prune pool is completed with the VISITED
        # SET of a beam search for itself from the medoid over the
        # first-pass graph — the batched analogue of vamana.rs's
        # greedy_search → robust_prune insert loop. Trails contribute the
        # medium-range stepping stones a kNN pool lacks; α-pruning over
        # them yields the cross-cluster highway edges.
        pool_k = build_k + self.r_degree
        ids, dists = self._second_pass_pool(
            vecs, sq, graph0, ids, dists, pool_k
        )
        t0 = _mark("second-pass trails", t0, dists)
        pruned = robust_prune(
            vecs, sq, ids, dists, alpha, self.r_degree, self.metric
        )
        key, kp2 = jax.random.split(key)
        graph = add_reverse_edges(kp2, pruned, n, self.r_degree // 2)
        self.graph = jnp.concatenate(
            [graph, jnp.full((1, graph.shape[1]), n, jnp.int32)]
        )
        _mark("second-pass prune", t0, self.graph)

    @property
    def medoid(self) -> int:
        return int(self.medoid_arr[0])

    def _second_pass_pool(self, vecs, sq, graph0, ids, dists, pool_k):
        """Merge each node's beam-search visited-set trail (from the
        medoid, over the first-pass graph) into its prune pool — the
        batched form of the reference's second build pass
        (vamana.rs:427-559: greedy_search(V) feeds robust_prune)."""
        n = self.n
        medoid = self.medoid_arr
        beam = min(32, max(n, 1))
        iters = 12
        expand = 4
        # Trail cost scales with the walk graph's degree twice over: the
        # packed-row gather is deg·(2d+2) wide and the bitonic merge width
        # P is pow2(expand·deg). At r64 the first-pass graph is 96 wide
        # (R + R/2 reverse), which would make this pass ~3-4× the r32 cost.
        # The walk only needs a NAVIGABLE graph, not the full prune pool —
        # so cap the trail graph at 48 edges/node: the closest 24 (local
        # steps) plus an even stride over the remaining ranks (the α-kept
        # far edges + reverse fill that give the walk its cross-cluster
        # highways).
        trail_cap = 48
        deg0 = int(graph0.shape[1])
        if deg0 > trail_cap:
            near = trail_cap // 2
            far_idx = np.unique(
                np.linspace(near, deg0 - 1, trail_cap - near).astype(np.int64)
            )
            cols = np.concatenate([np.arange(near), far_idx])
            graph0 = graph0[:, jnp.asarray(cols)]
        # the packed-neighbour table is what makes query-time beams fast
        # (expand multi-KB DMAs instead of expand·deg 64-128 B gathers);
        # the build-time trail pass is the same beam kernel over all n
        # nodes and was paying the slow gather path — 15.7 s of a 17.3 s
        # warm r32 build at 150k×32d was this one call
        from ..ops.graph import maybe_pack_neighbors

        packed0 = maybe_pack_neighbors(vecs, sq, graph0)

        @functools.partial(
            jax.jit, static_argnames=("beam", "iters", "expand", "qb",
                                      "metric", "pool_k"),
        )
        def run(vecs, sq, graph0, packed0, ids, dists, medoid, *, beam,
                iters, expand, qb, metric, pool_k):
            nq = n
            q = vecs[:n]
            pad = (-nq) % qb
            if pad:
                q = jnp.concatenate(
                    [q, jnp.zeros((pad, q.shape[1]), q.dtype)]
                )
            entries = jnp.broadcast_to(
                medoid[None, :], (q.shape[0], 1)
            ).astype(jnp.int32)

            def blk(args):
                qq, ee = args
                _, _, td, tids = beam_search(
                    qq, vecs, sq, graph0, ee, 1, beam, iters, metric,
                    expand, packed_nbrs=packed0, return_trail=True,
                )
                return td, tids

            td, tids = jax.lax.map(
                blk,
                (
                    q.reshape(-1, qb, q.shape[1]),
                    entries.reshape(-1, qb, 1),
                ),
            )
            tw = td.shape[-1]
            td = td.reshape(-1, tw)[:n]
            tids = tids.reshape(-1, tw)[:n]
            # a node's own trail visits itself — mask self-edges
            self_row = tids == jnp.arange(n, dtype=jnp.int32)[:, None]
            td = jnp.where(self_row | (tids >= n), jnp.inf, td)
            from ..ops.graph import _merge_rows

            return _merge_rows(ids, dists, tids, td, pool_k)

        qb = min(1024, max(n, 8))
        return run(
            vecs, sq, graph0, packed0, ids, dists, medoid,
            beam=beam, iters=iters, expand=expand, qb=qb,
            metric=self.metric, pool_k=pool_k,
        )

    def query(
        self,
        query_mat: Any,
        k: int,
        beam: int | None = None,
        iters: int | None = None,
        expand: int = 4,
        n_entries: int = 8,
        query_block: int = 1024,
        exact_fallback: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Routed-entry beam search; medoid kept as one entry
        (vamana.rs:781-865 walks from the single medoid — see
        ``_vamana_query`` for why routing replaces the long descent)."""
        r = self._f64_roundtrip(query_mat, k, beam=beam, iters=iters, expand=expand, n_entries=n_entries, query_block=query_block, exact_fallback=exact_fallback)
        if r is not None:
            return r
        q = self._prep_queries(query_mat)
        if exact_fallback and self._exact_fallback_ok(q.shape[0]):
            return self._exact_query_small(q, self._clamp_k(k))
        k = self._clamp_k(k)
        beam = min(beam if beam is not None else max(32, 2 * k), self.n)
        # routed entries start the walk near the target — same iteration
        # economics as the CAGRA path (iters ≈ beam/4)
        iters = iters if iters is not None else max(8, beam // 4)
        n_entries = max(2, min(n_entries, beam, self.n))

        if not hasattr(self, "_router_ids") or self._router_ids is None:
            n_routers = min(self.n, max(256, 4 * int(math.isqrt(self.n))))
            self._router_ids = jax.random.permutation(
                jax.random.PRNGKey(7), self.n
            )[:n_routers].astype(jnp.int32)

        if not hasattr(self, "_nav_hl"):
            from ..ops.graph import nav_hl_split

            self._nav_hl = nav_hl_split(self.vectors)
        if not hasattr(self, "_packed_nbrs"):
            from ..ops.graph import maybe_pack_neighbors

            self._packed_nbrs = maybe_pack_neighbors(
                self.vectors, self.sqnorms, self.graph
            )

        qb = min(query_block, max(q.shape[0], 8))
        d, i = _vamana_query(
            q, self.vectors, self.sqnorms, self.graph, self.medoid_arr,
            self._router_ids,
            self._nav_hl if self._nav_hl is not None else (),
            self._packed_nbrs,
            k=k, beam=beam, iters=iters, expand=expand,
            n_entries=n_entries, qb=qb, metric=self.metric,
        )
        return np.clip(np.asarray(i), 0, self.n - 1), np.asarray(d)

    def generate_knn(self, k: int, **kw):
        return self.query(np.asarray(self.vectors[: self.n]), k, **kw)

    def vectors_original_order(self) -> np.ndarray:
        return np.asarray(self.vectors[: self.n])

    def _prep_queries(self, query_mat):
        q = as_f32_matrix(query_mat)
        if q.shape[1] != self.dim:
            raise ValueError(f"query dim {q.shape[1]} != index dim {self.dim}")
        qj = jnp.asarray(q)
        return normalise(qj) if self.metric == Dist.COSINE else qj

    def _post_load(self):
        self.r_degree = int(self.r_degree)
