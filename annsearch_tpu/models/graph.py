"""Graph index: NN-descent construction + CAGRA-style beam-search query.

JAX rebuild of the reference's graph family — CPU ``NNDescent``
(src/cpu/nndescent.rs), GPU ``NNDescentGpu`` + CAGRA
(src/gpu/nndescent_gpu.rs, cagra_gpu_search.rs). One index covers both
roles the reference splits across them:

  * ``knn_graph``  — the true kNN graph (``extract_knn`` /
    ``generate_knn(mode="graph")``), the reference's headline "full kNN
    graph in seconds" use-case;
  * ``nav_graph``  — the CAGRA-pruned navigable graph used by
    ``query`` (batched fixed-iteration beam search).

Build pipeline (all batched rounds, ops/graph.py):
  random init → RP-forest passes → NN-descent expansion rounds until the
  update rate drops below ``delta`` (reference convergence loop,
  nndescent_gpu.rs:1548-1652, default delta 0.001) → CAGRA detour-prune +
  reverse-edge fill.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.graph import (
    NND_R_NEW,
    NND_R_OLD,
    add_reverse_edges,
    beam_search,
    cagra_prune,
    diversify_graph,
    kmeans_leaves,
    leaf_join_merge,
    nnd_cand_width,
    nnd_round_chunked,
    random_init_graph,
    rp_forest_round,
)
from ..utils.dist import Dist, normalise, sq_norms
from .base import BaseIndex, as_f32_matrix

__all__ = ["NNDescentIndex", "approx_knn_graph"]

#: below this n²·d FLOP count the exact tensor-core self-scan beats
#: approximate rounds (NN-descent at 1M×32d plateaus near 0.72 graph recall
#: where the exact scan is exact). The value predates the GPU and is
#: unmeasured there.
BRUTE_BUILD_FLOP_BUDGET = 1_000_000 * 1_000_000 * 256


def _nnd_tile(width: int, dim: int) -> int:
    """Rows per nnd_round map step, sized so the candidate-vector gather
    (+ its hi/lo split copies) stays ≤ ~512 MB of HBM transients. The old
    fixed tile=256 made 1M-row rounds dispatch-bound: 3,907 tiny sequential
    map steps ≈ 35 s/round for ~4 GB of useful traffic."""
    per_row = width * dim * 12  # cand f32 + hi + lo parts
    return max(256, min(4096, ((1 << 29) // per_row) // 256 * 256))


def approx_knn_graph(
    key: jax.Array,
    vecs: jax.Array,          # [n+1, d] (sentinel last row)
    sq: jax.Array,            # [n+1]
    kk: int,
    metric: Dist,
    *,
    n_trees: int = 4,
    max_rounds: int = 40,
    delta: float = 0.001,
    seed: int = 42,
    verbose: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Approximate kk-NN graph: k-means partition joins + rate-adaptive
    NN-descent rounds. The build path shared by every graph-family index
    above the brute tensor-core budget (NNDescent / HNSW layers / Vamana pools).

    Partition passes (ops/graph.kmeans_leaves): leaves grouped by the
    jth-nearest cell (jth rotates — spill assignment) co-locate true
    neighbours far more often than random-projection splits, and the join
    itself is pure GEMM. One RP-tree pass is kept for partition diversity.

    Rounds are rate-adaptive: the reference's local joins process each
    node's FULL new-edge lists every round (nndescent.rs:849-917) — that is
    what gives NN-descent its quadratic convergence; fixed 4-block sampling
    alone decays the update rate only ~0.82×/round at 1M (measured: recall
    stuck at 0.64 after 10 rounds). So: full-width expansion while the
    graph still churns, cheap sampled blocks for the tail rounds (the
    switch latches — no recompile ping-pong). Stops on two consecutive
    rounds below ``delta`` (one quiet sampled round can be sampling luck;
    reference loop semantics nndescent_gpu.rs:1548-1652)."""
    n = vecs.shape[0] - 1
    dim = vecs.shape[1]
    key, k_init = jax.random.split(key)
    ids, dists = random_init_graph(k_init, vecs, sq, kk, metric)

    leaf = max(16, min(256, n // 8))
    from .kmeans import train_centroids

    cents = train_centroids(
        vecs[:n], max(64, n // (2 * leaf)), metric, seed=seed
    )
    levels = max(1, int(math.ceil(math.log2(max(n / leaf, 2)))))
    for t in range(n_trees):
        key, kt = jax.random.split(key)
        if t == n_trees - 1:
            ids, dists = rp_forest_round(
                kt, vecs, sq, ids, dists, levels, leaf, kk, metric
            )
        else:
            leaves = kmeans_leaves(kt, vecs, cents, t % 3, leaf, metric)
            ids, dists = leaf_join_merge(
                leaves, vecs, sq, ids, dists, kk, metric
            )
        if verbose:
            print(f"partition pass {t + 1}/{n_trees} done")

    total_edges = n * kk
    flags = jnp.ones((n, kk), bool)  # everything starts new
    quiet = 0
    rate = 1.0
    base_w = kk + NND_R_NEW + NND_R_OLD   # every block selectable
    full = True
    # bound each dispatch's candidate traffic (~width·d·chunk): full-width
    # rounds move ~10× the data of sampled ones, and at ≥ 8M rows even the
    # 131k chunk makes multi-minute dispatches — quarter the chunk there
    full_chunk = 131_072 if n < 8_000_000 else 32_768
    samp_chunk = 1_048_576 if n < 8_000_000 else 262_144
    # at ≥8M rows hold the full-width phase one threshold longer: sampled
    # tail rounds move ~120k edges/round at 10M and cannot recover a
    # too-early switch (measured 0.83 graph recall at bk24 with the 0.02
    # latch vs 0.99 at 1M where 0.02 suffices)
    full_latch = 0.02 if n < 8_000_000 else 0.01
    for r in range(max_rounds):
        key, kr = jax.random.split(key)
        full = full and rate >= full_latch
        c_act = (base_w if full else 4) * kk
        ids, dists, upd, flags = nnd_round_chunked(
            kr, vecs, sq, ids, dists, kk, metric,
            new_in=flags, c_active=c_act,
            tile=_nnd_tile(nnd_cand_width(kk, c_act), dim),
            row_chunk=full_chunk if full else samp_chunk,
        )
        rate = float(upd) / max(total_edges, 1)
        if verbose:
            print(
                f"nnd round {r + 1} ({'full' if full else 'sampled'}):"
                f" update rate {rate:.4f}"
            )
        quiet = quiet + 1 if rate < delta else 0
        if quiet >= 2:
            break
    return ids, dists


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "beam", "iters", "expand", "n_entries", "qb", "metric"
    ),
)
def _cagra_query(
    q, vectors, sqnorms, nav_graph, router_ids, hl, packed,
    *, k, beam, iters, expand, n_entries, qb, metric,
):
    """Route → beam-search, ONE jitted dispatch (eager per-op routing and
    padding would pay a host round trip per op)."""
    nq = q.shape[0]
    # entry routing: exact scan of the router sample
    rv = vectors[router_ids]
    dots = jax.lax.dot_general(
        q, rv, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    if metric == Dist.COSINE:
        rd = 1.0 - dots
    else:
        rd = sqnorms[router_ids][None, :] - 2.0 * dots
    _, pos = jax.lax.top_k(-rd, n_entries)
    entries = router_ids[pos]

    pad = (-nq) % qb
    if pad:
        q = jnp.concatenate([q, jnp.zeros((pad, q.shape[1]), q.dtype)])
        entries = jnp.concatenate(
            [entries, jnp.zeros((pad, n_entries), entries.dtype)]
        )

    def run(args):
        qq, ee = args
        return beam_search(
            qq, vectors, sqnorms, nav_graph, ee, k, beam, iters, metric,
            expand, vectors_hl=hl if hl else None, packed_nbrs=packed,
        )

    d, i = jax.lax.map(
        run, (q.reshape(-1, qb, q.shape[1]), entries.reshape(-1, qb, n_entries))
    )
    return d.reshape(-1, k)[:nq], i.reshape(-1, k)[:nq]


class NNDescentIndex(BaseIndex):
    """kNN-graph + navigable-graph index."""

    _fallback_vectors = BaseIndex._fallback_from_vectors

    _state_arrays = (
        "vectors", "sqnorms", "knn_ids", "knn_dists", "nav_graph",
        "router_ids",
    )
    _state_scalars = ("n", "dim", "k_build", "out_deg")

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        k: int = 30,
        build_k: int | None = None,
        n_trees: int = 4,
        max_rounds: int = 40,
        delta: float = 0.001,
        out_deg: int | None = None,
        reverse_extra: int | None = None,
        refine_rounds: int = 0,
        diversify_prob: float = 0.0,
        seed: int = 42,
        verbose: bool = False,
        has_sentinel: bool = False,
    ):
        """``refine_rounds``: optional two-hop refinement sweeps after
        convergence (reference two_hop_refinement, nndescent_gpu.rs:686-825)
        — one full k² neighbour-of-neighbour pass each, no new/old
        filtering; squeezes out the last recall the incremental rounds
        miss.

        ``diversify_prob``: probability of pruning occluded (redundant)
        kNN-graph edges after build (reference diversify_graph,
        nndescent.rs:954-1010; 0 disables). Pruned slots report the
        sentinel id at +inf distance, exactly like the reference's
        sentinel-padded rows.

        ``has_sentinel=True``: ``mat`` is ``[n+1, dim]`` with a ZERO last
        row and is adopted as the sentinel-padded vector table WITHOUT the
        usual concat copy (appending a sentinel to an existing device
        array transiently doubles residency — 2×5.1 GB at 10M×128d, an
        OOM; ``utils.data.generate_clustered_data_device(sentinel=True)``
        emits the padded layout for free). Host (numpy) inputs are
        validated; device-array inputs are TRUSTED — a nonzero last row
        would silently corrupt sentinel distances, and reading it back
        through the device link on every build defeats the zero-copy
        point."""
        if has_sentinel and isinstance(mat, np.ndarray):
            if mat.shape[0] < 1 or np.any(mat[-1]):
                raise ValueError(
                    "has_sentinel=True requires a zero last row"
                )
        self._capture_f64(mat)  # f64 rescore path (models/base)
        super().__init__(mat, metric)
        if has_sentinel:
            self.n -= 1
        n = self.n
        self.k_build = min(build_k if build_k is not None else 2 * k, max(n - 1, 1))
        self.out_deg = min(
            out_deg if out_deg is not None else max(k, 16), self.k_build
        )
        reverse_extra = (
            reverse_extra if reverse_extra is not None else self.out_deg // 2
        )

        # sentinel row n for safe gathers
        if has_sentinel:
            vecs = self.vectors
        else:
            vecs = jnp.concatenate(
                [self.vectors, jnp.zeros((1, self.dim), jnp.float32)]
            )
        sq = sq_norms(vecs)
        self.vectors = vecs
        self.sqnorms = sq

        key = jax.random.key(seed)
        if n * n * self.dim <= BRUTE_BUILD_FLOP_BUDGET:
            # Below this size the matrix units compute the EXACT kNN graph
            # faster than approximate rounds converge — an economics
            # inversion vs the reference's CPU/wgpu hardware where
            # NN-descent always wins.
            ids, dists = self._brute_knn_graph(vecs, sq)
            if verbose:
                print("graph built exactly (brute-force matmul path)")
        else:
            key, ka = jax.random.split(key)
            ids, dists = approx_knn_graph(
                ka, vecs, sq, self.k_build, self.metric,
                n_trees=n_trees, max_rounds=max_rounds, delta=delta,
                seed=seed, verbose=verbose,
            )

            base_w = self.k_build + NND_R_NEW + NND_R_OLD
            for r in range(refine_rounds):
                key, kr = jax.random.split(key)
                # all-new flags + full block budget ≡ an unfiltered two-hop
                # pass (reference two_hop_refinement), in bounded chunk
                # dispatches (a 1M-row full round as one program crashes
                # the worker — see nnd_round_chunked)
                c_act = base_w * self.k_build
                ids, dists, upd, _ = nnd_round_chunked(
                    kr, vecs, sq, ids, dists, self.k_build, self.metric,
                    new_in=jnp.ones((n, self.k_build), bool),
                    c_active=c_act,
                    tile=_nnd_tile(
                        nnd_cand_width(self.k_build, c_act), self.dim
                    ),
                    row_chunk=131_072 if n < 8_000_000 else 32_768,
                )
                if verbose:
                    print(
                        f"two-hop refinement {r + 1}/{refine_rounds}: "
                        f"{int(upd)} updates"
                    )

        if diversify_prob > 0.0:
            key, kd = jax.random.split(key)
            ids, dists = diversify_graph(
                kd, vecs, sq, ids, dists, diversify_prob, self.metric
            )
            if verbose:
                kept = int(jnp.sum(ids < n))
                print(
                    f"diversified: {kept}/{ids.size} edges kept "
                    f"(prob {diversify_prob})"
                )

        self.knn_ids = ids
        self.knn_dists = dists

        # The CAGRA navigable graph + entry routers are only needed for
        # `query`; `generate_knn(mode="graph")` users (the reference's
        # headline "full kNN graph in seconds" path) never pay for pruning —
        # built lazily on first query (the reference similarly separates
        # graph generation from search-index construction).
        self._reverse_extra = reverse_extra
        self.nav_graph = None
        self.router_ids = None
        self._seed = seed

    def _ensure_nav(self) -> None:
        """Build the CAGRA-pruned navigable graph + router sample on first
        use (reference cagra build, nndescent_gpu.rs:827-1056)."""
        if not hasattr(self, "_nav_hl"):
            from ..ops.graph import nav_hl_split

            self._nav_hl = nav_hl_split(self.vectors)
        if self.nav_graph is not None:
            return
        n = self.n
        key = jax.random.fold_in(jax.random.key(self._seed), 1)
        # entry-point routers: a sampled node set scanned exactly at query
        # time (replaces the reference's ForestRouter entry-point trees,
        # forest_gpu.rs:480-564 — one [bq, S] matmul instead of tree walks;
        # kNN graphs over clustered data are disconnected across clusters,
        # so routed entries are what makes beam search reach the right one)
        key, krt = jax.random.split(key)
        n_routers = min(n, max(256, 4 * int(math.isqrt(n))))
        self.router_ids = jax.random.permutation(krt, n)[:n_routers].astype(
            jnp.int32
        )
        key, kp = jax.random.split(key)
        pruned = cagra_prune(
            self.vectors, self.sqnorms, self.knn_ids, self.knn_dists,
            self.out_deg, self.metric,
        )
        nav = add_reverse_edges(kp, pruned, n, self._reverse_extra)
        # sentinel row for beam gathers
        self.nav_graph = jnp.concatenate(
            [nav, jnp.full((1, nav.shape[1]), n, jnp.int32)]
        )
        self._packed_nbrs = None

    def _ensure_packed(self) -> None:
        if getattr(self, "_packed_nbrs", None) is None:
            from ..ops.graph import maybe_pack_neighbors

            self._packed_nbrs = maybe_pack_neighbors(
                self.vectors, self.sqnorms, self.nav_graph
            )

    # -- queries -----------------------------------------------------------

    def query(
        self,
        query_mat: Any,
        k: int,
        beam: int | None = None,
        iters: int | None = None,
        expand: int = 4,
        n_entries: int = 8,
        seed: int | None = None,
        query_block: int = 1024,
        exact_fallback: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Beam-search query (reference cagra_search_batch_gpu defaults:
        BEAM_WIDTH 16·auto-scale, MAX_BEAM_ITERS≈3·bw, 8 random entries,
        cagra_gpu_search.rs:21-124). Small regimes route through the exact
        matmul scan (models/base.BRUTE_QUERY_FLOP_BUDGET economics
        inversion)."""
        r = self._f64_roundtrip(query_mat, k, beam=beam, iters=iters, expand=expand, n_entries=n_entries, seed=seed, query_block=query_block, exact_fallback=exact_fallback)
        if r is not None:
            return r
        q = self._prep_queries(query_mat)
        k = self._clamp_k(k)
        if exact_fallback and self._exact_fallback_ok(q.shape[0]):
            return self._exact_query_small(q, k)
        self._ensure_nav()
        self._ensure_packed()
        beam = beam if beam is not None else max(32, 2 * k)
        beam = min(beam, self.n)
        # measured on 150k×32d: 8–12 iterations saturate recall with routed
        # entries (0.982 at 8, 0.990 at 16); the old 3·beam/(2·expand)
        # formula over-iterated 2×
        iters = iters if iters is not None else max(8, beam // 4)
        n_entries = min(n_entries, beam, self.n)
        qb = min(query_block, max(q.shape[0], 8))
        d, i = _cagra_query(
            q, self.vectors, self.sqnorms, self.nav_graph, self.router_ids,
            self._nav_hl if self._nav_hl is not None else (),
            self._packed_nbrs,
            k=k, beam=beam, iters=iters, expand=expand,
            n_entries=n_entries, qb=qb, metric=self.metric,
        )
        return np.clip(np.asarray(i), 0, self.n - 1), np.asarray(d)

    def _brute_knn_graph(self, vecs, sq):
        """Exact kNN graph via the blocked tensor-core scan (self excluded)."""
        from ..ops.topk import blocked_query_topk

        n = self.n
        kk = min(self.k_build + 1, n)
        # HIGHEST: single-pass bf16 destroys neighbour order on
        # low-intrinsic-dim data, and even a 3-pass split loses the ~1e-3
        # neighbour gaps of 1M-point clusters (the dropped lo·lo term is
        # ~4e-3 of the squared norm)
        d, i = blocked_query_topk(
            vecs[:n], vecs[:n], kk, self.metric,
            x_sqnorm=sq[:n] if self.metric == Dist.EUCLIDEAN else None,
            precision=jax.lax.Precision.HIGHEST,
        )
        # drop the self column (first hit is self at distance ~0; if ties
        # shuffled it, mask any exact self id)
        self_col = i == jnp.arange(n)[:, None]
        d = jnp.where(self_col, jnp.inf, d)
        nd, pos = jax.lax.top_k(-d, self.k_build)
        ids = jnp.take_along_axis(i, pos, axis=-1)
        dists = -nd
        ids = jnp.where(jnp.isinf(dists), n, ids)
        return ids.astype(jnp.int32), dists

    def _route_entries(self, q: jax.Array, n_entries: int) -> jax.Array:
        """Exact scan of the router sample → top-n_entries node ids."""
        rv = self.vectors[self.router_ids]
        dots = jax.lax.dot_general(
            q, rv, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        if self.metric == Dist.COSINE:
            d = 1.0 - dots
        else:
            d = sq_norms(q)[:, None] + self.sqnorms[self.router_ids][None, :] - 2.0 * dots
        _, pos = jax.lax.top_k(-d, n_entries)
        return self.router_ids[pos]

    def generate_knn(
        self, k: int, mode: str = "graph", **kw
    ) -> tuple[np.ndarray, np.ndarray]:
        """Self-kNN. ``mode="graph"`` reads the built kNN graph directly
        (self excluded — matching the reference's extracted graph,
        nndescent.rs:527-548); ``mode="search"`` beam-searches every stored
        vector (reference query_nndescent_self)."""
        if mode == "graph":
            k = min(k, self.k_build)
            return (
                np.asarray(jnp.clip(self.knn_ids[:, :k], 0, self.n - 1)),
                np.asarray(self.knn_dists[:, :k]),
            )
        q = np.asarray(self.vectors[: self.n])
        return self.query(q, k, **kw)

    def vectors_original_order(self) -> np.ndarray:
        return np.asarray(self.vectors[: self.n])

    def _prep_queries(self, query_mat):
        q = as_f32_matrix(query_mat)
        if q.shape[1] != self.dim:
            raise ValueError(f"query dim {q.shape[1]} != index dim {self.dim}")
        qj = jnp.asarray(q)
        return normalise(qj) if self.metric == Dist.COSINE else qj

    def _post_load(self):
        self.k_build = int(self.k_build)
        self.out_deg = int(self.out_deg)
        self._seed = 42
        self._reverse_extra = self.out_deg // 2
