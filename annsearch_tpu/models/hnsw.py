"""HNSW index.

JAX rebuild of the reference ``HnswIndex`` (``src/cpu/hnsw.rs``): same
hierarchy semantics — exponential layer assignment capped at 15
(hnsw.rs:639-645), degree M on upper layers / 2M at the base, greedy upper
descent + base-layer beam (ef_search) — but construction is completely
re-based: the reference's phase-1/phase-2 locked concurrent inserts
(hnsw.rs:706-862, StripedLocks + torn-read-tolerant neighbour reads) are
pointer-chasing and don't map to batched accelerator programs, so every layer's
graph is built with batched rounds instead (exact kNN matmul for small layers,
NN-descent for large ones) followed by rank-based pruning — the Algorithm-4
heuristic's batched analogue.

Queries run the same two phases as the reference (hnsw.rs:1093-1278):
greedy (beam=1-ish) descent through upper layers to find an entry, then an
ef_search-wide beam on the base layer — both as the batched fixed-iteration
beam kernel.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.graph import add_reverse_edges, beam_search, cagra_prune
from ..ops.topk import topk_smallest
from ..utils.dist import Dist, normalise, pairwise_dist, sq_norms
from .base import BaseIndex, as_f32_matrix

__all__ = ["HnswIndex"]

MAX_LAYERS = 16  # reference caps layer assignment at 15 (hnsw.rs:639-645)
EXACT_LAYER_MAX = 4096  # layers this small get exact kNN graphs (one matmul)


def _build_knn_graph(
    key, vecs, sq, kk: int, metric: Dist, n_trees: int, max_rounds: int
):
    """(ids, dists) kNN graph over vecs[:-1] (sentinel last row)."""
    n = vecs.shape[0] - 1
    d_dim = vecs.shape[1]
    kk = min(kk, max(n - 1, 1))
    if n <= EXACT_LAYER_MAX:
        d = pairwise_dist(vecs[:n], vecs[:n], metric, x_sqnorm=sq[:n])
        d = d.at[jnp.arange(n), jnp.arange(n)].set(jnp.inf)
        dd, ii = topk_smallest(d, kk)
        return ii.astype(jnp.int32), dd
    from . import graph as _graph

    if n * n * d_dim <= _graph.BRUTE_BUILD_FLOP_BUDGET:
        from ..ops.topk import blocked_query_topk

        # HIGHEST to match _brute_knn_graph (models/graph.py): reduced
        # precision loses ~1e-3 neighbour gaps on tight-cluster data
        d, i = blocked_query_topk(
            vecs[:n], vecs[:n], min(kk + 1, n), metric,
            x_sqnorm=sq[:n] if metric == Dist.EUCLIDEAN else None,
            precision=jax.lax.Precision.HIGHEST,
        )
        self_col = i == jnp.arange(n)[:, None]
        d = jnp.where(self_col, jnp.inf, d)
        nd, pos = jax.lax.top_k(-d, kk)
        ids = jnp.take_along_axis(i, pos, axis=-1)
        dists = -nd
        ids = jnp.where(jnp.isinf(dists), n, ids)
        return ids.astype(jnp.int32), dists
    # above the brute budget: the shared partition-join + rate-adaptive
    # NN-descent build (models/graph.approx_knn_graph)
    return _graph.approx_knn_graph(
        key, vecs, sq, kk, metric, n_trees=n_trees, max_rounds=max_rounds
    )


class HnswIndex(BaseIndex):
    """Hierarchical navigable small-world graph."""

    _fallback_vectors = BaseIndex._fallback_from_vectors

    _state_scalars = ("n", "dim", "m", "n_layers")

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        m: int = 16,
        ef_construction: int = 100,
        seed: int = 42,
        verbose: bool = False,
    ):
        self._capture_f64(mat)  # f64 rescore path (models/base)
        super().__init__(mat, metric)
        n = self.n
        self.m = m

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
                print(f"hnsw build: {label} {_time.time() - t0:.1f}s",
                      flush=True)
            return _time.time()

        t0 = _time.time()

        # exponential layer assignment (hnsw.rs:639-645): mL = 1/ln(M)
        rng = np.random.default_rng(seed)
        ml = 1.0 / math.log(max(m, 2))
        levels = np.minimum(
            np.floor(-np.log(rng.uniform(1e-12, 1.0, n)) * ml).astype(np.int64),
            MAX_LAYERS - 1,
        )
        self.n_layers = int(levels.max()) + 1 if n > 1 else 1
        t0 = _mark("layer assignment", t0)

        # base layer: degree 2M, built from an NN-descent graph +
        # rank-prune (the batched Algorithm-4 analogue) + reverse fill
        key = jax.random.key(seed)
        build_k = min(max(2 * m, ef_construction // 2), max(n - 1, 1))
        key, kb = jax.random.split(key)
        ids, dists = _build_knn_graph(kb, vecs, sq, build_k, self.metric, 2, 8)
        t0 = _mark("base kNN graph", t0, dists)
        key, kp = jax.random.split(key)
        deg0 = min(2 * m, build_k)
        pruned = cagra_prune(vecs, sq, ids, dists, deg0, self.metric)
        base = add_reverse_edges(kp, pruned, n, max(deg0 // 2, 1))
        self.base_graph = jnp.concatenate(
            [base, jnp.full((1, base.shape[1]), n, jnp.int32)]
        )
        t0 = _mark("prune + reverse edges", t0, self.base_graph)

        # upper layers: node subsets with their own degree-M graphs in
        # local id space + local→global maps
        self.layers = []  # list of (global_ids [s], graph [s+1, m], vecs, sq)
        for lv in range(1, self.n_layers):
            members = np.nonzero(levels >= lv)[0].astype(np.int32)
            s = len(members)
            if s == 0:
                break
            # pad the member set to a power of two: layer sizes are
            # data-dependent, so unpadded shapes force one XLA compile per
            # layer per build. Pad slots repeat member 0 — their graph rows
            # are unreachable (no real node links to a pad slot: the kNN
            # graph is built on distances where pads duplicate member 0 and
            # rank behind it only by index, and descent starts at slot 0).
            s_pad = 1 << (max(s, 1) - 1).bit_length()
            members_p = np.concatenate(
                [members, np.full(s_pad - s, members[0], np.int32)]
            )
            gids = jnp.asarray(members_p)
            lv_vecs = jnp.concatenate(
                [vecs[gids], jnp.zeros((1, self.dim), jnp.float32)]
            )
            lv_sq = sq_norms(lv_vecs)
            kk = min(m, max(s - 1, 1))
            key, kl = jax.random.split(key)
            lids, _ = _build_knn_graph(kl, lv_vecs, lv_sq, kk, self.metric, 1, 4)
            graph = jnp.concatenate(
                [lids, jnp.full((1, kk), s_pad, jnp.int32)]
            )
            self.layers.append((gids, graph, lv_vecs, lv_sq))
            t0 = _mark(f"upper layer {lv} ({s} nodes, pad {s_pad})", t0, graph)

        # entry point: highest-layer node (hnsw.rs:648)
        if self.layers:
            self.entry_global = int(np.asarray(self.layers[-1][0])[0])
        else:
            self.entry_global = 0

    @staticmethod
    @functools.partial(
        jax.jit,
        static_argnames=("k", "beam", "iters", "qb", "metric", "expand"),
    )
    def _hnsw_query_impl(
        q, vectors, sqnorms, base_graph, hl, packed, layer_args,
        entry_global, *, k, beam, iters, qb, metric, expand,
    ):
        nq = q.shape[0]
        if layer_args is not None:
            gids0, lv_vecs0, lv_sq0 = layer_args
            s0 = gids0.shape[0]
            dots = jax.lax.dot_general(
                q, lv_vecs0[:s0], (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            if metric == Dist.COSINE:
                dd = 1.0 - dots
            else:
                dd = lv_sq0[:s0][None, :] - 2.0 * dots
            ne = min(4, s0)
            _, pos = jax.lax.top_k(-dd, ne)
            entries = gids0[pos]
        else:
            ne = 1
            entries = jnp.broadcast_to(
                entry_global[None, None], (nq, 1)
            ).astype(jnp.int32)

        pad = (-nq) % qb
        if pad:
            q = jnp.concatenate([q, jnp.zeros((pad, q.shape[1]), q.dtype)])
            entries = jnp.concatenate(
                [entries, jnp.zeros((pad, ne), entries.dtype)]
            )

        def run(args):
            qq, ee = args
            return beam_search(
                qq, vectors, sqnorms, base_graph, ee, k, beam, iters,
                metric, expand=expand, vectors_hl=hl if hl else None,
                packed_nbrs=packed,
            )

        d, i = jax.lax.map(
            run, (q.reshape(-1, qb, q.shape[1]), entries.reshape(-1, qb, ne))
        )
        return d.reshape(-1, k)[:nq], i.reshape(-1, k)[:nq]

    def query(
        self,
        query_mat: Any,
        k: int,
        ef_search: int | None = None,
        query_block: int = 1024,
        exact_fallback: bool = True,
        expand: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        r = self._f64_roundtrip(query_mat, k, ef_search=ef_search, query_block=query_block, exact_fallback=exact_fallback, expand=expand)
        if r is not None:
            return r
        q = self._prep_queries(query_mat)
        k = self._clamp_k(k)
        if exact_fallback and self._exact_fallback_ok(q.shape[0]):
            return self._exact_query_small(q, k)
        ef = max(ef_search if ef_search is not None else 100, k)

        # base layer beam with ef_search; routed entries + the exact-brute
        # base kNN graph converge in ~beam/8 expansions (measured on
        # 150k×32d: recall 0.9998 already at ef=50 with 8 iterations — the
        # old 3·beam/8 formula over-iterated ~3× for the same recall)
        beam = min(ef, self.n)
        # Iteration economics: each beam iteration is a serial
        # gather+bitonic round — the latency floor of the graph query. At
        # wide beams the
        # SAME total expansions at expand=8 over HALF the iterations read
        # identical recall (0.9995 at m16 ef100 on 150k×32d for
        # (expand=4, iters=12) vs (expand=8, iters=6)) while halving the
        # serial depth; per-iteration sort width doubles (CP 256 vs 128)
        # but the gather volume is unchanged and lands in fewer, larger
        # DMAs. Auto-widen only when the caller left expand at default.
        if expand is None:
            if beam >= 64:
                expand = 8
                iters = max(6, beam // 16)
            else:
                expand = 4
                iters = max(8, beam // 8)
        else:
            iters = max(8, beam // 8)

        if not hasattr(self, "_nav_hl"):
            from ..ops.graph import nav_hl_split

            self._nav_hl = nav_hl_split(self.vectors)
        if not hasattr(self, "_packed_nbrs"):
            from ..ops.graph import maybe_pack_neighbors

            self._packed_nbrs = maybe_pack_neighbors(
                self.vectors, self.sqnorms, self.base_graph
            )

        # Upper-layer routing. The reference descends greedily from a single
        # top node (hnsw.rs:1156) — that works because insert-time
        # construction connects each layer. Batched-round layer graphs are
        # kNN graphs (no cross-cluster links), so instead the *largest*
        # upper layer is scanned exactly (one small matmul — it holds ~n/M
        # nodes) to produce entries. Routing + beam run as ONE jitted
        # dispatch (eager per-op routing cost ~0.5 s of host-link latency).
        if self.layers:
            gids0, _, lv_vecs0, lv_sq0 = self.layers[0]
            layer_args = (gids0, lv_vecs0, lv_sq0)
        else:
            layer_args = None
        qb = min(query_block, max(q.shape[0], 8))
        d, i = self._hnsw_query_impl(
            q, self.vectors, self.sqnorms, self.base_graph,
            self._nav_hl if self._nav_hl is not None else (),
            self._packed_nbrs, layer_args, jnp.int32(self.entry_global),
            k=k, beam=beam, iters=iters, qb=qb, metric=self.metric,
            expand=expand,
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

    def memory_usage_bytes(self) -> int:
        total = int(self.vectors.size + self.sqnorms.size) * 4
        total += int(self.base_graph.size) * 4
        for gids, graph, lv_vecs, lv_sq in self.layers:
            total += int(gids.size + graph.size + lv_vecs.size + lv_sq.size) * 4
        return total

    # hierarchical state doesn't fit the flat npz schema; HNSW persistence
    # goes through pickle-free manual save below
    def save(self, path: str) -> None:
        arrays = {
            "vectors": np.asarray(self.vectors),
            "base_graph": np.asarray(self.base_graph),
            "meta": np.array(
                [self.n, self.dim, self.m, self.n_layers, self.entry_global,
                 1 if self.metric == Dist.COSINE else 0]
            ),
        }
        for i, (gids, graph, lv_vecs, lv_sq) in enumerate(self.layers):
            arrays[f"l{i}_ids"] = np.asarray(gids)
            arrays[f"l{i}_graph"] = np.asarray(graph)
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str) -> "HnswIndex":
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            meta = z["meta"]
            obj = cls.__new__(cls)
            obj.n, obj.dim, obj.m, obj.n_layers, obj.entry_global = (
                int(meta[0]), int(meta[1]), int(meta[2]), int(meta[3]), int(meta[4])
            )
            obj.metric = Dist.COSINE if meta[5] == 1 else Dist.EUCLIDEAN
            obj.vectors = jnp.asarray(z["vectors"])
            obj.sqnorms = sq_norms(obj.vectors)
            obj.base_graph = jnp.asarray(z["base_graph"])
            obj.layers = []
            i = 0
            while f"l{i}_ids" in z.files:
                gids = jnp.asarray(z[f"l{i}_ids"])
                graph = jnp.asarray(z[f"l{i}_graph"])
                lv_vecs = jnp.concatenate(
                    [obj.vectors[gids], jnp.zeros((1, obj.dim), jnp.float32)]
                )
                obj.layers.append((gids, graph, lv_vecs, sq_norms(lv_vecs)))
                i += 1
        return obj
