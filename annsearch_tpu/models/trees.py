"""Tree indexes: Annoy (hyperplane forest), kd-forest, ball tree.

JAX rebuild of the reference tree family (``src/cpu/annoy.rs``,
``kd_forest.rs``, ``ball_tree.rs``). The reference queries trees with
per-query backtracking priority queues and search budgets
(annoy.rs:526-642, kd_forest.rs:577-705, ball_tree.rs:767+); here the
recall/compute budget comes instead from **candidate-set width**:

  * Annoy / kd-forest: every tree routes the query to one leaf
    (batched descent, one gather+dot per level); the union of all trees'
    leaves is exactly reranked. Budget ≈ n_trees · leaf — the same knob as
    the reference's ``search_k ≈ k·n_trees·20`` (annoy.rs:532).
  * Ball tree: a beam of the best-bounded nodes per level
    (``max(0, ‖q−center‖−radius)²`` — the reference's ball bound) replaces
    best-first backtracking; budget ≈ beam · leaf ≈ the reference's
    5%·n default budget (ball_tree.rs:767).
"""

from __future__ import annotations

import functools
import math
import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.ivf_scan_pallas import fused_eligible, fused_ivf_scan
from ..ops.probe_device import build_probe_lists_device, device_probe_shapes
from ..ops.rerank import rerank_exact, rerank_exact_split
from ..ops.tree import (
    PartitionTree,
    build_partition_forest,
    build_partition_tree,
)
from ..utils.dist import Dist, normalise, sq_norms
from .base import BaseIndex, as_f32_matrix

__all__ = ["AnnoyIndex", "KdTreeIndex", "BallTreeIndex"]

_BIG = jnp.float32(1e30)

# below this many scan cells the fused path loses recall to probe
# granularity; the rerank path serves small trees (tests lower it)
_BALL_FUSED_MIN_CELLS = 512


@functools.partial(
    jax.jit,
    static_argnames=(
        "beam", "nseg", "maxq", "R", "k", "kb", "metric",
    ),
)
def _ball_fused_e2e(
    q, cell_centers, cell_radii, storage, sqn, seg_offsets, seg_counts,
    original_ids, n, *, beam, nseg, maxq, R, k, kb, metric,
):
    """Ball-bound cell ranking → device task lists → fused cell scan, one
    compiled dispatch (the same engine the IVF family and LSH ride; a ball
    tree's leaves are contiguous cells of the sorted order, so the
    reference's best-first backtracking (ball_tree.rs:767+) becomes: rank
    ALL cells by the lower bound ``max(0, ‖q−c‖ − r)``, scan the best
    ``beam`` exactly. Returns packed ``[nq, 2k]`` (dists, ids-as-f32)."""
    # cell_centers/cell_radii are LEAF balls ([nseg·f, d]); a cell's rank key
    # is the sharpest (min) bound among its f leaves — leaf-grade selection
    # at cell-scan granularity
    d2 = (
        sq_norms(q)[:, None]
        + jnp.sum(cell_centers * cell_centers, axis=-1)[None, :]
        - 2.0
        * jax.lax.dot_general(
            q, cell_centers, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
    )
    # centre distance ranks better than the d − r ball bound here (measured:
    # clamped bound ties every containing ball at 0, unclamped prefers
    # outlier-inflated radii; both lost recall vs plain ‖q−c‖ on gaussian
    # mixtures) — bounds matter for EXACT early termination, which a fixed
    # budget does not do
    del cell_radii
    bound = jnp.min(d2.reshape(q.shape[0], nseg, -1), axis=-1)
    _, cells = jax.lax.top_k(-bound, beam)
    cids, lists, gmap = build_probe_lists_device(
        cells.astype(jnp.int32), nseg, maxq, R
    )
    d, pos = fused_ivf_scan(
        q, cids, lists, gmap, storage, sqn, seg_offsets, seg_counts,
        jnp.zeros((nseg, q.shape[1]), jnp.float32), k, metric, "f32",
        None, kb,
    )
    ids = jnp.take(original_ids, jnp.clip(pos, 0, original_ids.shape[0] - 1))
    ids = jnp.where(jnp.isinf(d), n - 1, ids)
    return jnp.concatenate([d, ids.astype(jnp.float32)], axis=-1)


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_probes", "shift", "nseg_tree", "nt", "maxq", "R", "k", "k2",
        "kb", "metric",
    ),
)
def _forest_fused_e2e(
    q, norms_lv, thrs_lv, storage, sqn, seg_offsets, seg_counts,
    order_flat, n, *, n_probes, shift, nseg_tree, nt, maxq, R, k, k2, kb,
    metric,
):
    """Multi-probe forest descent → per-tree cell-major fused scan → id
    dedup, ONE dispatch. Tree t's sorted order is a contiguous block of the
    concatenated storage, so every probed leaf maps to segment ``t·nseg_tree +
    (leaf >> shift)`` and the scan streams cells instead of gathering
    ``n_trees·probes·leaf`` candidate rows per query (the gather + rerank
    einsum was the floor of forest queries). The merge is per-tree
    (``groups=nt`` in the fused scan — a [p·kb]-wide top-k per tree instead of
    one [nt·p·kb]-wide global selection): each id appears at most once per
    tree, so ``nt·k`` group-major lanes are guaranteed to contain the true
    top-k distinct ids, and the LSH-style dedup keeps the k best. Returns
    packed [nq, 2k] (dists, ids as exact f32 values)."""
    from .lsh import _dedup_topk

    bq = q.shape[0]
    n_levels = len(norms_lv)
    tix = jnp.arange(nt)[None, :]

    def descend(flip_lv, want_margins):
        node = jnp.zeros((bq, nt), jnp.int32)
        margins = []
        for lv in range(n_levels):
            nrm = norms_lv[lv][tix, node]
            thr = thrs_lv[lv][tix, node]
            proj = jnp.einsum(
                "qd,qtd->qt", q, nrm, preferred_element_type=jnp.float32
            )
            dec = proj > thr
            if flip_lv is not None:
                dec = jnp.where(flip_lv == lv, ~dec, dec)
            if want_margins:
                margins.append(jnp.abs(proj - thr))
            node = 2 * node + dec.astype(jnp.int32)
        return node, margins

    node0, margins = descend(None, n_probes > 1)
    probe_leaves = [node0[:, :, None]]                   # [bq, nt, 1]
    if n_probes > 1:
        m = jnp.stack(margins, axis=-1)                  # [bq, nt, L]
        flip_order = jnp.argsort(m, axis=-1)
        n_extra = min(n_probes - 1, n_levels)

        def probe(_, flip_lv):
            node, _ = descend(flip_lv, False)
            return None, node

        _, extra = jax.lax.scan(
            probe, None, jnp.moveaxis(flip_order[..., :n_extra], -1, 0)
        )                                                # [ne, bq, nt]
        probe_leaves.append(jnp.moveaxis(extra, 0, 2))   # [bq, nt, ne]
    leaves_all = jnp.concatenate(probe_leaves, axis=2)   # [bq, nt, p]
    cells = jax.lax.shift_right_logical(leaves_all, shift)
    # dedup probed cells per (query, tree): multi-leaf cells collapse flip
    # probes onto the same cell (a last-level flip probes the sibling leaf
    # = the same cell, and every flip below the cell boundary likewise).
    # Duplicate (query, cell) tasks waste scan rows and their duplicate
    # lane copies backfill the per-tree top-k. p is small, so an O(p²)
    # earlier-copy compare keeps the TREE-MAJOR layout the per-tree merge
    # (``groups=nt``) needs — no sort.
    p = cells.shape[2]
    if p > 1:
        earlier = jnp.tril(jnp.ones((p, p), bool), -1)
        dup = jnp.any(
            (cells[..., None, :] == cells[..., :, None]) & earlier, axis=-1
        )
    else:
        dup = jnp.zeros(cells.shape, bool)
    segs = (tix[:, :, None] * nseg_tree + cells).reshape(bq, -1)
    segs = jnp.where(dup.reshape(bq, -1), nt * nseg_tree, segs)

    cids, lists, gmap = build_probe_lists_device(
        segs.astype(jnp.int32), nt * nseg_tree, maxq, R
    )
    k_pg = min(k2, p * kb)  # per-tree survivors
    d, pos = fused_ivf_scan(
        q, cids, lists, gmap, storage, sqn, seg_offsets, seg_counts,
        jnp.zeros((nt * nseg_tree, q.shape[1]), jnp.float32), k_pg, metric,
        "f32", None, kb, groups=nt,
    )
    ids_dup = jnp.take(order_flat, jnp.clip(pos, 0, order_flat.shape[0] - 1))
    ids_dup = jnp.where(jnp.isinf(d), n, ids_dup)
    d, ids = _dedup_topk(d, ids_dup, k)
    return jnp.concatenate(
        [d, jnp.clip(ids, 0, n - 1).astype(jnp.float32)], axis=-1
    )


class _ForestIndex(BaseIndex):
    """Shared: forest build + leaf-union candidate rerank."""

    _fallback_vectors = BaseIndex._fallback_from_vectors

    _mode = "annoy"

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        n_trees: int = 16,
        leaf: int = 64,
        seed: int = 42,
        verbose: bool = False,
    ):
        self._capture_f64(mat)  # f64 rescore path (models/base)
        super().__init__(mat, metric)
        vecs = jnp.concatenate(
            [self.vectors, jnp.zeros((1, self.dim), jnp.float32)]
        )
        self.vectors = vecs
        self.sqnorms = sq_norms(vecs)
        self.leaf = leaf
        levels = max(1, int(math.ceil(math.log2(max(self.n / leaf, 1)))))
        self.trees = build_partition_forest(
            jax.random.key(seed), vecs, n_trees, levels, leaf, self._mode
        )
        # bf16 hi/lo split tables: the leaf-union rerank is candidate-
        # gather-bound and split-table gathers move fewer bytes than f32
        # row gathers (ops/graph.nav_hl_split); None over the memory
        # budget → f32 rerank_exact path
        from ..ops.graph import nav_hl_split

        self._vec_hl = nav_hl_split(vecs)
        self._qfns = {}
        self._scan_cache = None

    # scan-view budget: the tree-ordered f32 row copy costs 4·d·n bytes/tree
    _FOREST_SCAN_BYTES = 4 << 30

    def _scan_setup(self):
        """Lazy concatenated segment view over ALL trees for the fused cell
        scan (tree t's leaves are contiguous cells of block t; padding is
        each tree's global suffix). Returns None when the layout doesn't
        fit the kernel (non-pow2 leaf, tiny forests) or the tree-ordered
        row copy would exceed the memory budget."""
        if self._scan_cache is not None:
            return self._scan_cache if self._scan_cache != "off" else None
        t0 = self.trees[0]
        leaf = t0.leaf
        nt = len(self.trees)
        ok = not (leaf & (leaf - 1))
        cell, shift = leaf, 0
        while cell < 128:
            cell, shift = cell * 2, shift + 1
        n_pad = int(t0.order.shape[0])
        # grow cells until the forest has ≤ ~8k segments: fewer, larger
        # cells mean fewer scan rows (less task-list padding) for more rows
        # per probe — and each probe covers more leaves, so recall at a
        # given probe count only goes up.
        while (
            nt * (n_pad // (2 * cell)) >= 8192
            and cell < 1024
            and n_pad % (2 * cell) == 0
            and n_pad // (2 * cell) >= 8
        ):
            cell, shift = cell * 2, shift + 1
        nseg_tree = n_pad // cell
        bytes_est = nt * (n_pad + cell) * 4 * self.dim
        if (
            not ok
            or cell % 128
            or nseg_tree < 8
            or n_pad % cell
            or bytes_est > self._FOREST_SCAN_BYTES
        ):
            self._scan_cache = "off"
            return None
        order_flat = jnp.concatenate([t.order for t in self.trees]).astype(
            jnp.int32
        )
        storage = self.vectors[jnp.minimum(order_flat, self.n)]
        sqn = self.sqnorms[jnp.minimum(order_flat, self.n)]
        storage = jnp.concatenate(
            [storage, jnp.zeros((cell, self.dim), jnp.float32)]
        )
        sqn = jnp.concatenate([sqn, jnp.zeros((cell,), jnp.float32)])
        offsets = jnp.arange(nt * nseg_tree, dtype=jnp.int32) * cell
        counts_tree = np.clip(
            self.n - np.arange(nseg_tree) * cell, 0, cell
        ).astype(np.int32)
        counts = jnp.asarray(np.tile(counts_tree, nt))
        self._scan_cache = dict(
            cell=cell, shift=shift, nseg_tree=nseg_tree, nt=nt,
            offsets=offsets, counts=counts, storage=storage, sqn=sqn,
            order=order_flat,
        )
        return self._scan_cache

    def _query_fn(self, k: int, qb_size: int, n_probes: int):
        """One jitted program per (k, block size, probes): multi-probe tree
        descent + leaf-union rerank. Probe p re-descends each tree with its
        p-th most-uncertain split (smallest |projection − threshold|)
        flipped — the batched analogue of the reference's margin-ordered
        backtracking queue (annoy.rs:526-642), so recall scales with
        n_probes like the reference's search_k budget.

        All trees descend TOGETHER: per level one [bq, nt, d] gather on the
        level-stacked routing data + one einsum (the per-tree loop issued
        n_trees·(probes+1)·levels tiny dependent ops — ~1,400 at nt32 p4 —
        and dominated query time; forests share a level shape by
        construction so stacking is free)."""
        key = (k, qb_size, n_probes)
        if key in self._qfns:
            return self._qfns[key]
        nt = len(self.trees)
        n_levels = self.trees[0].n_levels
        norms_lv = [
            jnp.stack([t.normals[lv] for t in self.trees])
            for lv in range(n_levels)
        ]  # each [nt, 2^lv, d]
        thrs_lv = [
            jnp.stack([t.thresholds[lv] for t in self.trees])
            for lv in range(n_levels)
        ]  # each [nt, 2^lv]
        leaves = jnp.stack(
            [t.order.reshape(-1, t.leaf) for t in self.trees]
        )  # [nt, n_leaves, leaf]
        tix = jnp.arange(nt)[None, :]
        use_split = self._vec_hl is not None and bool(
            os.environ.get("ANNSEARCH_TREE_SPLIT_RERANK")
        )

        @jax.jit
        def fn(qb, vectors):
            bq = qb.shape[0]

            def descend(flip_lv, want_margins):
                node = jnp.zeros((bq, nt), jnp.int32)
                margins = []
                for lv in range(n_levels):
                    nrm = norms_lv[lv][tix, node]      # [bq, nt, d]
                    thr = thrs_lv[lv][tix, node]       # [bq, nt]
                    proj = jnp.einsum(
                        "qd,qtd->qt", qb, nrm,
                        preferred_element_type=jnp.float32,
                    )
                    dec = proj > thr
                    if flip_lv is not None:
                        dec = jnp.where(flip_lv == lv, ~dec, dec)
                    if want_margins:
                        margins.append(jnp.abs(proj - thr))
                    node = 2 * node + dec.astype(jnp.int32)
                return node, margins

            node0, margins = descend(None, n_probes > 1)
            cands = [leaves[tix, node0].reshape(bq, -1)]
            if n_probes > 1:
                m = jnp.stack(margins, axis=-1)          # [bq, nt, L]
                flip_order = jnp.argsort(m, axis=-1)     # asc by margin
                n_extra = min(n_probes - 1, n_levels)

                def probe(_, flip_lv):
                    # one re-descent (all trees) with each tree's
                    # `flip_lv`-th split inverted; scanned over probes so
                    # program size is O(levels), not O(levels·probes)
                    node, _ = descend(flip_lv, False)
                    return None, leaves[tix, node].reshape(bq, -1)

                _, extra = jax.lax.scan(
                    probe,
                    None,
                    jnp.moveaxis(flip_order[..., :n_extra], -1, 0),
                )  # [n_extra, bq, nt·leaf]
                cands.append(jnp.moveaxis(extra, 0, 1).reshape(bq, -1))
            cand = jnp.concatenate(cands, axis=-1)
            valid = cand < self.n
            ids = jnp.minimum(cand, self.n - 1)
            if use_split:
                return rerank_exact_split(
                    qb, self._vec_hl, self.sqnorms, ids, valid, k,
                    self.metric,
                )
            return rerank_exact(
                qb, vectors[jnp.minimum(cand, self.n)], ids, valid, k,
                self.metric,
            )

        self._qfns[key] = fn
        return fn

    def query(
        self,
        query_mat: Any,
        k: int,
        n_probes: int = 2,
        query_block: int = 1024,
        exact_fallback: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Candidate budget ≈ n_trees · n_probes · leaf (the reference's
        search_k knob, annoy.rs:532)."""
        r = self._f64_roundtrip(query_mat, k, n_probes=n_probes, query_block=query_block, exact_fallback=exact_fallback)
        if r is not None:
            return r
        q = self._prep_queries(query_mat)
        k = self._clamp_k(k)
        if exact_fallback and self._exact_fallback_ok(q.shape[0]):
            return self._exact_query_small(q, k)
        nq = q.shape[0]
        # scan cells are multiples of 128 rows (_scan_setup); ids ride back
        # as exact f32 values below 2²⁴
        scan = (
            self._scan_setup()
            if fused_eligible("f32", 128, self.dim, min(k, 128))
            and self.n < (1 << 24)
            else None
        )
        if scan is not None:
            nt = scan["nt"]
            nseg_tree = scan["nseg_tree"]
            n_levels = self.trees[0].n_levels
            n_extra = min(n_probes - 1, n_levels) if n_probes > 1 else 0
            # block queries so the per-dispatch task-slot count R·maxq
            # stays bounded (each slot carries kb (distance, row) outputs
            # and its gather-map lanes). Halve the block until the slot
            # budget holds (min 2048 — below that the per-block nseg
            # partial-row floor dominates R).
            qb = nq
            while True:
                maxq, R = device_probe_shapes(
                    qb, nt * (1 + n_extra), nt * nseg_tree, 1
                )
                if R * maxq <= (1 << 22) or qb <= 2048:
                    break
                qb = -(-qb // 2)
            if R * maxq > (1 << 23):
                scan = None  # pathological (huge forest): gather path
        if scan is not None:
            # per-tree merge keeps k lanes per tree (an id appears ≤ once
            # per tree, so the top-k distinct ids always survive); the
            # final dedup+top-k runs over nt·k group-major lanes
            k2 = k
            kb = min(128, max(8, 1 << (max(k, 8) - 1).bit_length()))
            if "norms_lv" not in scan:
                scan["norms_lv"] = tuple(
                    jnp.stack([t.normals[lv] for t in self.trees])
                    for lv in range(n_levels)
                )
                scan["thrs_lv"] = tuple(
                    jnp.stack([t.thresholds[lv] for t in self.trees])
                    for lv in range(n_levels)
                )
            norms_lv = scan["norms_lv"]
            thrs_lv = scan["thrs_lv"]
            pad = (-nq) % qb
            qp = (
                jnp.concatenate([q, jnp.zeros((pad, self.dim), q.dtype)])
                if pad
                else q
            )
            outs = []
            for s in range(0, qp.shape[0], qb):
                outs.append(np.asarray(_forest_fused_e2e(
                    qp[s : s + qb], norms_lv, thrs_lv, scan["storage"],
                    scan["sqn"], scan["offsets"], scan["counts"],
                    scan["order"], self.n,
                    n_probes=n_probes, shift=scan["shift"],
                    nseg_tree=nseg_tree, nt=nt, maxq=maxq, R=R, k=k, k2=k2,
                    kb=kb, metric=self.metric,
                )))
            packed = np.concatenate(outs)[:nq]
            return packed[:, k:].astype(np.int32), packed[:, :k]
        qb_size = min(query_block, max(nq, 8))
        pad = (-nq) % qb_size
        if pad:
            q = jnp.concatenate([q, jnp.zeros((pad, self.dim), q.dtype)])
        fn = self._query_fn(k, qb_size, n_probes)
        out_i, out_d = [], []
        for s in range(0, q.shape[0], qb_size):
            d, i = fn(q[s : s + qb_size], self.vectors)
            out_i.append(np.asarray(i))
            out_d.append(np.asarray(d))
        return (
            np.concatenate(out_i)[:nq],
            np.concatenate(out_d)[:nq],
        )

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
        for t in self.trees:
            total += int(t.order.size) * 4
            total += sum(int(x.size) * 4 for x in t.normals)
            total += sum(int(x.size) * 4 for x in t.thresholds)
        return total

    # -- persistence (the reference has no index persistence; parity-plus) --

    def save(self, path: str) -> None:
        arrays = {"vectors": np.asarray(self.vectors[: self.n])}
        for ti, t in enumerate(self.trees):
            arrays[f"t{ti}_order"] = np.asarray(t.order)
            for lv in range(t.n_levels):
                arrays[f"t{ti}_normal{lv}"] = np.asarray(t.normals[lv])
                arrays[f"t{ti}_thr{lv}"] = np.asarray(t.thresholds[lv])
        arrays["meta"] = np.array(
            [self.n, self.dim, len(self.trees), self.leaf,
             1 if self.metric == Dist.COSINE else 0]
        )
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str):
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            meta = z["meta"]
            obj = cls.__new__(cls)
            obj.n, obj.dim = int(meta[0]), int(meta[1])
            n_trees, obj.leaf = int(meta[2]), int(meta[3])
            obj.metric = Dist.COSINE if meta[4] == 1 else Dist.EUCLIDEAN
            vecs = jnp.concatenate(
                [jnp.asarray(z["vectors"]),
                 jnp.zeros((1, obj.dim), jnp.float32)]
            )
            obj.vectors = vecs
            obj.sqnorms = sq_norms(vecs)
            obj.trees = []
            for ti in range(n_trees):
                normals, thrs = [], []
                lv = 0
                while f"t{ti}_normal{lv}" in z.files:
                    normals.append(jnp.asarray(z[f"t{ti}_normal{lv}"]))
                    thrs.append(jnp.asarray(z[f"t{ti}_thr{lv}"]))
                    lv += 1
                obj.trees.append(
                    PartitionTree(
                        jnp.asarray(z[f"t{ti}_order"]), normals, thrs,
                        None, None, obj.leaf,
                    )
                )
            from ..ops.graph import nav_hl_split

            obj._vec_hl = nav_hl_split(vecs)
            obj._qfns = {}
            obj._scan_cache = None
        return obj


class AnnoyIndex(_ForestIndex):
    """Forest of two-point hyperplane trees (reference annoy.rs:36-788)."""

    _mode = "annoy"


class KdTreeIndex(_ForestIndex):
    """Randomised kd-forest: max-spread axis splits
    (reference kd_forest.rs:37-855)."""

    _mode = "kd"


class BallTreeIndex(BaseIndex):
    """Single ball tree with beam descent (reference ball_tree.rs:195-1032)."""

    _fallback_vectors = BaseIndex._fallback_from_vectors

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        leaf: int = 64,
        seed: int = 42,
        verbose: bool = False,
    ):
        self._capture_f64(mat)  # f64 rescore path (models/base)
        super().__init__(mat, metric)
        vecs = jnp.concatenate(
            [self.vectors, jnp.zeros((1, self.dim), jnp.float32)]
        )
        self.vectors = vecs
        self.sqnorms = sq_norms(vecs)
        self.leaf = leaf
        levels = max(1, int(math.ceil(math.log2(max(self.n / leaf, 1)))))
        self.tree = build_partition_tree(
            jax.random.key(seed), vecs, levels, leaf, "ball"
        )
        from ..ops.graph import nav_hl_split

        self._vec_hl = nav_hl_split(vecs)
        self._qfns = {}
        self._scan_cache = None

    def _scan_setup(self):
        """Lazy segment view for the fused cell scan: cells are contiguous
        ``max(128, leaf)``-row blocks of the sorted order (padding always
        sorts to the global suffix, so every cell is a valid-prefix
        segment), ranked by the ball bound of the tree level that owns
        exactly that block size."""
        if self._scan_cache is not None:
            return self._scan_cache
        t = self.tree
        leaf = t.leaf
        if leaf & (leaf - 1):
            return None  # non-power-of-two leaf: rerank path only
        cell, j = leaf, 0
        while cell < 128:
            cell, j = cell * 2, j + 1
        if cell % 128 or j > t.n_levels or len(t.centers) <= t.n_levels - j:
            return None
        centers = t.centers[-1]      # leaf balls — rank key stays leaf-sharp
        radii = t.radii[-1]
        nseg = t.centers[t.n_levels - j].shape[0]
        if nseg < _BALL_FUSED_MIN_CELLS:
            # small trees: cell-granular probing costs real recall (measured
            # −0.04 at 160 cells vs −0.0005 at 2048) and the gather path is
            # cheap there — keep leaf-precise rerank below ~64k rows
            return None
        order = t.order[: nseg * cell]
        storage = self.vectors[jnp.minimum(order, self.n)]
        storage = jnp.where((order < self.n)[:, None], storage, 0.0)
        sqn = self.sqnorms[jnp.minimum(order, self.n)]
        sqn = jnp.where(order < self.n, sqn, 0.0)
        offsets = jnp.arange(nseg, dtype=jnp.int32) * cell
        counts = jnp.clip(self.n - np.arange(nseg) * cell, 0, cell).astype(
            jnp.int32
        )
        storage = jnp.concatenate(
            [storage, jnp.zeros((cell, self.dim), jnp.float32)]
        )
        sqn = jnp.concatenate([sqn, jnp.zeros((cell,), jnp.float32)])
        self._scan_cache = dict(
            cell=cell, nseg=nseg, centers=centers, radii=radii,
            offsets=offsets, counts=jnp.asarray(counts),
            storage=storage, sqn=sqn, order=order.astype(jnp.int32),
        )
        return self._scan_cache

    def query(
        self,
        query_mat: Any,
        k: int,
        budget: float | None = None,
        query_block: int = 1024,
        exact_fallback: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """``budget``: fraction of n to rerank exactly (reference default
        5%·n, ball_tree.rs:767). ``query_block`` matches the forest
        indexes — 256-row blocks paid ~4× the per-dispatch overhead for
        the same rerank volume."""
        r = self._f64_roundtrip(query_mat, k, budget=budget, query_block=query_block, exact_fallback=exact_fallback)
        if r is not None:
            return r
        q = self._prep_queries(query_mat)
        k = self._clamp_k(k)
        if exact_fallback and self._exact_fallback_ok(q.shape[0]):
            return self._exact_query_small(q, k)
        budget = 0.05 if budget is None else budget
        nq = q.shape[0]
        # scan cells are multiples of 128 rows (_scan_setup); ids ride back
        # as exact f32 values below 2²⁴
        scan = (
            self._scan_setup()
            if fused_eligible("f32", 128, self.dim, k)
            and self.n < (1 << 24)
            else None
        )
        if scan is not None:
            nseg = scan["nseg"]
            beam = min(
                nseg, max(1, int(math.ceil(budget * self.n / scan["cell"])))
            )
            maxq, R = device_probe_shapes(nq, beam, nseg, 1)
            kb = min(128, max(8, 1 << (max(k, 8) - 1).bit_length()))
            packed = np.asarray(_ball_fused_e2e(
                q, scan["centers"], scan["radii"], scan["storage"],
                scan["sqn"], scan["offsets"], scan["counts"],
                scan["order"], self.n, beam=beam, nseg=nseg, maxq=maxq,
                R=R, k=k, kb=kb, metric=self.metric,
            ))
            return packed[:, k:].astype(np.int32), packed[:, :k]
        beam = max(1, int(math.ceil(budget * self.n / self.leaf)))
        qb_size = min(query_block, max(nq, 8))
        pad = (-nq) % qb_size
        if pad:
            q = jnp.concatenate([q, jnp.zeros((pad, self.dim), q.dtype)])
        fn = self._query_fn(k, beam, qb_size)
        out_i, out_d = [], []
        for s in range(0, q.shape[0], qb_size):
            d, i = fn(q[s : s + qb_size], self.vectors)
            out_i.append(np.asarray(i))
            out_d.append(np.asarray(d))
        return (
            np.concatenate(out_i)[:nq],
            np.concatenate(out_d)[:nq],
        )

    def _query_fn(self, k: int, beam: int, qb_size: int):
        key = (k, beam, qb_size)
        if key in self._qfns:
            return self._qfns[key]
        t = self.tree
        leaf_centers = t.centers[-1]
        leaves = t.order.reshape(-1, t.leaf)

        @jax.jit
        def fn(qb, vectors):
            d2 = (
                sq_norms(qb)[:, None]
                + jnp.sum(leaf_centers * leaf_centers, axis=-1)[None, :]
                - 2.0
                * jax.lax.dot_general(
                    qb, leaf_centers, (((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32,
                )
            )
            keep = min(beam, leaf_centers.shape[0])
            _, nodes = jax.lax.top_k(-d2, keep)
            cand = leaves[nodes].reshape(qb.shape[0], -1)
            valid = cand < self.n
            ids = jnp.minimum(cand, self.n - 1)
            if self._vec_hl is not None:
                return rerank_exact_split(
                    qb, self._vec_hl, self.sqnorms, ids, valid, k,
                    self.metric,
                )
            return rerank_exact(
                qb, vectors[jnp.minimum(cand, self.n)], ids, valid, k,
                self.metric,
            )

        self._qfns[key] = fn
        return fn

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
        t = self.tree
        total = int(self.vectors.size + self.sqnorms.size) * 4
        total += int(t.order.size) * 4
        total += sum(int(x.size) * 4 for x in t.normals)
        total += sum(int(x.size) * 4 for x in t.thresholds)
        total += sum(int(x.size) * 4 for x in t.centers)
        total += sum(int(x.size) * 4 for x in t.radii)
        return total

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        t = self.tree
        arrays = {"vectors": np.asarray(self.vectors[: self.n]),
                  "order": np.asarray(t.order)}
        for lv in range(t.n_levels):
            arrays[f"normal{lv}"] = np.asarray(t.normals[lv])
            arrays[f"thr{lv}"] = np.asarray(t.thresholds[lv])
        for lv in range(len(t.centers)):
            arrays[f"center{lv}"] = np.asarray(t.centers[lv])
            arrays[f"radius{lv}"] = np.asarray(t.radii[lv])
        arrays["meta"] = np.array(
            [self.n, self.dim, self.leaf,
             1 if self.metric == Dist.COSINE else 0]
        )
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str) -> "BallTreeIndex":
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            meta = z["meta"]
            obj = cls.__new__(cls)
            obj.n, obj.dim, obj.leaf = int(meta[0]), int(meta[1]), int(meta[2])
            obj.metric = Dist.COSINE if meta[3] == 1 else Dist.EUCLIDEAN
            vecs = jnp.concatenate(
                [jnp.asarray(z["vectors"]),
                 jnp.zeros((1, obj.dim), jnp.float32)]
            )
            obj.vectors = vecs
            obj.sqnorms = sq_norms(vecs)
            normals, thrs, centers, radii = [], [], [], []
            lv = 0
            while f"normal{lv}" in z.files:
                normals.append(jnp.asarray(z[f"normal{lv}"]))
                thrs.append(jnp.asarray(z[f"thr{lv}"]))
                lv += 1
            lv = 0
            while f"center{lv}" in z.files:
                centers.append(jnp.asarray(z[f"center{lv}"]))
                radii.append(jnp.asarray(z[f"radius{lv}"]))
                lv += 1
            obj.tree = PartitionTree(
                jnp.asarray(z["order"]), normals, thrs, centers, radii,
                obj.leaf,
            )
            from ..ops.graph import nav_hl_split

            obj._vec_hl = nav_hl_split(vecs)
            obj._qfns = {}
            obj._scan_cache = None
        return obj
