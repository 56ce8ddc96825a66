"""kMkNN index: EXACT search with k-means triangle-inequality pruning.

JAX rebuild of the reference ``KmknnIndex`` (``src/cpu/kmknn.rs``).
The reference walks clusters per query in ascending centroid distance and
early-breaks via the triangle bound (kmknn.rs:263-335); data-dependent
early-exit doesn't batch, so the same guarantee is delivered in two fixed
phases:

  1. scan the ``p0`` nearest cells per query (segmented cluster-major
     engine) → an upper bound ``kth(q)`` on the k-th distance;
  2. the triangle bound ``lb(q,c) = max(0, d(q,c) − r_c)²`` (``r_c`` = cell
     radius) identifies every remaining cell that could still matter;
     exactly those (query, cell) pairs are scanned and merged.

Any cell not scanned satisfies lb > kth ≥ true-kth, so the result is exact —
the same triangle-inequality argument as the reference, evaluated batch-wise.

Cosine is handled the reference's way (kmknn.rs:147-153): vectors are
pre-normalised and euclidean machinery runs internally (euclidean k-means,
not spherical — the bound needs euclidean geometry); reported distances are
``d²/2 = 1 − cos`` (kmknn.rs:326-329), identical to every other cosine index.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.ivf_scan import build_probe_lists_from_pairs, ivf_cluster_scan
from ..ops.probe_device import (
    build_probe_lists_device,
    device_probe_shapes,
    expand_probes_device,
)
from ..ops.topk import merge_topk, topk_smallest
from ..utils.dist import Dist, normalise, sq_norms
from .base import BaseIndex, as_f32_matrix
from .kmeans import (
    assign_clusters,
    expand_probes_to_segments,
    segment_layout,
    train_centroids,
)

__all__ = ["KmknnIndex"]


@functools.partial(jax.jit, static_argnames=("p0",))
def _route_kmknn(q, centroids, p0):
    cd2 = jnp.maximum(
        sq_norms(q)[:, None]
        + sq_norms(centroids)[None, :]
        - 2.0
        * jax.lax.dot_general(
            q, centroids, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            # HIGHEST: these distances feed the triangle-inequality prune —
            # a bf16-pass error here can wrongly exclude a cell holding a
            # true neighbour, silently breaking kMkNN's exactness guarantee
            precision=jax.lax.Precision.HIGHEST,
        ),
        0.0,
    )
    return cd2, topk_smallest(cd2, p0)[1]


@functools.partial(
    jax.jit, static_argnames=("p0", "s_max", "nseg", "maxq", "R", "k", "cap")
)
def _kmknn_phase1(
    q, centroids, cluster_ptr, vectors, sqnorms, seg_offsets, seg_counts,
    seg_centroids, radii, cell_counts, *, p0, s_max, nseg, maxq, R, k, cap,
):
    """Route → device task lists → exact scan → triangle-bound selection,
    ONE compiled program (the eager version paid 3 dispatch round-trips and
    a [nq, nlist] f32 readback per query batch). Returns
    ``(d1, i1, packed_need)`` with d1/i1 left on device for phase 2."""
    cd2, probes = _route_kmknn(q, centroids, p0)
    seg_probes = expand_probes_device(probes, cluster_ptr, s_max, nseg)
    cids, lists, gmap = build_probe_lists_device(seg_probes, nseg, maxq, R)
    d1, i1 = ivf_cluster_scan(
        q, cids, lists, gmap, vectors, sqnorms, seg_offsets, seg_counts,
        seg_centroids, k, Dist.EUCLIDEAN, cap, "f32",
    )
    kth = d1[:, k - 1]
    packed = _phase2_need_packed(cd2, kth, radii, cell_counts, probes)
    return d1, i1, packed


@functools.partial(jax.jit, static_argnames=("k", "cap"))
def _kmknn_phase2(
    q, cids2, lists2, gmap2, vectors, sqnorms, seg_offsets, seg_counts,
    seg_centroids, d1, i1, *, k, cap,
):
    """Scan the triangle-bound survivors and merge with phase 1 — one
    program, one small [nq, 2k] packed readback (ids as exact f32 values)."""
    d2, i2 = ivf_cluster_scan(
        q, cids2, lists2, gmap2, vectors, sqnorms, seg_offsets, seg_counts,
        seg_centroids, k, Dist.EUCLIDEAN, cap, "f32",
    )
    d, i = merge_topk(d1, i1, d2, i2, k)
    return jnp.concatenate([d, i.astype(jnp.float32)], axis=-1)


@jax.jit
def _phase2_need_packed(
    cd2: jax.Array,          # [nq, nlist] squared centroid distances
    kth: jax.Array,          # [nq] phase-1 k-th distance upper bound
    radii: jax.Array,        # [nlist] cell radii
    cell_counts: jax.Array,  # [nlist]
    probes: jax.Array,       # [nq, p0] phase-1 probed cells
) -> jax.Array:
    """Triangle-bound cell selection, packed to uint8 bits on device.

    The phase-2 decision matrix is [nq, nlist] — reading it back as f32
    bounds dominated query latency on slow host links; the packed bitmask is
    32× smaller and the host only runs nonzero() on it.
    """
    nq, nlist = cd2.shape
    lb = jnp.maximum(jnp.sqrt(cd2) - radii[None, :], 0.0) ** 2
    need = (lb < kth[:, None]) & (cell_counts[None, :] > 0)
    probed = jnp.zeros((nq, nlist), bool).at[
        jnp.arange(nq)[:, None], probes
    ].set(True)
    need = need & ~probed
    pad = (-nlist) % 8
    if pad:
        need = jnp.concatenate(
            [need, jnp.zeros((nq, pad), bool)], axis=1
        )
    bits = need.reshape(nq, -1, 8).astype(jnp.uint8)
    weights = (2 ** jnp.arange(8, dtype=jnp.uint8))[None, None, :]
    return jnp.sum(bits * weights, axis=-1, dtype=jnp.uint8)


class KmknnIndex(BaseIndex):
    """Exact k-means-pruned search."""

    def _fallback_vectors(self):
        # storage is cluster-sorted with seg_size pad rows; map back via
        # original_ids (the padded zero rows must NOT enter the scan)
        return (
            self.vectors[: self.n],
            self.sqnorms[: self.n],
            self.original_ids[: self.n],
        )

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        nlist: int | None = None,
        max_iters: int = 30,
        seed: int = 42,
        verbose: bool = False,
    ):
        # f64 inputs: keep a host f64 copy; query() pre-selects a 2k pool
        # with the exact f32 machinery and rescores it in f64 (same trick
        # as ExhaustiveIndex/IvfBase — dist.rs f64 generics parity)
        self._x64 = (
            np.ascontiguousarray(mat)
            if isinstance(mat, np.ndarray) and mat.dtype == np.float64
            else None
        )
        arr = as_f32_matrix(mat)
        n = arr.shape[0]
        if nlist is None:
            nlist = max(1, int(math.isqrt(n)))
        nlist = min(nlist, n)

        super().__init__(arr, metric)
        x = self.vectors  # normalised if cosine — euclidean runs internally

        self.nlist = nlist
        self.centroids = train_centroids(
            x, nlist, Dist.EUCLIDEAN, max_iters=max_iters, seed=seed
        )
        assignments, d2c = assign_clusters(x, self.centroids, Dist.EUCLIDEAN)
        layout = segment_layout(np.asarray(assignments), nlist)
        self._layout = layout
        self.seg_size = int(layout.seg_size)
        self.seg_offsets = jnp.asarray(layout.seg_offsets)
        self.seg_counts = jnp.asarray(layout.seg_counts)
        self.seg_centroids = self.centroids[jnp.asarray(layout.seg_cluster)]

        order_j = jnp.asarray(layout.order)
        x_sorted = x[order_j]
        self.original_ids = order_j.astype(jnp.int32)
        # per-cell radius = max member distance to centroid
        d2c_np = np.asarray(jnp.sqrt(d2c))
        radii = np.zeros(nlist, np.float32)
        np.maximum.at(radii, np.asarray(assignments), d2c_np)
        self.radii = jnp.asarray(radii)
        self.cell_counts = jnp.asarray(layout.counts)

        pad = self.seg_size
        self.vectors = jnp.concatenate(
            [x_sorted, jnp.zeros((pad, self.dim), jnp.float32)]
        )
        self.sqnorms = sq_norms(self.vectors)
        ptr = np.asarray(layout.cluster_ptr, np.int32)
        self._cluster_ptr_j = jnp.asarray(ptr)
        self._s_max = int((ptr[1:] - ptr[:-1]).max()) if len(ptr) > 1 else 1

    def _scan_pairs(self, q, qs, cs_seg, k):
        nq = q.shape[0]
        cluster_ids, lists, gmap = build_probe_lists_from_pairs(
            qs, cs_seg, len(np.asarray(self.seg_offsets)), nq
        )
        d, i = ivf_cluster_scan(
            q, jnp.asarray(cluster_ids), jnp.asarray(lists),
            jnp.asarray(gmap), self.vectors,
            self.sqnorms, self.seg_offsets, self.seg_counts,
            self.seg_centroids, k, Dist.EUCLIDEAN, self.seg_size, "f32",
        )
        return d, i

    def query(
        self, query_mat: Any, k: int, p0: int | None = None,
        exact_fallback: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        q64 = None
        kq = self._clamp_k(k)
        if (
            getattr(self, "_x64", None) is not None
            and isinstance(query_mat, np.ndarray)
            and query_mat.dtype == np.float64
        ):
            q64, kq = query_mat, min(2 * kq, self.n)
        q = self._prep_queries(query_mat)
        if exact_fallback and self._exact_fallback_ok(q.shape[0]):
            # identical output to the two-phase triangle-bound search (both
            # are exact); the matmul scan is the faster path below the
            # budget
            ids, d = self._exact_query_small(q, kq)
        else:
            ids, d = self._query_prepped(q, kq, p0)
        if q64 is not None:
            from .base import rescore_f64_pool

            return rescore_f64_pool(
                self._x64, q64, np.clip(ids, 0, self.n - 1),
                self._clamp_k(k), self.metric,
            )
        return ids, d

    def _query_prepped(self, q, k, p0=None):
        k = self._clamp_k(k)
        nq = q.shape[0]
        p0 = p0 if p0 is not None else max(1, int(math.isqrt(self.nlist)))
        p0 = min(p0, self.nlist)

        # phase 1: nearest p0 cells + triangle-bound cell selection, all in
        # one compiled program; only the packed bitmask crosses the link
        nseg = int(self.seg_offsets.shape[0])
        maxq, R = device_probe_shapes(nq, p0, nseg, self._s_max)
        d1, i1, packed = _kmknn_phase1(
            q, self.centroids, self._cluster_ptr_j, self.vectors,
            self.sqnorms, self.seg_offsets, self.seg_counts,
            self.seg_centroids, self.radii, self.cell_counts,
            p0=p0, s_max=self._s_max, nseg=nseg, maxq=maxq, R=R, k=k,
            cap=self.seg_size,
        )
        need = np.unpackbits(np.asarray(packed), axis=1, bitorder="little")[
            :, : self.nlist
        ].astype(bool)
        qrows, crows = np.nonzero(need)
        if len(qrows):
            qs2, segs2 = expand_probes_to_segments(
                np.stack([crows], axis=1), self._layout
            )
            # expand built per-row; remap its query ids back to qrows
            qs2 = qrows[qs2]
            cids2, lists2, gmap2 = build_probe_lists_from_pairs(
                qs2, segs2, nseg, nq
            )
            if self.n < (1 << 24):  # ids ride back as exact f32 values
                arr = np.asarray(_kmknn_phase2(
                    q, jnp.asarray(cids2), jnp.asarray(lists2),
                    jnp.asarray(gmap2), self.vectors, self.sqnorms,
                    self.seg_offsets, self.seg_counts, self.seg_centroids,
                    d1, i1, k=k, cap=self.seg_size,
                ))
                d, i = arr[:, :k], arr[:, k:].astype(np.int32)
            else:
                d2, i2 = self._scan_pairs(q, qs2, segs2, k)
                d1, i1 = merge_topk(d1, i1, d2, i2, k)
                d, i = np.asarray(d1), np.asarray(i1)
        else:
            d, i = np.asarray(d1), np.asarray(i1)
        if self.metric == Dist.COSINE:
            d = d * 0.5  # unit-sphere d²/2 = 1 − cos (kmknn.rs:326-329)
        ids = np.asarray(self.original_ids)[np.clip(i, 0, self.n - 1)]
        return ids, d

    def generate_knn(self, k: int, **kw):
        ids, d = self._query_prepped(
            self.vectors[: self.n], k, kw.get("p0")
        )
        inv = np.empty(self.n, dtype=np.int64)
        inv[np.asarray(self.original_ids)] = np.arange(self.n)
        return ids[inv], d[inv]

    def vectors_original_order(self) -> np.ndarray:
        inv = np.empty(self.n, dtype=np.int64)
        inv[np.asarray(self.original_ids)] = np.arange(self.n)
        return np.asarray(self.vectors[: self.n])[inv]

    def memory_usage_bytes(self) -> int:
        return (
            int(self.vectors.size + self.sqnorms.size) * 4
            + int(self.centroids.size + self.seg_centroids.size) * 4
            + int(self.radii.size + self.cell_counts.size) * 4
            + int(self.seg_offsets.size + self.seg_counts.size) * 4
            + int(self.original_ids.size) * 4
        )

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        np.savez(
            path,
            vectors=np.asarray(self.vectors),
            centroids=np.asarray(self.centroids),
            seg_centroids=np.asarray(self.seg_centroids),
            seg_offsets=np.asarray(self.seg_offsets),
            seg_counts=np.asarray(self.seg_counts),
            original_ids=np.asarray(self.original_ids),
            radii=np.asarray(self.radii),
            cell_counts=np.asarray(self.cell_counts),
            cluster_ptr=np.asarray(self._layout.cluster_ptr),
            seg_cluster=np.asarray(self._layout.seg_cluster),
            meta=np.array(
                [self.n, self.dim, self.nlist, self.seg_size,
                 1 if self.metric == Dist.COSINE else 0]
            ),
        )

    @classmethod
    def load(cls, path: str) -> "KmknnIndex":
        from .kmeans import SegmentLayout

        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            meta = z["meta"]
            obj = cls.__new__(cls)
            obj.n, obj.dim, obj.nlist, obj.seg_size = (
                int(meta[0]), int(meta[1]), int(meta[2]), int(meta[3])
            )
            obj.metric = Dist.COSINE if meta[4] == 1 else Dist.EUCLIDEAN
            obj.vectors = jnp.asarray(z["vectors"])
            obj.sqnorms = sq_norms(obj.vectors)
            obj.centroids = jnp.asarray(z["centroids"])
            obj.seg_centroids = jnp.asarray(z["seg_centroids"])
            obj.seg_offsets = jnp.asarray(z["seg_offsets"])
            obj.seg_counts = jnp.asarray(z["seg_counts"])
            obj.original_ids = jnp.asarray(z["original_ids"])
            obj.radii = jnp.asarray(z["radii"])
            obj.cell_counts = jnp.asarray(z["cell_counts"])
            obj._layout = SegmentLayout(
                None, z["seg_offsets"], z["seg_counts"], z["seg_cluster"],
                z["cluster_ptr"], obj.seg_size, z["cell_counts"],
            )
            ptr = np.asarray(z["cluster_ptr"], np.int32)
            obj._cluster_ptr_j = jnp.asarray(ptr)
            obj._s_max = int((ptr[1:] - ptr[:-1]).max()) if len(ptr) > 1 else 1
        return obj
