"""LSH index: multi-probe SimHash tables scanned as segmented cells.

JAX rebuild of the reference ``LSHIndex`` (``src/cpu/lsh.rs``):
``num_tables`` tables of ``bits_per_hash`` orthogonalised Gaussian
hyperplanes (lsh.rs:135-145); euclidean mode hashes L2-normalised copies but
reranks on raw vectors (lsh.rs:148-168); multi-probe flips the
most-uncertain bits ranked by |projection| (lsh.rs:288-298); empty-bucket
queries fall back to random candidates (lsh.rs:302-307, reference warns when
>1% of queries fall back).

Hash-map buckets don't map onto an accelerator, and per-query bucket *gathers*
scatter device-memory reads. Instead each table's rows are stored
**hash-sorted**, which makes every bucket a contiguous range, i.e. the exact
shape of the IVF segmented cluster-major scan: the T tables concatenate into
one storage of ``T·2^bits`` cells and a probe set becomes an IVF task list.
Queries ride the same conflict-free ``ops/ivf_scan.ivf_cluster_scan`` engine as
the IVF family — contiguous tensor-core streaming, no gathers, full buckets
scanned (matching the reference's scan-the-whole-bucket behaviour). The price
is a ``num_tables``-fold copy of the vectors (the reference stores ids only and
random-accesses the originals — cheap on CPU caches, not on HBM).

Probe sequences match the reference's ``generate_probes_ranked``
(lsh.rs:704-757): bits ranked by ascending |projection|, all Hamming
distance-1 flips first, then distance-2 pairs — the flip *patterns* over
rank positions are static, so the per-query work is one |proj| argsort plus
gathers. Candidates reached through multiple tables are deduplicated on
device before the final top-k.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.ivf_scan import build_probe_lists_from_pairs, ivf_cluster_scan
from ..ops.ivf_scan_pallas import fused_eligible, fused_ivf_scan
from ..ops.probe_device import (
    build_probe_lists_device,
    device_probe_shapes,
    expand_probes_device,
)
from ..ops.rerank import rerank_exact
from ..utils.dist import Dist, normalise, sq_norms
from .base import BaseIndex, as_f32_matrix
from .kmeans import SegmentLayout, expand_probes_to_segments, segment_layout

__all__ = ["LSHIndex"]

_INF = jnp.float32(jnp.inf)


def _probe_patterns(bits: int, n_probes: int) -> tuple[tuple[int, ...], ...]:
    """Static flip patterns over *rank* positions (0 = most uncertain bit):
    Hamming distance-1 in rank order, then distance-2 pairs — the reference's
    probe order (lsh.rs:704-757) with the per-query bit ranking factored out.
    """
    pats: list[tuple[int, ...]] = []
    for r in range(bits):
        if len(pats) >= n_probes - 1:
            return tuple(pats)
        pats.append((r,))
    for i in range(bits):
        for j in range(i + 1, bits):
            if len(pats) >= n_probes - 1:
                return tuple(pats)
            pats.append((i, j))
    return tuple(pats)


@functools.partial(jax.jit, static_argnames=("bits", "n_probes", "uniform"))
def _probe_cells(
    q: jax.Array,             # [bq, dim] normalised queries
    projections: jax.Array,   # [T, dim, bits]
    bits: int,
    n_probes: int,
    uniform: bool = False,
) -> jax.Array:
    """[bq, T·P] global cell ids: per table, the base hash plus the ranked
    multi-bit flip probes, offset into that table's cell range.

    ``uniform=True`` flips bits in fixed index order instead of by
    projection-magnitude rank — the reference's *self*-query semantics
    (lsh.rs:510-522: stored hashes carry no projection magnitudes, so
    generate_probes_uniform flips bit 0, 1, … then pairs)."""
    num_tables = projections.shape[0]
    powers = (2 ** jnp.arange(bits, dtype=jnp.int32))[None, :]
    pats = _probe_patterns(bits, n_probes)
    out = []
    for t in range(num_tables):
        proj = q @ projections[t]                      # [bq, bits]
        base_h = jnp.sum((proj > 0).astype(jnp.int32) * powers, axis=-1)
        if uniform:
            probes = [base_h]
            for pat in pats:
                h = base_h
                for r in pat:
                    h = h ^ (1 << r)
                probes.append(h)
        else:
            flip_order = jnp.argsort(jnp.abs(proj), axis=-1)  # asc: rank→bit
            probes = [base_h]
            for pat in pats:
                h = base_h
                for r in pat:
                    h = h ^ (1 << flip_order[:, r]).astype(jnp.int32)
                probes.append(h)
        out.append(jnp.stack(probes, axis=1) + t * (1 << bits))
    return jnp.concatenate(out, axis=1)


@functools.partial(jax.jit, static_argnames=("k",))
def _dedup_topk(d: jax.Array, ids: jax.Array, k: int):
    """Drop cross-table duplicates (same original id reached through
    several tables at identical distance), keep the k smallest."""
    C = ids.shape[-1]
    if C <= 128:
        earlier = jnp.tril(jnp.ones((C, C), bool), -1)
        dup = jnp.any(
            (ids[..., None, :] == ids[..., :, None]) & earlier, axis=-1
        )
    else:
        order = jnp.argsort(ids, axis=-1)
        s_ids = jnp.take_along_axis(ids, order, axis=-1)
        dup_s = jnp.concatenate(
            [jnp.zeros(s_ids.shape[:-1] + (1,), bool),
             s_ids[..., 1:] == s_ids[..., :-1]], axis=-1,
        )
        dup = jnp.take_along_axis(dup_s, jnp.argsort(order, axis=-1), axis=-1)
    d = jnp.where(dup, _INF, d)
    nd, pos = jax.lax.top_k(-d, k)
    return -nd, jnp.take_along_axis(ids, pos, axis=-1)


@functools.partial(
    jax.jit,
    static_argnames=(
        "bits", "n_probes", "s_max", "nseg", "maxq", "R", "k2", "k", "kb",
        "metric", "uniform",
    ),
)
def _lsh_fused_e2e(
    q, qn, projections, cluster_ptr, storage, sqnorms, seg_offsets,
    seg_counts, original_ids, n, *, bits, n_probes, s_max, nseg, maxq, R,
    k2, k, kb, metric, uniform=False,
):
    """hash+probe → invert → fused bucket scan → dedup top-k, ONE dispatch
    (the host path reads probe cells back, expands on host and re-uploads
    task lists — a full link round-trip per query batch). Returns packed
    ``[nq, 2k]`` (dists, then ids as exact f32 values)."""
    cells = _probe_cells(qn, projections, bits, n_probes, uniform)
    seg_probes = expand_probes_device(cells, cluster_ptr, s_max, nseg)
    cids, lists, gmap = build_probe_lists_device(seg_probes, nseg, maxq, R)
    d, pos = fused_ivf_scan(
        q, cids, lists, gmap, storage, sqnorms, seg_offsets, seg_counts,
        jnp.zeros((nseg, q.shape[1]), jnp.float32), k2, metric, "f32",
        None, kb,
    )
    ids_dup = jnp.take(
        original_ids, jnp.clip(pos, 0, original_ids.shape[0] - 1)
    )
    ids_dup = jnp.where(jnp.isinf(d), n, ids_dup)
    d, ids = _dedup_topk(d, ids_dup, k)
    return jnp.concatenate(
        [d, jnp.clip(ids, 0, n - 1).astype(jnp.float32)], axis=-1
    )


class LSHIndex(BaseIndex):
    """Multi-probe SimHash over segmented hash-sorted tables."""

    _fallback_vectors = BaseIndex._fallback_from_vectors

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        num_tables: int = 8,
        bits_per_hash: int = 16,
        seed: int = 42,
        verbose: bool = False,
    ):
        if bits_per_hash > 30:
            raise ValueError("bits_per_hash must be ≤ 30 (int32 hash space)")
        self._capture_f64(mat)  # f64 rescore path (models/base)
        super().__init__(mat, metric)
        n = self.n
        self.num_tables = num_tables
        self.bits = bits_per_hash

        # hashes computed on L2-normalised copies for euclidean
        # (lsh.rs:148-168); cosine vectors are already normalised
        hash_input = (
            self.vectors
            if self.metric == Dist.COSINE
            else normalise(self.vectors)
        )

        # hyperplanes orthogonalised on the host: [d, b] QR is host-scale
        # work
        rng = np.random.default_rng(seed)
        projs = []
        for _ in range(num_tables):
            g = rng.standard_normal((self.dim, bits_per_hash))
            qm, _ = np.linalg.qr(g)
            projs.append(qm[:, :bits_per_hash].astype(np.float32))
        self.projections = jnp.asarray(np.stack(projs))  # [T, d, b]

        # one global cell space: table t's bucket h is cell t·2^b + h; the
        # concatenated assignment (element t·n + r → row r's cell in table
        # t) feeds the same segment layout the IVF family uses
        powers = (2 ** jnp.arange(bits_per_hash, dtype=jnp.int32))[None, :]
        per_table = []
        for t in range(num_tables):
            hbits = (hash_input @ self.projections[t]) > 0
            per_table.append(
                jnp.sum(hbits.astype(jnp.int32) * powers, axis=-1)
                + t * (1 << bits_per_hash)
            )
        all_assign = np.asarray(jnp.concatenate(per_table))       # [T·n]
        layout = segment_layout(all_assign, num_tables * (1 << bits_per_hash))
        self._layout = layout
        self.seg_size = int(layout.seg_size)
        self.seg_offsets = jnp.asarray(layout.seg_offsets)
        self.seg_counts = jnp.asarray(layout.seg_counts)

        order = layout.order                          # index into [T·n]
        self.original_ids = jnp.asarray((order % n).astype(np.int32))
        rows = self.vectors[self.original_ids]
        pad = self.seg_size
        self.storage = jnp.concatenate(
            [rows, jnp.zeros((pad, self.dim), jnp.float32)]
        )
        self.store_sqnorms = sq_norms(self.storage)
        self._seed = seed
        self.last_fallback_rate = 0.0
        if verbose:
            c = layout.counts[layout.counts > 0]
            print(
                f"LSH built: T={num_tables} bits={bits_per_hash} "
                f"nseg={layout.nseg} seg_size={self.seg_size} "
                f"bucket med/max={int(np.median(c))}/{int(c.max())}"
            )

    def query(
        self,
        query_mat: Any,
        k: int,
        n_probes: int = 4,
        max_bucket: int | None = None,   # unused — full buckets are scanned
        query_block: int | None = None,  # unused — the scan is global
        exact_fallback: bool = True,
        uniform_probes: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        """``uniform_probes``: flip probe bits in fixed index order instead
        of uncertainty rank — the reference's self-query behaviour
        (lsh.rs:510-522); ``generate_knn`` sets it."""
        r = self._f64_roundtrip(query_mat, k, n_probes=n_probes, query_block=query_block, exact_fallback=exact_fallback, uniform_probes=uniform_probes)
        if r is not None:
            return r
        q = self._prep_queries(query_mat)
        if exact_fallback and self._exact_fallback_ok(q.shape[0]):
            return self._exact_query_small(q, self._clamp_k(k))
        k = self._clamp_k(k)
        nq = q.shape[0]
        qn = q if self.metric == Dist.COSINE else normalise(q)
        k2 = min(k * self.num_tables, 192)
        use_fused = (
            int(self.storage.shape[0]) < (1 << 24)
            and fused_eligible("f32", self.seg_size, self.dim, min(k, 128))
        )
        if use_fused:
            # whole query is one compiled dispatch (device probe lists)
            nseg = int(self.seg_offsets.shape[0])
            maxq, R = device_probe_shapes(
                nq, self.num_tables * n_probes, nseg, self._s_max()
            )
            kb = min(128, max(8, 1 << (max(k, 8) - 1).bit_length()))
            packed = np.asarray(_lsh_fused_e2e(
                q, qn, self.projections, self._ptr_j(), self.storage,
                self.store_sqnorms,
                self.seg_offsets, self.seg_counts, self.original_ids,
                self.n, bits=self.bits, n_probes=n_probes,
                s_max=self._s_max(), nseg=nseg, maxq=maxq, R=R, k2=k2, k=k,
                kb=kb, metric=self.metric, uniform=uniform_probes,
            ))
            dists = packed[:, :k]
            ids = packed[:, k:].astype(np.int32)
            return self._apply_fallback(q, ids, dists, k, nq)

        cells = np.asarray(
            _probe_cells(
                qn, self.projections, self.bits, n_probes, uniform_probes
            )
        )

        # expand cells → segment task pairs → cluster-major scan (the same
        # engine as the IVF family; buckets are contiguous segments)
        qs, segs = expand_probes_to_segments(cells, self._layout)
        nseg = int(self.seg_offsets.shape[0])
        cluster_ids, lists, gmap = build_probe_lists_from_pairs(
            qs, segs, nseg, nq
        )
        # k·T scan slots: a true neighbour appears once per table it hashes
        # near in, and multi-probe makes that ALL T tables for the nearest
        # ones — under-provisioning lets duplicates crowd out distinct ids
        # before the dedup (measured: recall *dropped* with more probes)
        d, pos = ivf_cluster_scan(
            q, jnp.asarray(cluster_ids), jnp.asarray(lists),
            jnp.asarray(gmap), self.storage, self.store_sqnorms,
            self.seg_offsets, self.seg_counts,
            jnp.zeros((nseg, self.dim), jnp.float32), k2, self.metric,
            self.seg_size, "f32",
            # per-cell top-k only needs the caller's k: a row appears at
            # most once per cell, duplicates are cross-table — and the
            # dense per-step outputs scale with k_cell (k2-wide cells
            # OOMed HBM on skewed bucket distributions)
            k_cell=k,
        )
        ids_dup = jnp.take(
            self.original_ids, jnp.clip(pos, 0, self.original_ids.shape[0] - 1)
        )
        ids_dup = jnp.where(jnp.isinf(d), self.n, ids_dup)
        d, ids = _dedup_topk(d, ids_dup, k)
        ids = np.asarray(jnp.clip(ids, 0, self.n - 1))
        dists = np.asarray(d)
        return self._apply_fallback(q, ids, dists, k, nq)

    def _apply_fallback(self, q, ids, dists, k, nq):
        """Empty-bucket fallback: exact rerank over random candidates
        (lsh.rs:302-307; reference warns when >1% of queries fall back)."""
        miss = ~np.isfinite(dists[:, 0])
        self.last_fallback_rate = float(miss.mean()) if nq else 0.0
        if miss.any():
            rows = np.nonzero(miss)[0]
            rnd = jax.random.randint(
                jax.random.key(self._seed + 1), (len(rows), 1000), 0, self.n
            )
            vecs = self.vectors[rnd]
            fd, fi = rerank_exact(
                q[rows], vecs, rnd, jnp.ones(rnd.shape, bool), k, self.metric
            )
            ids[rows] = np.asarray(fi)
            dists[rows] = np.asarray(fd)
        if self.last_fallback_rate > 0.01:
            print(
                f"LSH warning: {self.last_fallback_rate:.1%} of queries hit "
                "empty buckets (random fallback) — consider fewer bits or "
                "more probes"
            )
        return ids, dists

    def _ptr_j(self):
        cached = getattr(self, "_ptr_j_cache", None)
        if cached is None:
            cached = jnp.asarray(
                np.asarray(self._layout.cluster_ptr, np.int32)
            )
            self._ptr_j_cache = cached
        return cached

    def _s_max(self) -> int:
        cached = getattr(self, "_s_max_cache", None)
        if cached is None:
            ptr = np.asarray(self._layout.cluster_ptr)
            cached = int((ptr[1:] - ptr[:-1]).max()) if len(ptr) > 1 else 1
            self._s_max_cache = cached
        return cached

    def generate_knn(self, k: int, **kw):
        # self-query flips probe bits uniformly (reference lsh.rs:510-522 —
        # stored hashes carry no projection magnitudes to rank by)
        kw.setdefault("uniform_probes", True)
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
        return (
            int(self.vectors.size + self.sqnorms.size) * 4
            + int(self.storage.size + self.store_sqnorms.size) * 4
            + int(self.projections.size) * 4
            + int(self.original_ids.size) * 4
            + int(self.seg_offsets.size + self.seg_counts.size) * 4
        )

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        np.savez(
            path,
            vectors=np.asarray(self.vectors),
            projections=np.asarray(self.projections),
            storage=np.asarray(self.storage),
            original_ids=np.asarray(self.original_ids),
            seg_offsets=np.asarray(self.seg_offsets),
            seg_counts=np.asarray(self.seg_counts),
            cluster_ptr=np.asarray(self._layout.cluster_ptr),
            seg_cluster=np.asarray(self._layout.seg_cluster),
            meta=np.array(
                [self.n, self.dim, self.num_tables, self.bits, self._seed,
                 1 if self.metric == Dist.COSINE else 0, self.seg_size]
            ),
        )

    @classmethod
    def load(cls, path: str) -> "LSHIndex":
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            meta = z["meta"]
            obj = cls.__new__(cls)
            obj.n, obj.dim, obj.num_tables, obj.bits, obj._seed = (
                int(meta[0]), int(meta[1]), int(meta[2]), int(meta[3]),
                int(meta[4]),
            )
            obj.metric = Dist.COSINE if meta[5] == 1 else Dist.EUCLIDEAN
            obj.seg_size = int(meta[6])
            obj.vectors = jnp.asarray(z["vectors"])
            obj.sqnorms = sq_norms(obj.vectors)
            obj.projections = jnp.asarray(z["projections"])
            obj.storage = jnp.asarray(z["storage"])
            obj.store_sqnorms = sq_norms(obj.storage)
            obj.original_ids = jnp.asarray(z["original_ids"])
            obj.seg_offsets = jnp.asarray(z["seg_offsets"])
            obj.seg_counts = jnp.asarray(z["seg_counts"])
            obj._layout = SegmentLayout(
                None, z["seg_offsets"], z["seg_counts"], z["seg_cluster"],
                z["cluster_ptr"], obj.seg_size, None,
            )
            obj.last_fallback_rate = 0.0
        return obj
