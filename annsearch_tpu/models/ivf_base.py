"""Shared scaffolding for the IVF index family.

Build: k-means coarse quantiser → cluster-sorted storage → bounded-size
segment layout (``models/kmeans.segment_layout`` — splits oversized cells so
the scan's static cap doesn't inherit the worst cell's size). Query: route to
top-nprobe cells, expand to (query, segment) tasks on the host (the reference
GPU's CPU task-list step, ivf_gpu.rs:600-635), run the cluster-major scan
(``ops/ivf_scan.py``), remap to original ids.

Storage encoding is a subclass hook — f32 (plain IVF), bf16, int8, PQ codes,
binary bits all share this skeleton.
"""

from __future__ import annotations

import functools
import math
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
from ..ops.topk import topk_smallest
from ..utils.dist import Dist, normalise, sq_norms
from .base import BaseIndex, as_f32_matrix
from .kmeans import (
    assign_clusters,
    expand_probes_to_segments,
    segment_layout,
    train_centroids,
)

__all__ = ["IvfBase", "route_to_cells"]


def route_to_cells(
    q: jax.Array, centroids: jax.Array, nprobe: int, metric: Dist,
    precision=None,
) -> jax.Array:
    """Top-nprobe nearest centroids per query (one [nq, nlist] matmul +
    top_k; replaces per-query select_nth, k_means_utils.rs:56-108).
    ``precision=HIGHEST`` makes routing ranks agree with the certificate's
    HIGHEST-precision ranking (certified queries route this way so the
    certificate needs no rank margin — the routing matmul is tiny)."""
    dots = jax.lax.dot_general(
        q, centroids, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32, precision=precision,
    )
    if metric == Dist.COSINE:
        d = 1.0 - dots
    else:
        d = sq_norms(q)[:, None] + sq_norms(centroids)[None, :] - 2.0 * dots
    _, probes = topk_smallest(d, nprobe)
    return probes


@functools.partial(
    jax.jit,
    static_argnames=(
        "nprobe_seg", "nseg", "maxq", "R", "k", "metric", "mode", "kb",
        "q_split",
    ),
)
def _fused_query_e2e(
    q, q_enc, route_cents, storage, sqnorms, seg_offsets, seg_counts,
    seg_cents, scales, *, nprobe_seg, nseg, maxq, R, k, metric, mode, kb,
    q_split=True,
):
    """Route → invert → fused scan as one compiled program.

    Routing goes straight to SEGMENTS (``route_cents`` = per-segment copies
    of the owning cluster's centroid): a split cell's segments appear as
    duplicate routing rows and the nearest are probed together. Avoids the
    cluster→segment expansion fan-out, whose worst-case (max segments per
    cluster) blows the task list up with sentinels.
    """
    probes = route_to_cells(q, route_cents, nprobe_seg, metric)
    cluster_ids, lists, gmap = build_probe_lists_device(
        probes.astype(jnp.int32), nseg, maxq, R
    )
    return fused_ivf_scan(
        q_enc, cluster_ids, lists, gmap, storage, sqnorms,
        seg_offsets, seg_counts, seg_cents, k, metric, mode, scales, kb,
        q_split=q_split,
    )


@functools.partial(jax.jit, static_argnames=("nseg",))
def _seg_radii(storage, sqn, seg_cents, row_seg, *, nseg):
    """Per-segment max squared distance of member rows to the owning
    centroid (f32 HIGHEST). Pad rows carry ``row_seg == nseg``."""
    c = seg_cents[jnp.minimum(row_seg, nseg - 1)]
    dots = jnp.einsum(
        "nd,nd->n", storage.astype(jnp.float32), c,
        precision=jax.lax.Precision.HIGHEST,
    )
    csq = jnp.einsum("nd,nd->n", c, c, precision=jax.lax.Precision.HIGHEST)
    d2 = jnp.maximum(sqn + csq - 2.0 * dots, 0.0)
    d2 = jnp.where(row_seg < nseg, d2, 0.0)
    return jax.ops.segment_max(d2, row_seg, num_segments=nseg + 1)[:nseg]


@functools.partial(jax.jit, static_argnames=("metric", "rank_margin"))
def _cert_flags(q, centroids, radii, dk, npr_used, *, metric,
                rank_margin=2):
    """Triangle-inequality exactness certificate (one dispatch, tiny
    readback). A vector x in cell c satisfies ``|q−x| ≥ |q−c| − r_c``
    (``r_c`` = cell radius), so a cell with ``(|q−c| − r_c)² > d_k``
    cannot improve the current top-k. Returns, per query, the 1-based
    centroid-distance rank of the furthest cell that could still matter
    (``m_need``) and whether that exceeds the probes already scanned.
    Cosine rides the same geometry: stored rows, centroids and queries
    are unit vectors, so ``1 − sim = |q−x|²/2``."""
    dots = jax.lax.dot_general(
        q, centroids, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    # euclidean geometry in BOTH metrics: queries/rows are unit vectors
    # under cosine (1 − sim = |q−x|²/2 exactly) but centroids need not be,
    # so centroid distances use their real norms
    dc2 = jnp.maximum(
        sq_norms(q)[:, None] + sq_norms(centroids)[None, :] - 2.0 * dots,
        0.0,
    )
    dk2 = jnp.maximum(2.0 * dk if metric == Dist.COSINE else dk, 0.0)
    dc = jnp.sqrt(dc2)
    bound = jnp.maximum(dc - radii[None, :], 0.0) ** 2
    # float-grade slack: flag on ties rather than certify through noise
    viol = bound <= dk2[:, None] * (1.0 + 1e-3) + 1e-6
    # rank cells the way the ROUTER ranks them (cosine routes by 1 − dot,
    # which can disagree with euclidean rank when centroid norms vary) so
    # "rank < nprobe ⇒ already scanned" holds
    dr = (1.0 - dots) if metric == Dist.COSINE else dc2
    order = jnp.argsort(dr, axis=1)
    viol_sorted = jnp.take_along_axis(viol, order, axis=1)
    idx = jnp.arange(dc.shape[1])[None, :]
    m_need = jnp.max(jnp.where(viol_sorted, idx + 1, 0), axis=1)
    # rank margin: a scan routed at DEFAULT (bf16-grade) matmul precision
    # while this program ranks at HIGHEST can swap near-tie cells a couple
    # of ranks across the probe boundary — only trust the probe set up to
    # npr−margin and re-probe the rest. Certified queries route at HIGHEST
    # (route_hi), so their ranks agree exactly and margin drops to 0 —
    # without it, every query with a borderline-but-SCANNED cell re-probed
    # for nothing (the bulk of the certificate's old 2.3× cost).
    return m_need, m_need > jnp.maximum(npr_used - rank_margin, 1)


@functools.partial(
    jax.jit,
    static_argnames=(
        "nprobe", "nseg", "s_max", "maxq", "R", "k", "metric", "cap",
        "mode", "approx", "route_hi",
    ),
)
def _exact_query_e2e(
    q, q_enc, centroids, cluster_ptr, storage, sqnorms, seg_offsets,
    seg_counts, scan_cents, codebooks, aux, *, nprobe, nseg, s_max, maxq,
    R, k, metric, cap, mode, approx, route_hi=False,
):
    """Route (to CLUSTERS — reference nprobe semantics) → device segment
    expansion → device task-list inversion → exact XLA cluster scan, one
    compiled program: no probes readback, host inversion or list upload
    between routing and the scan."""
    probes = route_to_cells(
        q, centroids, nprobe, metric,
        precision=jax.lax.Precision.HIGHEST if route_hi else None,
    )
    seg_probes = expand_probes_device(
        probes.astype(jnp.int32), cluster_ptr, s_max, nseg
    )
    cids, lists, gmap = build_probe_lists_device(seg_probes, nseg, maxq, R)
    d, i = ivf_cluster_scan(
        q_enc, cids, lists, gmap, storage, sqnorms, seg_offsets,
        seg_counts, scan_cents, k, metric, cap, mode,
        codebooks=codebooks, aux=aux, approx=approx,
    )
    return d, i


class IvfBase(BaseIndex):
    """k-means routing + segmented cells + cluster-major scan."""

    mode = "f32"

    _state_arrays = (
        "storage", "store_sqnorms", "centroids", "seg_centroids",
        "seg_offsets", "seg_counts", "original_ids",
    )
    _state_scalars = ("n", "dim", "nlist", "seg_size")

    def __init__(
        self,
        mat: Any,
        metric: str | Dist = "euclidean",
        nlist: int | None = None,
        max_iters: int = 30,
        seed: int = 42,
        seg_size: int | None = None,
        verbose: bool = False,
        **encode_kwargs,
    ):
        # f64 inputs keep a host-side f64 copy (full-precision storage modes
        # only): query() then runs the f32 scan as a 2k-pool pre-selection
        # and rescores the pool in f64 on the host — the same trick
        # ExhaustiveIndex uses for dist.rs's f64 generics (dist.rs:113-2263)
        self._x64 = None
        if (
            isinstance(mat, np.ndarray)
            and mat.dtype == np.float64
            and type(self).mode == "f32"
        ):
            self._x64 = np.ascontiguousarray(mat)
        arr = as_f32_matrix(mat)
        n = arr.shape[0]
        if nlist is None:
            nlist = max(1, int(math.isqrt(n)))
        nlist = min(nlist, n)

        super().__init__(arr, metric)
        x = self.vectors  # normalised already if cosine

        self.nlist = nlist
        self.centroids = train_centroids(
            x, nlist, self.metric, max_iters=max_iters, seed=seed
        )
        assignments, _ = assign_clusters(x, self.centroids, self.metric)
        layout = segment_layout(np.asarray(assignments), nlist, seg_size)
        self.seg_size = int(layout.seg_size)
        self._cluster_ptr = layout.cluster_ptr
        self.seg_offsets = jnp.asarray(layout.seg_offsets)
        self.seg_counts = jnp.asarray(layout.seg_counts)
        self.seg_centroids = self.centroids[jnp.asarray(layout.seg_cluster)]

        order_j = jnp.asarray(layout.order)
        self.original_ids = order_j.astype(jnp.int32)
        self.vectors = None  # replaced by (possibly quantised) storage
        if getattr(type(self), "_encode_lazy", False):
            # quantised encoders gather sorted rows chunk-by-chunk —
            # materialising the full [n, d] f32 x_sorted next to the
            # caller's x doubles data residency (2×5.1 GB at 10M×128d)
            self._encode_storage((x, order_j), seed=seed, **encode_kwargs)
        else:
            self._encode_storage(x[order_j], seed=seed, **encode_kwargs)
        if verbose:
            c = layout.counts
            print(
                f"IVF built: nlist={nlist} nseg={layout.nseg} "
                f"seg_size={self.seg_size} cells min/med/max = "
                f"{c.min()}/{int(np.median(c))}/{c.max()}"
            )

    # -- subclass hooks ----------------------------------------------------

    def _encode_storage(self, x_sorted: jax.Array, seed: int, **kw) -> None:
        """Default: plain f32 storage."""
        self._pad_storage(x_sorted, sq_norms(x_sorted))

    def _encode_queries(self, q: jax.Array) -> jax.Array:
        return q

    def _scan_seg_centroids(self) -> jax.Array:
        return self.seg_centroids

    def _codebooks(self):
        return None

    def _aux(self):
        return None

    def _pad_storage(self, storage: jax.Array, sqnorms: jax.Array):
        pad = self.seg_size
        self.storage = jnp.concatenate(
            [storage, jnp.zeros((pad,) + storage.shape[1:], storage.dtype)]
        )
        self.store_sqnorms = jnp.concatenate(
            [sqnorms, jnp.zeros((pad,), sqnorms.dtype)]
        )

    # -- queries -------------------------------------------------------------

    def default_nprobe(self) -> int:
        """Reference default: √nlist (ivf.rs:261)."""
        return max(1, int(math.isqrt(self.nlist)))

    def _seg_s_max(self) -> int:
        """Max segments per cluster (static bound for device expansion)."""
        cached = getattr(self, "_s_max_cache", None)
        if cached is None:
            ptr = np.asarray(self._cluster_ptr)
            cached = int((ptr[1:] - ptr[:-1]).max()) if len(ptr) > 1 else 1
            self._s_max_cache = cached
        return cached

    def _cluster_ptr_dev(self) -> jax.Array:
        cached = getattr(self, "_ptr_dev_cache", None)
        if cached is None:
            cached = jnp.asarray(
                np.asarray(self._cluster_ptr), dtype=jnp.int32
            )
            self._ptr_dev_cache = cached
        return cached

    def _cell_radii(self) -> jax.Array:
        """[nlist] per-cell euclidean radii (f32 upper bounds, small
        multiplicative slack so HIGHEST rounding can't under-state a
        radius and void the certificate). Computed once per index from
        the sorted f32 storage — one device pass + [nseg] readback."""
        cached = getattr(self, "_cell_radii_cache", None)
        if cached is None:
            offs = np.asarray(self.seg_offsets)
            cnts = np.asarray(self.seg_counts)
            nseg = len(offs)
            n_pad = int(self.storage.shape[0])
            row_seg = np.full(n_pad, nseg, np.int32)
            for s in range(nseg):
                row_seg[offs[s] : offs[s] + cnts[s]] = s
            seg_max = np.asarray(
                _seg_radii(
                    self.storage, self.store_sqnorms, self.seg_centroids,
                    jnp.asarray(row_seg), nseg=nseg,
                )
            )
            ptr = np.asarray(self._cluster_ptr)
            radii = np.zeros(self.nlist, np.float32)
            for c in range(self.nlist):
                if ptr[c + 1] > ptr[c]:
                    radii[c] = seg_max[ptr[c] : ptr[c + 1]].max()
            cached = jnp.asarray(
                np.sqrt(np.maximum(radii, 0.0) * (1.0 + 2e-3)) + 1e-6
            )
            self._cell_radii_cache = cached
        return cached

    def _certify(self, q, ids, d, k, nprobe, k_scan, q_split, q64):
        """Make the exact tier provably exact: run the triangle-inequality
        certificate (:func:`_cert_flags`) over the routing geometry and
        re-query any flagged query at the certified probe count (rounded
        up to a power of two so re-probes can't trigger unbounded
        recompiles). The re-query's probe set supersets the original
        (same routing, larger top-k), so flagged rows are overwritten,
        not merged. Loops until every query certifies or probes reach
        nlist (warns — instead of silently returning — in the
        cannot-happen case of residual flags at the pass cap). Exactness
        is at f32-selection grain within probed cells; see ``query``. The
        reference's exact path is exact by scanning the same scalar kernels
        for GT and query (ivf.rs); here GT and query take different numeric
        paths, so exactness is *certified* geometrically instead."""
        kc = self._clamp_k(k)
        npr = self.default_nprobe() if nprobe is None else nprobe
        npr = max(1, min(npr, self.nlist))
        radii = self._cell_radii()
        nq = q.shape[0]
        npr_used = np.full(nq, npr, np.int32)
        sel = np.arange(nq)
        # the loop terminates provably: each pass at least doubles the
        # flagged rows' probe count (want > npr_used, pow2 rounding), so
        # it exits — flag-free or via a full scan — within log2(nlist)+2
        # passes; the hard cap only guards against an invariant bug
        max_passes = max(int(self.nlist).bit_length() + 2, 8)
        for p in range(max_passes):
            qs = q[jnp.asarray(sel)]
            pad = (1 << max(len(sel) - 1, 0).bit_length()) - len(sel) if len(sel) > 1 else 0
            if pad:
                qs = jnp.concatenate(
                    [qs, jnp.broadcast_to(qs[:1], (pad, q.shape[1]))]
                )
            dk = np.concatenate(
                [d[sel, kc - 1].astype(np.float32), np.zeros(pad, np.float32)]
            )
            # rows that scanned every cell are exact by construction (the
            # −2 rank margin must not re-flag them); same for pad rows
            nu = np.concatenate(
                [
                    np.where(
                        npr_used[sel] >= self.nlist,
                        self.nlist + 8,
                        npr_used[sel],
                    ),
                    np.full(pad, self.nlist + 8, np.int32),
                ]
            )
            m_need, flags = _cert_flags(
                qs, self.centroids, radii, jnp.asarray(dk),
                jnp.asarray(nu), metric=self.metric, rank_margin=0,
            )
            flags = np.asarray(flags)[: len(sel)]
            if not flags.any():
                break
            m_need = np.asarray(m_need)[: len(sel)]
            rows = sel[flags]
            if not ids.flags.writeable:
                ids = ids.copy()  # np.asarray of device output is read-only
            if not d.flags.writeable:
                d = d.copy()
            want = int(max(m_need[flags].max() + 2, npr_used[rows].max() + 1))
            npr2 = min(self.nlist, 1 << (want - 1).bit_length())
            nf = len(rows)
            nf_pad = 1 << (nf - 1).bit_length() if nf > 1 else 1
            rows_p = np.concatenate(
                [rows, np.zeros(nf_pad - nf, rows.dtype)]
            )
            qf = q[jnp.asarray(rows_p)]
            ids2, d2 = self._query_prepped(
                qf, k, npr2, k_scan, False, q_split, route_hi=True
            )
            if q64 is not None:
                from .base import rescore_f64_pool

                ids2, d2 = rescore_f64_pool(
                    self._x64, q64[rows_p], np.clip(ids2, 0, self.n - 1),
                    kc, self.metric,
                )
            ids[rows] = ids2[:nf]
            d[rows] = d2[:nf]
            npr_used[rows] = npr2
            sel = rows
            if npr2 >= self.nlist:
                break
        else:
            import warnings

            warnings.warn(
                "certify=True: probe certificate still flagged "
                f"{len(sel)} queries after {max_passes} passes — result "
                "returned uncertified (this indicates a certificate "
                "invariant bug; please report)",
                RuntimeWarning,
            )
        return ids, d

    def query(
        self,
        query_mat: Any,
        k: int,
        nprobe: int | None = None,
        k_scan: int | None = None,
        approx: bool = False,
        q_split: bool | None = None,
        certify: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        """``approx=True`` uses approximate per-cell selection (the fused
        cell-scan kernel on a GPU, ``lax.approx_min_k`` in the XLA scan
        elsewhere) — a throughput knob that costs a little tail recall.

        ``q_split`` controls query scoring precision in the FUSED approx
        tier for int8-decoded modes ONLY (``approx=True`` AND
        ``fused_eligible`` AND mode i8dec/i8dec_residual). Everywhere else
        the knob is a no-op. ``False`` = queries rounded to bf16 for one
        tensor-core pass (~2⁻⁹ relative dot noise); ``True`` = f32 query
        scoring (XLA-scan parity). Default ``None`` auto-resolves to
        ``False`` for i8dec modes — there the int8 code quantisation
        (~2⁻⁷·range per dim) dominates the bf16 rounding — and ``True``
        otherwise.

        f64 query batches against an index built from f64 data return
        f64-exact ids+distances *within the probed cells*: the f32 scan
        pre-selects a 2k pool, rescored in f64 on the host
        (``models.base.rescore_f64_pool``).

        ``certify=True`` (exact f32 tier only) upgrades "exact within the
        probed cells" to provably exact top-k *at f32-selection grain*: a
        triangle-inequality certificate over the routing geometry
        (:func:`_cert_flags`) re-probes any query whose kth distance an
        unprobed cell could still beat. The certificate bounds UNPROBED
        cells only — within probed cells the scan's f32-grade selection
        is trusted, so sub-f32-grain ties can still order arbitrarily
        (the f64 path rescores the pool and is exact at f64 grain, same
        caveat as the q64 pool rescore). ``nprobe`` then sets the STARTING probe count, not the
        recall — the reference's exact CPU path gets 1.0 only when its
        clustering happens to trap every neighbour (ivf.rs); this makes
        it unconditional. Plain ``nprobe`` queries keep reference
        recall/cost semantics."""
        q64 = None
        if (
            getattr(self, "_x64", None) is not None
            and isinstance(query_mat, np.ndarray)
            and query_mat.dtype == np.float64
            and k_scan is None
        ):
            q64 = query_mat
            k_scan = min(2 * self._clamp_k(k), self.n)
        q = self._prep_queries(query_mat)
        route_hi = bool(certify) and not approx and self.mode == "f32"
        ids, d = self._query_prepped(
            q, k, nprobe, k_scan, approx, q_split, route_hi=route_hi
        )
        if q64 is not None:
            from .base import rescore_f64_pool

            ids, d = rescore_f64_pool(
                self._x64, q64, np.clip(ids, 0, self.n - 1),
                self._clamp_k(k), self.metric,
            )
        if certify:
            if approx or self.mode != "f32":
                raise ValueError(
                    "certify=True requires the exact f32 tier "
                    "(approx=False and a plain-f32 IVF index) — quantised "
                    "storage cannot certify exact distances"
                )
            npr = self.default_nprobe() if nprobe is None else nprobe
            if max(1, min(npr, self.nlist)) < self.nlist:
                ids, d = self._certify(
                    q, ids, d, k, nprobe, k_scan, q_split, q64
                )
        return ids, d

    def _prep_queries(self, query_mat):
        q = as_f32_matrix(query_mat)
        if q.shape[1] != self.dim:
            raise ValueError(f"query dim {q.shape[1]} != index dim {self.dim}")
        qj = jnp.asarray(q)
        return normalise(qj) if self.metric == Dist.COSINE else qj

    def _scan(
        self, q, k, nprobe, mode=None, q_eff=None, approx=False,
        q_split=None, route_hi=False,
    ):
        """Route → segment task lists → cluster-major scan. Returns
        (dists [nq, k], sorted-storage positions [nq, k])."""
        nq = q.shape[0]
        eff_mode = self.mode if mode is None else mode
        if q_split is None:
            # auto: single bf16 pass where the storage's own int8
            # quantisation dominates the query-rounding noise (see
            # IvfBase.query docstring for the measurement)
            q_split = eff_mode not in ("i8dec", "i8dec_residual")
        if approx and q_eff is None and fused_eligible(
            eff_mode, self.seg_size, int(self.storage.shape[1]), k
        ):
            # route (to segments) → task-list inversion → fused kernel, one
            # compiled program (ops/probe_device.py). nprobe is scaled to
            # segments so the probed DB fraction matches cell semantics.
            nseg = int(self.seg_offsets.shape[0])
            nprobe_seg = min(
                nseg, max(nprobe, -(-nprobe * nseg) // max(self.nlist, 1))
            )
            maxq, R = device_probe_shapes(nq, nprobe_seg, nseg, 1)
            kb = max(8, 1 << (max(k, 1) - 1).bit_length())
            return _fused_query_e2e(
                q,
                self._encode_queries(q),
                self.seg_centroids,
                self.storage,
                self.store_sqnorms,
                self.seg_offsets,
                self.seg_counts,
                self._scan_seg_centroids(),
                self._codebooks(),
                nprobe_seg=nprobe_seg,
                nseg=nseg,
                maxq=maxq,
                R=R,
                k=k,
                metric=self.metric,
                mode=eff_mode,
                kb=kb,
                q_split=q_split,
            )
        nseg = int(self.seg_offsets.shape[0])
        s_max = self._seg_s_max()
        # device task lists ONLY when no cluster is split (s_max == 1 ⇒
        # segments ≡ clusters and the expansion is the identity): split
        # clusters force sentinel expansion slots, which the XLA scan pays
        # for as real scan rows. Also bounded in (query, cell) pairs.
        if s_max == 1 and nq * nprobe < (1 << 26):
            maxq, R = device_probe_shapes(nq, nprobe, nseg, s_max)
            return _exact_query_e2e(
                q,
                self._encode_queries(q) if q_eff is None else q_eff,
                self.centroids,
                self._cluster_ptr_dev(),
                self.storage,
                self.store_sqnorms,
                self.seg_offsets,
                self.seg_counts,
                self._scan_seg_centroids(),
                self._codebooks(),
                self._aux(),
                nprobe=nprobe,
                nseg=nseg,
                s_max=s_max,
                maxq=maxq,
                R=R,
                k=k,
                metric=self.metric,
                cap=self.seg_size,
                mode=eff_mode,
                approx=approx,
                route_hi=route_hi,
            )
        probes = route_to_cells(
            q, self.centroids, nprobe, self.metric,
            precision=jax.lax.Precision.HIGHEST if route_hi else None,
        )
        from .kmeans import SegmentLayout  # local import to avoid cycle

        layout_stub = SegmentLayout(
            None, np.asarray(self.seg_offsets), np.asarray(self.seg_counts),
            None, self._cluster_ptr, self.seg_size, None,
        )
        qs, segs = expand_probes_to_segments(np.asarray(probes), layout_stub)
        cluster_ids, lists, gmap = build_probe_lists_from_pairs(
            qs, segs, len(np.asarray(self.seg_offsets)), nq
        )
        best_d, best_i = ivf_cluster_scan(
            self._encode_queries(q) if q_eff is None else q_eff,
            jnp.asarray(cluster_ids),
            jnp.asarray(lists),
            jnp.asarray(gmap),
            self.storage,
            self.store_sqnorms,
            self.seg_offsets,
            self.seg_counts,
            self._scan_seg_centroids(),
            k,
            self.metric,
            self.seg_size,
            eff_mode,
            codebooks=self._codebooks(),
            aux=self._aux(),
            approx=approx,
        )
        return best_d, best_i

    def _query_prepped(
        self, q, k, nprobe, k_scan=None, approx=False, q_split=None,
        route_hi=False,
    ):
        k = self._clamp_k(k)
        nprobe = self.default_nprobe() if nprobe is None else nprobe
        nprobe = max(1, min(nprobe, self.nlist))
        d, i = self._scan(
            q, k if k_scan is None else k_scan, nprobe, approx=approx,
            q_split=q_split, route_hi=route_hi,
        )
        d = np.asarray(d)
        i = np.asarray(i)
        ids = np.asarray(self.original_ids)[np.clip(i, 0, self.n - 1)]
        return ids, d

    def generate_knn(
        self, k: int, nprobe: int | None = None, **kw
    ) -> tuple[np.ndarray, np.ndarray]:
        q = jnp.asarray(self.vectors_original_order())
        if self.metric == Dist.COSINE:
            q = normalise(q)
        return self._query_prepped(q, k, nprobe, kw.get("k_scan"))

    # -- plumbing ------------------------------------------------------------

    def _decoded_sorted(self) -> np.ndarray:
        """Decode the (possibly quantised) sorted storage to f32."""
        return np.asarray(self.storage[: self.n], dtype=np.float32)

    def vectors_original_order(self) -> np.ndarray:
        inv = np.empty(self.n, dtype=np.int64)
        inv[np.asarray(self.original_ids)] = np.arange(self.n)
        return self._decoded_sorted()[inv]

    def _owner_clusters(self) -> jnp.ndarray:
        """[n] owner cluster per sorted row (from the segment layout)."""
        owners = np.zeros(self.n, np.int32)
        offs = np.asarray(self.seg_offsets)
        cnts = np.asarray(self.seg_counts)
        # owner cluster of each segment: invert cluster_ptr
        ptr = self._cluster_ptr
        seg_owner = np.repeat(
            np.arange(len(ptr) - 1), (ptr[1:] - ptr[:-1]).astype(np.int64)
        )
        for s in range(len(offs)):
            owners[offs[s] : offs[s] + cnts[s]] = seg_owner[s]
        return jnp.asarray(owners)

    def save(self, path: str) -> None:
        import json, os

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        arrays = {"cluster_ptr": np.asarray(self._cluster_ptr)}
        meta = {"cls": type(self).__name__, "metric": self.metric.value}
        for name in self._state_scalars:
            v = getattr(self, name)
            meta[name] = int(v) if isinstance(v, (int, np.integer)) else v
        for name in self._state_arrays + self._persist_extra_arrays:
            v = getattr(self, name, None)
            if v is not None:
                if jnp.dtype(v.dtype) == jnp.dtype(jnp.bfloat16):
                    v = v.astype(jnp.float32)
                arrays[name] = np.asarray(v)
        arrays["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        )
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str):
        import json

        from ..utils.dist import parse_ann_dist

        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
            if meta["cls"] != cls.__name__:
                raise ValueError(f"{path} holds a {meta['cls']}, not {cls.__name__}")
            obj = cls.__new__(cls)
            obj.metric = parse_ann_dist(meta["metric"])
            for name in cls._state_scalars:
                setattr(obj, name, meta[name])
            for name in cls._state_arrays + cls._persist_extra_arrays:
                setattr(
                    obj, name,
                    jnp.asarray(z[name]) if name in z.files else None,
                )
            obj._cluster_ptr = z["cluster_ptr"]
        obj._post_load_hook()
        return obj

    def _post_load_hook(self):
        self.nlist = int(self.nlist)
        self.seg_size = int(self.seg_size)
