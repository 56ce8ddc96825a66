"""IVF binary index: float-centroid routing + packed binary cells.

JAX rebuild of the reference ``IvfIndexBinary``
(``src/binary/ivf_binary.rs:22-927``): k-means on the float vectors routes
queries to cells, cells hold packed codes, and the three query tiers —
Hamming / asymmetric / exact-rerank — run on the segmented cluster-major
scan engine (modes ``hamming`` / ``binary_asym``) followed by the shared
exact reranker.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ...ops.binary import unpack_pm1
from ...ops.ivf_scan_pallas import fused_eligible, fused_ivf_scan
from ...ops.probe_device import build_probe_lists_device, device_probe_shapes
from ...ops.rerank import rerank_exact, rerank_from_store
from ...utils.dist import Dist
from ..ivf_base import IvfBase, route_to_cells
from .binariser import Binariser
from .vec_store import DeviceVectorStore, MmapVectorStore

__all__ = ["IvfIndexBinary"]


@functools.partial(
    jax.jit,
    static_argnames=(
        "nprobe_seg", "nseg", "maxq", "R", "k", "route_metric", "kb",
    ),
)
def _fused_hamming_e2e(
    q, q_pm, route_cents, pm, sn, seg_offsets, seg_counts,
    seg_cents, *, nprobe_seg, nseg, maxq, R, k, route_metric, kb,
):
    """Route (index metric) → invert → fused bf16 scan over ±1 cell rows.

    ±1 operands are exact in one bf16 pass and ``l2 = 2·nbits − 2·dot =
    4·hamming`` exactly, so the hamming tier rides the same fused kernel as
    the dense modes — no per-tile unpack, one dispatch. Returns device
    ``(l2 dists [nq,k], sorted-storage positions [nq,k])``."""
    probes = route_to_cells(q, route_cents, nprobe_seg, route_metric)
    cluster_ids, lists, gmap = build_probe_lists_device(
        probes.astype(jnp.int32), nseg, maxq, R
    )
    return fused_ivf_scan(
        q_pm, cluster_ids, lists, gmap, pm, sn,
        seg_offsets, seg_counts, seg_cents, k, Dist.EUCLIDEAN, "bf16",
        None, kb,
    )


class IvfIndexBinary(IvfBase):
    """IVF routing over binarised cells."""

    mode = "hamming"

    _state_scalars = IvfBase._state_scalars + (
        "n_bits", "bin_mode", "store_path", "fast_scan"
    )
    _persist_extra_arrays = ("bin_proj", "bin_mean", "store_vectors")

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        nlist: int | None = None,
        n_bits: int | None = None,
        binarisation: str = "simhash",
        max_iters: int = 30,
        seed: int = 42,
        store: str | bool = True,
        fast_scan: bool = True,
        verbose: bool = False,
    ):
        self._n_bits_arg = n_bits
        self._binarisation = binarisation
        self._store_arg = store
        self.fast_scan = bool(fast_scan)
        super().__init__(
            mat, metric, nlist=nlist, max_iters=max_iters, seed=seed,
            verbose=verbose,
        )

    def _encode_storage(self, x_sorted, seed):
        self.binariser = Binariser.train(
            x_sorted, self._n_bits_arg, self._binarisation, seed
        )
        self.n_bits = self.binariser.n_bits
        codes = self.binariser.encode(x_sorted)
        self._pad_storage(
            codes, jnp.zeros((codes.shape[0],), jnp.float32)
        )
        if self._store_arg is True:
            self.store = DeviceVectorStore(x_sorted)
        elif isinstance(self._store_arg, str):
            self.store = MmapVectorStore.write(
                self._store_arg, np.asarray(x_sorted)
            )
        else:
            self.store = None
        # persistence aliases
        self.bin_mode = self.binariser.mode
        self.bin_proj = self.binariser.projections
        self.bin_mean = self.binariser.mean
        self.store_vectors = (
            self.store.vectors if isinstance(self.store, DeviceVectorStore) else None
        )
        self.store_path = self._store_arg if isinstance(self._store_arg, str) else ""

    def _post_load_hook(self):
        super()._post_load_hook()
        self.n_bits = int(self.n_bits)
        self.fast_scan = bool(getattr(self, "fast_scan", True))
        self.binariser = Binariser(
            self.bin_proj, self.bin_mean, self.n_bits, self.bin_mode
        )
        if self.store_vectors is not None:
            self.store = DeviceVectorStore(self.store_vectors)
        elif self.store_path:
            self.store = MmapVectorStore.open(self.store_path)
        else:
            self.store = None

    def _fallback_vectors(self):
        from .vec_store import DeviceVectorStore

        if isinstance(self.store, DeviceVectorStore):
            # store holds cluster-sorted rows; map back via original_ids
            return self.store.vectors, None, self.original_ids[: self.n]
        return None

    def query(
        self,
        query_mat: Any,
        k: int,
        nprobe: int | None = None,
        rerank: str | None = None,
        rerank_factor: int = 20,
        exact_fallback: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        q = self._prep_queries(query_mat)
        k = self._clamp_k(k)
        nprobe = self.default_nprobe() if nprobe is None else nprobe
        nprobe = max(1, min(nprobe, self.nlist))
        if rerank == "exact" and self.store is None:
            raise ValueError("exact rerank requires a vector store")
        if (
            rerank == "exact"
            and exact_fallback
            and self._exact_fallback_ok(q.shape[0])
        ):
            return self._exact_query_small(q, k)
        nq = q.shape[0]

        k_scan = k if rerank != "exact" else min(
            max(k, k * rerank_factor), self.n
        )
        if rerank == "asymmetric":
            q_eff = self.binariser.project(q)
            pad = (-q_eff.shape[1]) % 32
            if pad:
                q_eff = jnp.concatenate(
                    [q_eff, jnp.zeros((nq, pad), q_eff.dtype)], axis=1
                )
            mode = "binary_asym"
        else:
            q_eff = self.binariser.encode(q)
            mode = "hamming"

        if mode == "hamming" and self._fused_hamming_ok(k_scan):
            d, i = self._fused_hamming(q, k_scan, nprobe)
            if rerank is None:
                d = d * 0.25  # l2 over ±1 = 4·hamming exactly
        else:
            d, i = self._scan(q, k_scan, nprobe, mode=mode, q_eff=q_eff)

        if rerank == "exact":
            if isinstance(self.store, DeviceVectorStore):
                # scan outputs stay on device; gather + exact rescore run in
                # one compiled program and only [nq, k] crosses the link
                d, i = rerank_from_store(
                    q, jnp.asarray(d), jnp.asarray(i).astype(jnp.int32),
                    self.store.vectors, k, self.metric,
                )
                d = np.asarray(d)
                i = np.asarray(i)
            else:
                # mmap store: candidate rows must come through the host
                d = np.asarray(d)
                i = np.clip(np.asarray(i), 0, self.n - 1)
                valid = np.isfinite(d)
                block = 1024
                ids_out, d_out = [], []
                for s in range(0, nq, block):
                    cb = jnp.asarray(i[s : s + block])
                    vecs = self.store.gather(i[s : s + block])
                    dd, ii = rerank_exact(
                        q[s : s + block], vecs, cb,
                        jnp.asarray(valid[s : s + block]), k, self.metric,
                    )
                    ids_out.append(np.asarray(ii))
                    d_out.append(np.asarray(dd))
                i = np.concatenate(ids_out)
                d = np.concatenate(d_out)
        else:
            d = np.asarray(d)
            i = np.asarray(i)

        ids = np.asarray(self.original_ids)[np.clip(i, 0, self.n - 1)]
        return ids, d

    def _fused_hamming_ok(self, k_scan: int) -> bool:
        import os

        if os.environ.get("ANNSEARCH_NO_FAST_HAMMING"):
            return False
        return (
            self.fast_scan
            # the fused engine keeps ≤ 2 survivors per lane-residue class
            # per cell (depth-2 fold) before kb ≤ 128 extractions — under
            # hamming's massive ties a k·rerank_factor candidate pool
            # (k_scan 300) silently truncates per cell and IVF recall lands
            # BELOW flat (measured −0.17 at 50k×256d nl158). Large rerank
            # pools take the exact XLA cell scan instead.
            and k_scan <= 128
            and self.n * self.n_bits * 2 <= (2 << 30)
            and fused_eligible("bf16", self.seg_size, self.n_bits, k_scan)
        )

    def _pm_rows(self):
        """Storage unpacked to ±1 bf16 rows (cached; ‖row‖² = n_bits)."""
        cached = getattr(self, "_pm_rows_cache", None)
        if cached is None:
            pm = unpack_pm1(self.storage, self.n_bits)
            sn = jnp.full((pm.shape[0],), float(self.n_bits), jnp.float32)
            cached = (pm, sn)
            self._pm_rows_cache = cached
        return cached

    def _fused_hamming(self, q, k_scan, nprobe):
        """Single-dispatch hamming query over ±1 cell rows. Returns
        (l2 dists [nq,k] = 4·hamming, sorted-storage positions)."""
        nq = q.shape[0]
        nseg = int(self.seg_offsets.shape[0])
        nprobe_seg = min(
            nseg, max(nprobe, -(-nprobe * nseg) // max(self.nlist, 1))
        )
        maxq, R = device_probe_shapes(nq, nprobe_seg, nseg, 1)
        pm, sn = self._pm_rows()
        kb = min(128, max(8, 1 << (min(k_scan, 128) - 1).bit_length()))
        q_pm = unpack_pm1(
            self.binariser.encode(q), self.n_bits
        ).astype(jnp.float32)
        # centroids are unused by the bf16 l2 epilogue but must match the
        # scoring width (±1 lanes), so pass zeros in that space
        zero_cents = jnp.zeros((nseg, q_pm.shape[1]), jnp.float32)
        return _fused_hamming_e2e(
            q, q_pm, self.seg_centroids, pm, sn,
            self.seg_offsets, self.seg_counts, zero_cents,
            nprobe_seg=nprobe_seg, nseg=nseg, maxq=maxq, R=R, k=k_scan,
            route_metric=self.metric, kb=kb,
        )

    def generate_knn(self, k: int, nprobe: int | None = None, **kw):
        if isinstance(self.store, DeviceVectorStore):
            return self.query(self.vectors_original_order(), k, nprobe=nprobe, **kw)
        raise ValueError("self-query requires a device vector store")

    def _decoded_sorted(self) -> np.ndarray:
        if not isinstance(self.store, DeviceVectorStore):
            raise ValueError("binary index without device store keeps no vectors")
        return np.asarray(self.store.vectors)

    def memory_usage_bytes(self) -> int:
        total = (
            int(self.storage.size) * 4
            + int(self.centroids.size + self.seg_centroids.size) * 4
            + int(self.seg_counts.size + self.seg_offsets.size) * 4
            + int(self.original_ids.size) * 4
            + self.binariser.memory_usage_bytes()
        )
        if self.store is not None:
            total += self.store.memory_usage_bytes()
        return total
