"""RaBitQ indexes: 1-bit residual quantisation with an unbiased estimator.

JAX rebuild of the reference's RaBitQ layer
(``src/binary/rabitq.rs`` + estimator ``dist_binary.rs:466-588``):

  * encoder: random orthogonal rotation (QR of a Gaussian, rabitq.rs:240-261);
    per vector, the *unit residual* to its centroid is rotated and its sign
    bits stored, plus two scalars — ``dist_to_centroid = ‖x−c‖`` and the
    L1-norm dot correction ``‖R·u‖₁`` (rabitq.rs:97-127);
  * estimator: ``⟨q,v⟩̂ = ⟨R·uq, sign⟩ / ‖R·u‖₁`` clamped to [−1,1], then
    ``d̂ = sqrt(‖v−c‖² + ‖q−c‖² − 2‖v−c‖‖q−c‖·⟨q,v⟩̂)`` (dist_binary.rs:564-587
    — the reference returns the *non-squared* estimate; matched here);
  * Deviation: the reference int4-quantises the rotated query residual to
    enable a u8 SIMD dot (rabitq.rs:140-207, dist_binary.rs:332-463). A matrix
    unit needs no such trick — the sign dot is an exact ±1 matmul, giving
    the same estimator with strictly less quantisation error.

Two indexes (reference exhaustive_rabitq.rs / ivf_rabitq.rs):
  * :class:`ExhaustiveIndexRaBitQ` — "exhaustive" in name but internally
    multi-centroid: 0.5·√n clusters, default nprobe = 20% of clusters
    (reference exhaustive_rabitq.rs:134-136, rabitq.rs:668);
  * :class:`IvfIndexRaBitQ` — standard IVF routing + estimation in probed
    cells. Both support exact rerank from the vector store.
"""

from __future__ import annotations

import math
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

import functools

from ...ops.binary import pack_bits, unpack_pm1
from ...ops.ivf_scan_pallas import fused_eligible, fused_ivf_scan
from ...ops.probe_device import build_probe_lists_device, device_probe_shapes
from ...ops.rerank import rerank_exact, rerank_from_store
from ...utils.dist import Dist
from ..ivf_base import IvfBase, route_to_cells
from .vec_store import DeviceVectorStore, MmapVectorStore

__all__ = ["RaBitQEncoder", "ExhaustiveIndexRaBitQ", "IvfIndexRaBitQ"]


class RaBitQEncoder:
    """Rotation + batch sign-bit encoding of unit residuals."""

    def __init__(self, rotation: jax.Array, dim: int):
        self.rotation = rotation  # [d, d]; apply as v @ rotation.T
        self.dim = dim
        self.n_words = (dim + 31) // 32

    @classmethod
    def create(cls, dim: int, seed: int = 42) -> "RaBitQEncoder":
        g = jax.random.normal(jax.random.key(seed), (dim, dim), jnp.float32)
        q, _ = jnp.linalg.qr(g)
        return cls(q, dim)

    def encode_vectors(
        self, x: jax.Array, owner_centroids: jax.Array
    ) -> tuple[jax.Array, jax.Array, jax.Array]:
        """Returns (packed sign bits [n, w], dist_to_centroid [n],
        dot_correction [n])."""
        r = x - owner_centroids
        v_dist = jnp.sqrt(jnp.sum(r * r, axis=-1))
        u = r / jnp.maximum(v_dist, 1e-12)[:, None]
        # HIGHEST: sign bits + L1 correction come from this product; a
        # reduced-precision DEFAULT pass flips near-zero signs and biases
        # ‖R·u‖₁
        ru = jnp.matmul(
            u, self.rotation.T, precision=jax.lax.Precision.HIGHEST
        )
        bits = pack_bits(ru >= 0)
        dot_corr = jnp.sum(jnp.abs(ru), axis=-1)
        return bits, v_dist, dot_corr

    def rotate_padded(self, v: jax.Array) -> jax.Array:
        """Rotate and zero-pad the lane dim to w·32 (scan operand layout)."""
        r = jnp.matmul(
            v, self.rotation.T, precision=jax.lax.Precision.HIGHEST
        )
        pad = self.n_words * 32 - self.dim
        if pad:
            r = jnp.concatenate(
                [r, jnp.zeros(r.shape[:-1] + (pad,), r.dtype)], axis=-1
            )
        return r

    def memory_usage_bytes(self) -> int:
        return int(self.rotation.size) * 4


@functools.partial(
    jax.jit,
    static_argnames=(
        "nprobe_seg", "nseg", "maxq", "R", "k", "route_metric", "kb",
    ),
)
def _fused_rabitq_e2e(
    q, q_rot, route_cents, x_scaled, sn2, seg_offsets, seg_counts,
    seg_cents_rot, ones_scales, *, nprobe_seg, nseg, maxq, R, k,
    route_metric, kb,
):
    """Route (index metric) → invert → fused estimator scan, one dispatch.

    The RaBitQ estimator rides the stock ``i8dec_residual`` epilogue with
    the per-row multiplier folded into storage: rows ``x′ = ±1·(sn/corr)``
    give ``d̂² = ‖qr‖² + sn² − 2·⟨qr, x′⟩`` = the reference estimator
    (dist_binary.rs:564-587) squared, minus the rarely-active ±1 clip.
    Returns device ``(d̂² [nq,k], sorted-storage positions [nq,k])``."""
    probes = route_to_cells(q, route_cents, nprobe_seg, route_metric)
    cluster_ids, lists, gmap = build_probe_lists_device(
        probes.astype(jnp.int32), nseg, maxq, R
    )
    return fused_ivf_scan(
        q_rot, cluster_ids, lists, gmap, x_scaled, sn2,
        seg_offsets, seg_counts, seg_cents_rot, k, Dist.EUCLIDEAN,
        "i8dec_residual", ones_scales, kb,
    )


class _RaBitQBase(IvfBase):
    """Shared build/query for the two RaBitQ indexes."""

    mode = "rabitq"
    _state_arrays = IvfBase._state_arrays + ("aux_corr", "rotation")
    _state_scalars = IvfBase._state_scalars + ("store_path", "fast_scan")
    _persist_extra_arrays = ("store_vectors",)

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        nlist: int | None = None,
        max_iters: int = 30,
        seed: int = 42,
        store: str | bool = True,
        fast_scan: bool = True,
        verbose: bool = False,
    ):
        n = as_f32_shape(mat)
        if nlist is None:
            nlist = self._default_nlist(n)
        self._store_arg = store
        self.fast_scan = bool(fast_scan)
        super().__init__(
            mat, metric, nlist=nlist, max_iters=max_iters, seed=seed,
            verbose=verbose,
        )

    def _default_nlist(self, n: int) -> int:
        raise NotImplementedError

    def _encode_storage(self, x_sorted, seed):
        self.encoder = RaBitQEncoder.create(self.dim, seed)
        self.rotation = self.encoder.rotation
        owner = self._owner_clusters()
        codes, v_dists, dot_corrs = self.encoder.encode_vectors(
            x_sorted, self.centroids[owner]
        )
        self._pad_storage(codes, v_dists)
        self.aux_corr = jnp.concatenate(
            [dot_corrs, jnp.zeros((self.seg_size,), jnp.float32)]
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
        self.store_vectors = (
            self.store.vectors if isinstance(self.store, DeviceVectorStore) else None
        )
        self.store_path = self._store_arg if isinstance(self._store_arg, str) else ""

    def _encode_queries(self, q):
        return self.encoder.rotate_padded(q)

    def _scan_seg_centroids(self):
        return self.encoder.rotate_padded(self.seg_centroids)

    def _aux(self):
        return self.aux_corr

    def _fallback_vectors(self):
        if isinstance(self.store, DeviceVectorStore):
            return self.store.vectors, None, self.original_ids[: self.n]
        return None

    def query(
        self,
        query_mat: Any,
        k: int,
        nprobe: int | None = None,
        rerank: str | None = None,
        rerank_factor: int = 10,
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

        k_scan = k if rerank != "exact" else min(max(k, k * rerank_factor), self.n)
        if self._fused_est_ok(k_scan):
            d, i = self._fused_estimator(q, k_scan, nprobe)
            if rerank != "exact":
                # the fused scan folds sn/corr into storage, which drops the
                # estimator's ±1 clip (overshoot hits near-duplicates);
                # re-estimate the returned slots with the exact clipped
                # formula — [nq, k] work, stays on device
                d, i = self._rescore_estimator(q, jnp.asarray(i), jnp.asarray(d))
        else:
            d, i = self._scan(q, k_scan, nprobe)

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

    def _fused_est_ok(self, k_scan: int) -> bool:
        import os

        if os.environ.get("ANNSEARCH_NO_FAST_HAMMING"):
            return False
        nbits = self.encoder.n_words * 32
        return (
            self.fast_scan
            and self.n * nbits * 2 <= (2 << 30)
            and fused_eligible(
                "i8dec_residual", self.seg_size, nbits, min(k_scan, 128)
            )
        )

    def _est_rows(self):
        """±1 rows scaled by sn/corr (bf16, cached) + sn² — the storage
        form that makes the estimator a stock residual-l2 scan."""
        cached = getattr(self, "_est_rows_cache", None)
        if cached is None:
            nbits = self.encoder.n_words * 32
            pm = unpack_pm1(self.storage, self.dim).astype(jnp.float32)
            if nbits > self.dim:  # zero the rotation's lane padding
                pm = jnp.concatenate(
                    [pm, jnp.zeros((pm.shape[0], nbits - self.dim))], axis=1
                )
            mult = jnp.where(
                self.aux_corr > 1e-6,
                self.store_sqnorms / jnp.maximum(self.aux_corr, 1e-12),
                0.0,
            )
            x_scaled = (pm * mult[:, None]).astype(jnp.bfloat16)
            cached = (x_scaled, self.store_sqnorms**2)
            self._est_rows_cache = cached
        return cached

    def _fused_estimator(self, q, k_scan, nprobe):
        nq = q.shape[0]
        nseg = int(self.seg_offsets.shape[0])
        nprobe_seg = min(
            nseg, max(nprobe, -(-nprobe * nseg) // max(self.nlist, 1))
        )
        maxq, R = device_probe_shapes(nq, nprobe_seg, nseg, 1)
        x_scaled, sn2 = self._est_rows()
        kb = min(128, max(8, 1 << (min(k_scan, 128) - 1).bit_length()))
        nbits = self.encoder.n_words * 32
        return _fused_rabitq_e2e(
            q, self._encode_queries(q), self.seg_centroids, x_scaled,
            sn2, self.seg_offsets, self.seg_counts,
            self._scan_seg_centroids(),
            jnp.ones((nbits,), jnp.float32),
            nprobe_seg=nprobe_seg, nseg=nseg, maxq=maxq, R=R, k=k_scan,
            route_metric=self.metric, kb=kb,
        )

    def _owner_j(self):
        cached = getattr(self, "_owner_j_cache", None)
        if cached is None:
            owners = np.zeros(self.storage.shape[0], np.int32)
            owners[: self.n] = np.asarray(self._owner_clusters())
            cached = jnp.asarray(owners)
            self._owner_j_cache = cached
        return cached

    def _rescore_estimator(self, q, pos, d_in):
        """Exact clipped estimator (dist_binary.rs:564-587) for the given
        [nq, k] storage positions; invalid slots (inf in ``d_in``) stay inf."""
        owners = self._owner_j()
        q_rot = self._encode_queries(q)                       # [nq, nbits]
        cent_rot = self.encoder.rotate_padded(self.centroids)  # [nlist, nbits]
        posc = jnp.clip(pos, 0, self.storage.shape[0] - 1)
        codes = self.storage[posc]                            # [nq, k, w]
        nbits = codes.shape[-1] * 32
        pm = unpack_pm1(
            codes.reshape(-1, codes.shape[-1]), nbits
        ).astype(jnp.float32).reshape(posc.shape + (nbits,))[..., : self.dim]
        sn = self.store_sqnorms[posc]                         # [nq, k]
        corr = self.aux_corr[posc]
        qr = q_rot[:, None, : self.dim] - cent_rot[owners[posc]][..., : self.dim]
        qd = jnp.sqrt(jnp.sum(qr * qr, axis=-1))
        qu = qr / jnp.maximum(qd, 1e-12)[..., None]
        inner = jnp.sum(qu.astype(jnp.bfloat16).astype(jnp.float32) * pm, -1)
        est = jnp.where(
            corr > 1e-6,
            jnp.clip(inner / jnp.maximum(corr, 1e-12), -1.0, 1.0),
            0.0,
        )
        d2 = sn**2 + qd**2 - 2.0 * sn * qd * est
        d = jnp.sqrt(jnp.maximum(d2, 0.0))
        d = jnp.where(jnp.isfinite(d_in), d, jnp.inf)
        order = jnp.argsort(d, axis=-1)
        return (
            jnp.take_along_axis(d, order, axis=-1),
            jnp.take_along_axis(posc, order, axis=-1),
        )

    def generate_knn(self, k: int, nprobe: int | None = None, **kw):
        if isinstance(self.store, DeviceVectorStore):
            return self.query(self.vectors_original_order(), k, nprobe=nprobe, **kw)
        raise ValueError("self-query requires a device vector store")

    def _decoded_sorted(self) -> np.ndarray:
        if not isinstance(self.store, DeviceVectorStore):
            raise ValueError("no device vector store")
        return np.asarray(self.store.vectors)

    def memory_usage_bytes(self) -> int:
        total = (
            int(self.storage.size) * 4
            + int(self.store_sqnorms.size + self.aux_corr.size) * 4
            + int(self.centroids.size + self.seg_centroids.size) * 4
            + self.encoder.memory_usage_bytes()
        )
        if self.store is not None:
            total += self.store.memory_usage_bytes()
        return total

    def _post_load_hook(self):
        super()._post_load_hook()
        self.fast_scan = bool(getattr(self, "fast_scan", True))
        self.encoder = RaBitQEncoder(self.rotation, self.dim)
        if self.store_vectors is not None:
            self.store = DeviceVectorStore(self.store_vectors)
        elif self.store_path:
            self.store = MmapVectorStore.open(self.store_path)
        else:
            self.store = None


def as_f32_shape(mat) -> int:
    return np.asarray(mat).shape[0]


class ExhaustiveIndexRaBitQ(_RaBitQBase):
    """Flat-API RaBitQ: internally 0.5·√n clusters, default probe 20%
    (reference exhaustive_rabitq.rs:28-374)."""

    def _default_nlist(self, n: int) -> int:
        return max(1, int(0.5 * math.sqrt(n)))

    def default_nprobe(self) -> int:
        return max(1, int(0.2 * self.nlist))


class IvfIndexRaBitQ(_RaBitQBase):
    """IVF-style RaBitQ: √n cells, √nlist probes
    (reference ivf_rabitq.rs:28-647)."""

    def _default_nlist(self, n: int) -> int:
        return max(1, int(math.isqrt(n)))
