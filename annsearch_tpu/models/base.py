"""Shared index machinery.

Every index in the framework follows the reference's uniform shape
(SURVEY §1: ``build`` / ``query`` / ``generate_knn`` / ``memory_usage_bytes``,
e.g. ``src/cpu/exhaustive.rs``), plus ``save``/``load`` which the reference
lacks (its only persistence is the mmap vector store,
``src/binary/vec_store.rs``) — here the index state is plain arrays, so
persistence is nearly free.

Conventions (matching the reference):
  * ``query`` returns ``(indices [nq, k], distances [nq, k])`` sorted
    ascending by distance; euclidean distances are *squared*.
  * ``k`` is clamped to the number of stored vectors.
  * self-query (``generate_knn``) includes the query point itself
    (reference ``generate_knn`` simply re-queries each stored row,
    cpu/exhaustive.rs:220-252).
"""

from __future__ import annotations

import json
import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.dist import Dist, normalise, parse_ann_dist, sq_norms

__all__ = [
    "BaseIndex", "as_f32_matrix", "DTYPE_BYTES", "BRUTE_QUERY_FLOP_BUDGET",
    "rescore_f64_pool",
]


def rescore_f64_pool(
    x64: np.ndarray,
    q64: np.ndarray,
    pool: np.ndarray,
    k: int,
    metric: Dist,
) -> tuple[np.ndarray, np.ndarray]:
    """Host f64 rescore of a device-selected candidate pool.

    The reference's distance kernels are generic over f32/f64
    (dist.rs:113-2263); the matrix units have no f64 path, so f64 grade comes
    from a device f32 HIGHEST pre-selection (pool ≥ 2k) + this host f64 rescore
    of the pooled rows. ``x64`` is the raw f64 data in original row order;
    ``pool [nq, kp]`` holds original ids. Returns ``(ids [nq, k], dists [nq,
    k])`` ascending, distances computed fully in f64."""
    if metric == Dist.COSINE:
        xn = x64 / np.maximum(
            np.linalg.norm(x64, axis=1, keepdims=True), 1e-30
        )
        qn = q64 / np.maximum(
            np.linalg.norm(q64, axis=1, keepdims=True), 1e-30
        )
        dx = 1.0 - np.einsum("qd,qpd->qp", qn, xn[pool])
    else:
        diff = q64[:, None, :] - x64[pool]
        dx = np.einsum("qpd,qpd->qp", diff, diff)
    # duplicate pool entries (clipped sentinel slots, multi-path candidate
    # pools) must not surface as duplicate output ids — keep one copy
    order_ids = np.argsort(pool, axis=1, kind="stable")
    sorted_pool = np.take_along_axis(pool, order_ids, axis=1)
    dup_sorted = np.zeros(pool.shape, bool)
    dup_sorted[:, 1:] = sorted_pool[:, 1:] == sorted_pool[:, :-1]
    dup = np.zeros(pool.shape, bool)
    np.put_along_axis(dup, order_ids, dup_sorted, axis=1)
    dx = np.where(dup, np.inf, dx)
    order = np.argsort(dx, axis=1)[:, :k]
    return (
        np.take_along_axis(pool, order, axis=1),
        np.take_along_axis(dx, order, axis=1),
    )

#: Same economics inversion as the build-side brute path
#: (models/graph.BRUTE_BUILD_FLOP_BUDGET): below this nq·n·d MAC count one
#: exact tensor-core scan answers the batch faster than any sublinear structure
#: can walk it. Indexes that
#: keep full-precision rows route small-regime queries through it; pass
#: ``exact_fallback=False`` (or set ANNSEARCH_NO_EXACT_FALLBACK=1) to
#: force the native algorithm.
BRUTE_QUERY_FLOP_BUDGET = 250_000 * 250_000 * 64

DTYPE_BYTES = {
    jnp.dtype(jnp.float32): 4,
    jnp.dtype(jnp.float64): 8,
    jnp.dtype(jnp.bfloat16): 2,
    jnp.dtype(jnp.float16): 2,
    jnp.dtype(jnp.int8): 1,
    jnp.dtype(jnp.uint8): 1,
    jnp.dtype(jnp.int32): 4,
    jnp.dtype(jnp.uint32): 4,
    jnp.dtype(jnp.int64): 8,
}


def as_f32_matrix(mat: Any) -> np.ndarray:
    """Coerce input to a C-contiguous ``[n, d]`` float32 matrix
    (the reference's ``matrix_to_flat``, utils/mod.rs:40-53).

    Device arrays pass through (cast only) — round-tripping a large on-device
    dataset through host memory costs minutes on slow host links."""
    if isinstance(mat, jax.Array) and not isinstance(mat, np.ndarray):
        if mat.ndim != 2:
            raise ValueError(f"expected a 2-D matrix, got shape {mat.shape}")
        return mat.astype(jnp.float32)
    arr = np.asarray(mat, dtype=np.float32)
    if arr.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got shape {arr.shape}")
    return np.ascontiguousarray(arr)


class BaseIndex:
    """Base class: stores vectors on device, handles metric preparation.

    For cosine, vectors are stored L2-normalised (distance = ``1 − QXᵀ``);
    for euclidean we keep raw vectors plus squared norms.
    """

    #: attribute names persisted by save/load (subclasses extend)
    _state_arrays: tuple[str, ...] = ("vectors", "sqnorms")
    _state_scalars: tuple[str, ...] = ("n", "dim")
    #: extra arrays persisted by save/load but NOT counted by
    #: memory_usage_bytes (aliases of derived state, e.g. binariser
    #: projections or rerank-store rows)
    _persist_extra_arrays: tuple[str, ...] = ()

    #: host f64 copy for the f64 rescore path (load() bypasses __init__,
    #: so loaded indexes answer at f32 grade until rebuilt from f64 data)
    _x64 = None

    def __init__(self, mat: Any, metric: str | Dist):
        arr = as_f32_matrix(mat)
        self.metric = parse_ann_dist(metric)
        self.n, self.dim = arr.shape
        x = jnp.asarray(arr)
        if self.metric == Dist.COSINE:
            self.vectors = normalise(x)
            self.sqnorms = None
        else:
            self.vectors = x
            self.sqnorms = sq_norms(x)

    # -- query surface -------------------------------------------------

    def query(self, query_mat: Any, k: int, **kw) -> tuple[np.ndarray, np.ndarray]:
        """Top-k for a batch of queries. Returns numpy (idx, dist)."""
        raise NotImplementedError

    def generate_knn(self, k: int, **kw) -> tuple[np.ndarray, np.ndarray]:
        """Self-query: full kNN graph over stored vectors (self included)."""
        raise NotImplementedError

    def vectors_original_order(self) -> np.ndarray:
        """Stored vectors in *original* row order (indexes that reorder
        storage — e.g. IVF's cluster-contiguous layout — override this);
        row i corresponds to the id i returned by ``query``."""
        return np.asarray(self.vectors)

    # -- f64 rescore path -------------------------------------------------
    #
    # Reference distance kernels are generic over f32/f64 (dist.rs:113-2263);
    # the matrix units have no f64 path, so f64 grade comes from a widened
    # device pre-selection + a host f64 rescore of the pool. Raw-row families
    # opt in with three lines in __init__/query:
    #
    #     self._capture_f64(mat)                      # constructor
    #     r = self._f64_roundtrip(query_mat, k, ...)  # top of query()
    #     if r is not None: return r

    def _capture_f64(self, mat: Any) -> None:
        """Keep a host f64 copy when the build input is f64."""
        self._x64 = (
            np.ascontiguousarray(mat)
            if isinstance(mat, np.ndarray) and mat.dtype == np.float64
            else None
        )

    def _f64_roundtrip(
        self, query_mat: Any, k: int, **query_kw
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """f64-grade answer via recursion: re-enter ``query`` with the f32
        cast of the batch and a 2k pool, then rescore the pool on the host
        in f64. Returns None when the batch should take the normal path."""
        if (
            getattr(self, "_x64", None) is None
            or not isinstance(query_mat, np.ndarray)
            or query_mat.dtype != np.float64
        ):
            return None
        kc = max(1, min(int(k), self.n))
        pool_k = min(2 * kc, self.n)
        q32 = np.ascontiguousarray(query_mat, dtype=np.float32)
        pool, _ = self.query(q32, pool_k, **query_kw)
        return rescore_f64_pool(
            self._x64, query_mat, np.clip(pool, 0, self.n - 1),
            kc, self.metric,
        )

    # -- small-regime exact fallback -------------------------------------

    def _fallback_vectors(self):
        """``(vecs [n, d] f32, sqnorms or None, ids [n] or None)`` for the
        exact small-regime query path, or ``None`` if this index does not
        keep full-precision rows (quantised/binary storage)."""
        return None

    def _exact_fallback_ok(self, nq: int) -> bool:
        if os.environ.get("ANNSEARCH_NO_EXACT_FALLBACK"):
            return False
        if nq * self.n * self.dim > BRUTE_QUERY_FLOP_BUDGET:
            return False
        return self._fallback_vectors() is not None

    def _fallback_from_vectors(self):
        """Shared ``_fallback_vectors`` impl for indexes that keep the raw
        f32 rows in ``self.vectors`` (possibly with trailing sentinel/pad
        rows beyond ``self.n``)."""
        sq = None
        if self.metric == Dist.EUCLIDEAN and getattr(self, "sqnorms", None) is not None:
            sq = self.sqnorms[: self.n]
        return self.vectors[: self.n], sq, None

    def _exact_query_small(self, qj: jax.Array, k: int):
        """Exact top-k over the full-precision rows (recall 1.0 by
        construction); returns numpy ``(ids, dists)`` like ``query``."""
        from ..ops.topk import blocked_query_topk

        vecs, sq, ids = self._fallback_vectors()
        k = max(1, min(int(k), vecs.shape[0]))
        d, i = blocked_query_topk(
            qj, vecs, k, self.metric, x_sqnorm=sq,
            precision=jax.lax.Precision.HIGHEST,
        )
        i = np.asarray(i)
        if ids is not None:
            i = np.asarray(ids)[i]
        return i, np.asarray(d)

    # -- helpers ---------------------------------------------------------

    def _prep_queries(self, query_mat: Any) -> jax.Array:
        q = as_f32_matrix(query_mat)
        if q.shape[1] != self.dim:
            raise ValueError(
                f"query dim {q.shape[1]} != index dim {self.dim}"
            )
        qj = jnp.asarray(q)
        if self.metric == Dist.COSINE:
            qj = normalise(qj)
        return qj

    def _clamp_k(self, k: int) -> int:
        return max(1, min(int(k), self.n))

    # -- accounting ------------------------------------------------------

    def memory_usage_bytes(self) -> int:
        """Bytes of device state (reference ``memory_usage_bytes`` parity)."""
        total = 0
        for name in self._state_arrays:
            v = getattr(self, name, None)
            if v is not None:
                total += v.size * DTYPE_BYTES.get(jnp.dtype(v.dtype), 4)
        return total

    # -- persistence (new capability vs reference) -----------------------

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        arrays, meta = {}, {"cls": type(self).__name__, "metric": self.metric.value}
        for name in self._state_scalars:
            meta[name] = getattr(self, name)
        for name in self._state_arrays + self._persist_extra_arrays:
            v = getattr(self, name, None)
            if v is not None:
                # npz cannot hold bfloat16 — store as f32, subclasses recast
                # in _post_load
                if jnp.dtype(v.dtype) == jnp.dtype(jnp.bfloat16):
                    v = v.astype(jnp.float32)
                arrays[name] = np.asarray(v)
        arrays["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        )
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str) -> "BaseIndex":
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
                    obj,
                    name,
                    jnp.asarray(z[name]) if name in z.files else None,
                )
        obj._post_load()
        return obj

    def _post_load(self) -> None:
        """Hook for subclasses to rebuild derived state after load."""
