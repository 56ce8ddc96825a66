"""Exhaustive (flat / brute-force) index.

JAX rebuild of the reference's ``ExhaustiveIndex``
(``src/cpu/exhaustive.rs:18-274`` — per-query linear scan with a bounded
max-heap) and its GPU twin (``src/gpu/exhaustive_gpu.rs`` +
``dist_gpu.rs:533-705``): here the scan is a blocked distance matmul on the
tensor-core with a running top-k carried across database tiles
(:mod:`annsearch_tpu.ops.topk`). Build = put vectors on device; this index is
also the ground-truth engine for recall validation.
"""

from __future__ import annotations

from typing import Any

import jax
import numpy as np

from ..ops.topk import DEFAULT_DB_CHUNK, DEFAULT_QUERY_BLOCK, blocked_query_topk
from .base import BaseIndex

__all__ = ["ExhaustiveIndex"]


class ExhaustiveIndex(BaseIndex):
    """Flat index: exact top-k via full scan."""

    _x64 = None  # host f64 copy (load() bypasses __init__)

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        precision=jax.lax.Precision.HIGHEST,
    ):
        # f64 inputs keep a host-side f64 copy: the reference's distance
        # kernels are generic over f32/f64 (dist.rs:113-2263); the matrix
        # units have no f64 path, so f64 grade comes from a device f32 HIGHEST
        # pre-selection (pool 2k) + a host f64 rescore of the pool.
        self._x64 = None
        if isinstance(mat, np.ndarray) and mat.dtype == np.float64:
            self._x64 = np.ascontiguousarray(mat)
        super().__init__(mat, metric)
        self.precision = precision

    def query(
        self,
        query_mat: Any,
        k: int,
        query_block: int = DEFAULT_QUERY_BLOCK,
        db_chunk: int = DEFAULT_DB_CHUNK,
        selector: str = "exact",
    ) -> tuple[np.ndarray, np.ndarray]:
        """``selector``: "exact" (default — ground-truth quality),
        "approx" (per-tile approx_min_k) or "bins" (selection-free running
        bins, ~1e-5 tail loss)."""
        q64 = None
        if (
            self._x64 is not None
            and isinstance(query_mat, np.ndarray)
            and query_mat.dtype == np.float64
        ):
            q64 = query_mat
        q = self._prep_queries(query_mat)
        k = self._clamp_k(k)
        kp = min(2 * k, self.n) if q64 is not None else k
        d, i = blocked_query_topk(
            q,
            self.vectors,
            kp,
            self.metric,
            x_sqnorm=self.sqnorms,
            query_block=query_block,
            db_chunk=db_chunk,
            precision=self.precision,
            selector=selector,
        )
        if q64 is not None:
            return self._rescore_f64(q64, np.asarray(i), k)
        return np.asarray(i), np.asarray(d)

    def _rescore_f64(
        self, q64: np.ndarray, pool: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Host f64 rescore of the device-selected candidate pool."""
        from .base import rescore_f64_pool

        return rescore_f64_pool(self._x64, q64, pool, k, self.metric)

    def generate_knn(
        self,
        k: int,
        query_block: int = DEFAULT_QUERY_BLOCK,
        db_chunk: int = DEFAULT_DB_CHUNK,
        selector: str = "exact",
    ) -> tuple[np.ndarray, np.ndarray]:
        k = self._clamp_k(k)
        d, i = blocked_query_topk(
            self.vectors,
            self.vectors,
            k,
            self.metric,
            x_sqnorm=self.sqnorms,
            query_block=query_block,
            db_chunk=db_chunk,
            precision=self.precision,
            selector=selector,
        )
        return np.asarray(i), np.asarray(d)

    def _post_load(self) -> None:
        self.precision = jax.lax.Precision.HIGHEST
