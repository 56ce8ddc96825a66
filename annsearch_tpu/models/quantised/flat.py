"""Flat (exhaustive-scan) quantised indexes: bf16, SQ8, PQ, OPQ.

JAX rebuild of the reference's quantised exhaustive indexes
(``src/quantised/exhaustive_bf16.rs`` / ``exhaustive_sq8.rs`` /
``exhaustive_pq.rs`` / ``exhaustive_opq.rs``): compressed storage + blocked
quantised distance scans (``ops/quantised.py``) instead of per-row SIMD
loops. Self-query decodes storage block-wise (the reference also
reconstructs for self-kNN, e.g. ivf_pq.rs:438-465).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ...ops.quantised import (
    chunked_topk_bf16,
    chunked_topk_pq,
    chunked_topk_sq8,
)
from ...utils.dist import Dist, normalise, sq_norms
from ..base import BaseIndex, as_f32_matrix
from .quantisers import (
    OptimisedProductQuantiser,
    ProductQuantiser,
    ScalarQuantiser,
)

__all__ = [
    "ExhaustiveIndexBf16",
    "ExhaustiveSq8Index",
    "ExhaustivePqIndex",
    "ExhaustiveOpqIndex",
]


class _QuantisedFlat(BaseIndex):
    """Shared blocking/clamping for flat quantised indexes."""

    def _blocked(self, q: jax.Array, k: int, query_block: int, kernel):
        nq = q.shape[0]
        qb = min(query_block, max(nq, 8))
        pad = (-nq) % qb
        if pad:
            q = jnp.concatenate([q, jnp.zeros((pad, q.shape[1]), q.dtype)])
        blocks = q.reshape(-1, qb, q.shape[1])
        d, i = jax.lax.map(kernel, blocks)
        return (
            np.asarray(i.reshape(-1, k)[:nq]),
            np.asarray(d.reshape(-1, k)[:nq]),
        )

    def generate_knn(self, k: int, **kw):
        return self.query(self._decoded_queries(), k, **kw)

    def _decoded_queries(self) -> np.ndarray:
        raise NotImplementedError


class ExhaustiveIndexBf16(_QuantisedFlat):
    """Flat scan over bf16 storage (reference exhaustive_bf16.rs:23-338)."""

    _state_arrays = ("vectors", "sqnorms")

    def __init__(self, mat: Any, metric: str = "euclidean"):
        super().__init__(mat, metric)
        self.vectors = self.vectors.astype(jnp.bfloat16)
        # sqnorms of the *stored* (rounded) values so the matmul identity
        # ‖q‖²+‖x‖²−2q·x is exact for the bf16 reconstruction
        self.sqnorms = sq_norms(self.vectors.astype(jnp.float32))

    def query(self, query_mat: Any, k: int, query_block: int = 1024):
        q = self._prep_queries(query_mat)
        k = self._clamp_k(k)
        return self._blocked(
            q,
            k,
            query_block,
            lambda b: chunked_topk_bf16(
                b, self.vectors, self.sqnorms, k, self.metric, self.n
            ),
        )

    def _decoded_queries(self) -> np.ndarray:
        return np.asarray(self.vectors.astype(jnp.float32))

    def _post_load(self) -> None:
        self.vectors = self.vectors.astype(jnp.bfloat16)


class ExhaustiveSq8Index(_QuantisedFlat):
    """Flat int8 scan with quantised query and integer distances
    (reference exhaustive_sq8.rs; dist semantics dist.rs:4228-4324)."""

    _state_arrays = ("codes", "code_sqnorms", "scales")

    def __init__(self, mat: Any, metric: str = "euclidean"):
        super().__init__(mat, metric)
        x = self.vectors
        self.quantiser = ScalarQuantiser.train(x)
        self.scales = self.quantiser.scales
        self.codes = self.quantiser.encode(x)
        c32 = self.codes.astype(jnp.int32)
        self.code_sqnorms = jnp.sum(c32 * c32, axis=-1)
        self.vectors = None  # compressed storage only

    def query(self, query_mat: Any, k: int, query_block: int = 1024):
        q = self._prep_queries(query_mat)
        k = self._clamp_k(k)
        q_i8 = self.quantiser.encode(q)
        return self._blocked(
            q_i8,
            k,
            query_block,
            lambda b: chunked_topk_sq8(
                b, self.codes, self.code_sqnorms, k, self.metric, self.n
            ),
        )

    def _prep_queries(self, query_mat):
        q = as_f32_matrix(query_mat)
        if q.shape[1] != self.dim:
            raise ValueError(f"query dim {q.shape[1]} != index dim {self.dim}")
        qj = jnp.asarray(q)
        return normalise(qj) if self.metric == Dist.COSINE else qj

    def _decoded_queries(self) -> np.ndarray:
        return np.asarray(self.quantiser.decode(self.codes))

    def vectors_original_order(self) -> np.ndarray:
        return self._decoded_queries()

    def _post_load(self) -> None:
        self.quantiser = ScalarQuantiser(self.scales)


class ExhaustivePqIndex(_QuantisedFlat):
    """Flat ADC-equivalent scan over PQ codes (reference exhaustive_pq.rs;
    ADC dist.rs:4333-4495 → decode-by-matmul, see ops/quantised.py)."""

    _state_arrays = ("codes", "code_sqnorms", "codebooks")
    _state_scalars = ("n", "dim", "m")

    def __init__(self, mat: Any, m: int = 16, metric: str = "euclidean", seed: int = 42):
        super().__init__(mat, metric)
        x = self.vectors
        self.m = m
        self.quantiser = ProductQuantiser.train(x, m, seed=seed)
        self.codebooks = self.quantiser.codebooks
        self.codes = self.quantiser.encode(x)
        self.code_sqnorms = self.quantiser.code_sqnorms(self.codes)
        self.vectors = None

    def query(self, query_mat: Any, k: int, query_block: int = 1024):
        q = self._prep_queries_pq(query_mat)
        k = self._clamp_k(k)
        return self._blocked(
            q,
            k,
            query_block,
            lambda b: chunked_topk_pq(
                b,
                self.codes,
                self.code_sqnorms,
                self.codebooks,
                k,
                self.metric,
                self.n,
            ),
        )

    def _prep_queries_pq(self, query_mat):
        q = as_f32_matrix(query_mat)
        if q.shape[1] != self.dim:
            raise ValueError(f"query dim {q.shape[1]} != index dim {self.dim}")
        qj = jnp.asarray(q)
        return normalise(qj) if self.metric == Dist.COSINE else qj

    def _decoded_queries(self) -> np.ndarray:
        return np.asarray(self.quantiser.decode(self.codes))

    def vectors_original_order(self) -> np.ndarray:
        return self._decoded_queries()

    def _post_load(self) -> None:
        self.m = int(self.m)
        self.quantiser = ProductQuantiser(self.codebooks, self.m, self.dim)


class ExhaustiveOpqIndex(ExhaustivePqIndex):
    """Flat OPQ index: learned rotation + PQ scan in rotated space
    (reference exhaustive_opq.rs; OPQ trainer quantisers.rs:476-846)."""

    _state_arrays = ("codes", "code_sqnorms", "codebooks", "rotation")
    _state_scalars = ("n", "dim", "m")

    def __init__(self, mat: Any, m: int = 16, metric: str = "euclidean", seed: int = 42):
        BaseIndex.__init__(self, mat, metric)
        x = self.vectors
        self.m = m
        opq = OptimisedProductQuantiser.train(x, m, seed=seed)
        self.opq = opq
        self.rotation = opq.rotation
        self.codebooks = opq.pq.codebooks
        self.codes = opq.encode(x)
        self.code_sqnorms = opq.pq.code_sqnorms(self.codes)
        self.quantiser = opq.pq
        self.vectors = None

    def _prep_queries_pq(self, query_mat):
        q = super()._prep_queries_pq(query_mat)
        # rotation is orthogonal: distances in rotated space equal original
        return q @ self.rotation

    def _decoded_queries(self) -> np.ndarray:
        return np.asarray(self.opq.decode(self.codes))

    def _post_load(self) -> None:
        self.m = int(self.m)
        pq = ProductQuantiser(self.codebooks, self.m, self.dim)
        self.quantiser = pq
        self.opq = OptimisedProductQuantiser(pq, self.rotation)
