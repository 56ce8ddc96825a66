"""Flat binary index: Hamming scan + optional asymmetric / exact rerank.

JAX rebuild of the reference ``ExhaustiveIndexBinary``
(``src/binary/exhaustive_binary.rs:24-589``): vectors are binarised (SimHash
/ PCA / sign), queries scan packed codes with the ±1-matmul Hamming kernel,
and results can be refined in two tiers —

  * ``asymmetric``: float query projections × ±1 codes (reference
    :254-295), no extra storage;
  * ``exact``: gather ``k·rerank_factor`` candidates' full vectors from a
    vector store and re-score exactly (reference :374-424 via the mmap
    store).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ...ops.binary import (
    chunked_topk_asymmetric,
    chunked_topk_hamming,
    unpack_pm1,
)
from ...ops.rerank import rerank_exact, rerank_from_store
from ...ops.topk import chunked_topk
from ...utils.dist import Dist, normalise, sq_norms
from ..base import BaseIndex, as_f32_matrix
from .binariser import Binariser
from .vec_store import DeviceVectorStore, MmapVectorStore

__all__ = ["ExhaustiveIndexBinary"]


class ExhaustiveIndexBinary(BaseIndex):
    """Flat Hamming-scan index over binarised vectors."""

    _state_arrays = ("codes",)
    _state_scalars = ("n", "dim", "n_bits", "bin_mode", "store_path",
                      "fast_scan")
    _persist_extra_arrays = ("bin_proj", "bin_mean", "store_vectors")

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        n_bits: int | None = None,
        binarisation: str = "simhash",
        seed: int = 42,
        store: str | bool = True,
        fast_scan: bool = True,
    ):
        """``store``: True → keep f32 vectors in HBM for exact rerank;
        a path string → write an on-disk mmap store; False → no rerank.
        ``fast_scan``: cache the codes unpacked to ±1 once so Hamming /
        asymmetric scans are plain distance matmuls (the per-tile unpack
        is the scan's VPU bottleneck; ±1 operands are exact in one bf16
        tensor-core pass). Costs 4 B/bit extra HBM; auto-off above 2 GB."""
        self.fast_scan = bool(fast_scan)
        super().__init__(mat, metric)
        x = self.vectors  # normalised if cosine
        self.binariser = Binariser.train(x, n_bits, binarisation, seed)
        self.n_bits = self.binariser.n_bits
        self.bin_mode = self.binariser.mode
        self.codes = self.binariser.encode(x)

        if store is True:
            self.store = DeviceVectorStore(x)
        elif isinstance(store, str):
            self.store = MmapVectorStore.write(store, np.asarray(x))
        else:
            self.store = None
        self.vectors = None
        # persistence aliases (saved but not double-counted in memory)
        self.bin_proj = self.binariser.projections
        self.bin_mean = self.binariser.mean
        self.store_vectors = (
            self.store.vectors if isinstance(self.store, DeviceVectorStore) else None
        )
        self.store_path = store if isinstance(store, str) else ""

    def _post_load(self) -> None:
        self.n_bits = int(self.n_bits)
        self.fast_scan = bool(getattr(self, "fast_scan", True))
        self.codes = self.codes.astype(jnp.uint32)
        self.binariser = Binariser(
            self.bin_proj, self.bin_mean, self.n_bits, self.bin_mode
        )
        if self.store_vectors is not None:
            self.store = DeviceVectorStore(self.store_vectors)
        elif self.store_path:
            self.store = MmapVectorStore.open(self.store_path)
        else:
            self.store = None
        self.vectors = None

    def _fallback_vectors(self):
        from .vec_store import DeviceVectorStore

        if isinstance(self.store, DeviceVectorStore):
            return self.store.vectors, None, None
        return None

    # -- queries -----------------------------------------------------------

    def query(
        self,
        query_mat: Any,
        k: int,
        rerank: str | None = None,   # None|"asymmetric"|"exact"
        rerank_factor: int = 20,
        query_block: int = 1024,
        exact_fallback: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        q = self._prep_q(query_mat)
        k = self._clamp_k(k)
        if rerank == "exact" and self.store is None:
            raise ValueError("exact rerank requires a vector store")
        if (
            rerank == "exact"
            and exact_fallback
            and self._exact_fallback_ok(q.shape[0])
        ):
            # the exact-rerank tier's contract is exact-metric distances —
            # below the brute budget one matmul scan over the stored rows
            # is both faster and a strict quality upper bound
            return self._exact_query_small(q, k)

        fast = self._fast_scan_ok()
        if rerank is None:
            if fast:
                d, i = self._hamming_fast(q, k, query_block)
                return np.asarray(i), np.asarray(d)
            q_codes = self.binariser.encode(q)
            d, i = self._blocked(
                q_codes,
                query_block,
                lambda b: chunked_topk_hamming(
                    b, self.codes, k, self.n_bits, self.n
                ),
                k,
            )
            return i, d

        kc = min(max(k, k * rerank_factor), self.n)
        if rerank == "asymmetric":
            q_proj = self.binariser.project(q)
            if fast:
                # rank by l2 over ±1 codes ≡ rank by −dot (‖x±‖² = nbits and
                # ‖q‖² are per-row constants); recover −dot exactly after
                pm = self._codes_pm()  # materialise OUTSIDE the traced map
                d, i = self._blocked_dev(
                    q_proj,
                    query_block,
                    lambda b: chunked_topk(
                        b, pm, k, Dist.EUCLIDEAN,
                        precision=jax.lax.Precision.DEFAULT,
                    ),
                    k,
                )
                qsq = np.asarray(sq_norms(q_proj))[:, None]
                d_asym = (np.asarray(d) - qsq - float(self.n_bits)) * 0.5
                return np.asarray(i), d_asym
            pad = (-q_proj.shape[1]) % 32
            if pad:
                q_proj = jnp.concatenate(
                    [q_proj, jnp.zeros((q_proj.shape[0], pad), q_proj.dtype)], axis=1
                )
            d, i = self._blocked(
                q_proj,
                query_block,
                lambda b: chunked_topk_asymmetric(
                    b, self.codes, k, self.codes.shape[1] * 32, self.n
                ),
                k,
            )
            return i, d

        # exact: hamming-propose kc, gather, exact rerank
        if fast:
            d_sc, cand = self._hamming_fast(q, kc, query_block)
        else:
            q_codes = self.binariser.encode(q)
            d_sc, cand = self._blocked_dev(
                q_codes,
                query_block,
                lambda b: chunked_topk_hamming(
                    b, self.codes, kc, self.n_bits, self.n
                ),
                kc,
            )
        if isinstance(self.store, DeviceVectorStore):
            # candidates never leave the device: gather + exact rescore in
            # one compiled program, readback is [nq, k] only
            d, i = rerank_from_store(
                q, d_sc, cand.astype(jnp.int32), self.store.vectors,
                k, self.metric,
            )
            return np.asarray(i), np.asarray(d)
        return self._exact_rerank(q, np.asarray(cand), k)

    def _exact_rerank(self, q, cand, k, block=1024):
        ids_out, d_out = [], []
        for s in range(0, q.shape[0], block):
            qb = q[s : s + block]
            cb = jnp.asarray(cand[s : s + block])
            vecs = self.store.gather(np.asarray(cb))
            valid = jnp.ones(cb.shape, bool)
            d, i = rerank_exact(qb, vecs, cb, valid, k, self.metric)
            ids_out.append(np.asarray(i))
            d_out.append(np.asarray(d))
        return np.concatenate(ids_out), np.concatenate(d_out)

    def generate_knn(self, k: int, **kw):
        if self.store is not None and isinstance(self.store, DeviceVectorStore):
            return self.query(np.asarray(self.store.vectors), k, **kw)
        # codes-only self-query: hamming between stored codes
        k = self._clamp_k(k)
        if self._fast_scan_ok():
            pm = self._codes_pm()
            d, i = self._blocked_dev(
                pm,
                1024,
                lambda b: chunked_topk(
                    b, pm, k, Dist.EUCLIDEAN,
                    precision=jax.lax.Precision.DEFAULT,
                ),
                k,
            )
            return np.asarray(i), np.asarray(d) * 0.25
        d, i = self._blocked(
            self.codes,
            1024,
            lambda b: chunked_topk_hamming(b, self.codes, k, self.n_bits, self.n),
            k,
        )
        return i, d

    # -- plumbing ----------------------------------------------------------

    def _fast_scan_ok(self) -> bool:
        import os

        if os.environ.get("ANNSEARCH_NO_FAST_HAMMING"):
            return False
        return bool(self.fast_scan) and self.n * self.n_bits * 4 <= (2 << 30)

    def _codes_pm(self) -> jax.Array:
        """Codes unpacked to ±1 f32 (cached once; exact in one bf16 pass)."""
        cached = getattr(self, "_codes_pm_cache", None)
        if cached is None:
            cached = unpack_pm1(self.codes, self.n_bits).astype(jnp.float32)
            self._codes_pm_cache = cached
        return cached

    def _hamming_fast(self, q, k, query_block):
        """Hamming top-k over the cached ±1 codes: l2(q±, x±) = 4·hamming
        exactly (both norms are nbits), one bf16 matmul pass per tile —
        no per-tile unpack in the hot loop."""
        q_pm = unpack_pm1(
            self.binariser.encode(q), self.n_bits
        ).astype(jnp.float32)
        pm = self._codes_pm()  # materialise OUTSIDE the traced map
        d, i = self._blocked_dev(
            q_pm,
            query_block,
            lambda b: chunked_topk(
                b, pm, k, Dist.EUCLIDEAN,
                precision=jax.lax.Precision.DEFAULT,
            ),
            k,
        )
        return d * 0.25, i

    def _prep_q(self, query_mat):
        q = as_f32_matrix(query_mat)
        if q.shape[1] != self.dim:
            raise ValueError(f"query dim {q.shape[1]} != index dim {self.dim}")
        qj = jnp.asarray(q)
        return normalise(qj) if self.metric == Dist.COSINE else qj

    def _blocked_dev(self, q, query_block, kernel, k):
        """Blocked kernel map; results stay on device."""
        nq = q.shape[0]
        qb = min(query_block, max(nq, 8))
        pad = (-nq) % qb
        if pad:
            q = jnp.concatenate([q, jnp.zeros((pad, q.shape[1]), q.dtype)])
        blocks = q.reshape(-1, qb, q.shape[1])
        d, i = jax.lax.map(kernel, blocks)
        return d.reshape(-1, k)[:nq], i.reshape(-1, k)[:nq]

    def _blocked(self, q, query_block, kernel, k):
        d, i = self._blocked_dev(q, query_block, kernel, k)
        return np.asarray(d), np.asarray(i)

    def memory_usage_bytes(self) -> int:
        total = int(self.codes.size) * 4 + self.binariser.memory_usage_bytes()
        if self.store is not None:
            total += self.store.memory_usage_bytes()
        return total

    def vectors_original_order(self) -> np.ndarray:
        if isinstance(self.store, DeviceVectorStore):
            return np.asarray(self.store.vectors)
        raise ValueError("binary index without device store keeps no vectors")
