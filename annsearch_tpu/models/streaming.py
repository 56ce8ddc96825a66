"""Bigger-than-HBM exact search: stream database chunks through the device.

The reference's scale axis is host RAM — databases live in `faer` matrices (or
the mmap vector store, vec_store.rs:16-204) and SIMD scans stream them through
CPU caches. On an accelerator the analogue is device-memory residency, which
caps out at the card's memory: this index keeps the database on the HOST (numpy
array or the same raw ``.vec`` file format as :class:`MmapVectorStore`) and
streams row chunks through the device, folding each chunk into a running top-k
with the same merge used by the on-device tile scan (``ops/topk.merge_topk``).

Per chunk the device work is one distance matmul + top-k; uploads overlap
compute through JAX's async dispatch (the next ``device_put`` is issued
while the previous chunk's matmul runs). Queries stay resident across the
whole pass, so total PCIe traffic is ``n·d·4`` bytes per query batch —
bandwidth-bound exactly like the reference's RAM scan, with the matrix
units doing the arithmetic.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.topk import chunked_topk, merge_topk
from ..utils.dist import Dist, normalise, parse_ann_dist
from .base import as_f32_matrix

__all__ = ["StreamingExhaustiveIndex"]


class StreamingExhaustiveIndex:
    """Exact top-k over a host-resident (RAM or mmap) database."""

    def __init__(self, mat: Any, metric: str | Dist = "euclidean"):
        """``mat``: an ``[n, d]`` array-like kept on host, or a path string
        to a raw vector file written by :meth:`write` (``<path>.vec`` +
        ``<path>.json``, the MmapVectorStore format)."""
        self.metric = parse_ann_dist(metric) if isinstance(metric, str) else metric
        if isinstance(mat, str):
            with open(mat + ".json") as f:
                meta = json.load(f)
            self._x = np.memmap(
                mat + ".vec", dtype=np.float32, mode="r",
                shape=(meta["n"], meta["dim"]),
            )
        else:
            self._x = as_f32_matrix(mat)
        self.n, self.dim = self._x.shape
        if self.metric == Dist.COSINE:
            # per-chunk normalisation happens on device during the scan;
            # precomputing on host would force a full-copy materialisation
            self._norm_chunks = True
        else:
            self._norm_chunks = False

    @staticmethod
    def write(path: str, vectors: np.ndarray) -> "StreamingExhaustiveIndex":
        arr = np.ascontiguousarray(np.asarray(vectors, np.float32))
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        arr.tofile(path + ".vec")
        with open(path + ".json", "w") as f:
            json.dump({"n": int(arr.shape[0]), "dim": int(arr.shape[1]),
                       "dtype": "float32"}, f)
        return StreamingExhaustiveIndex(path)

    def query(
        self,
        query_mat: Any,
        k: int,
        chunk_rows: int = 262_144,
    ) -> tuple[np.ndarray, np.ndarray]:
        q = jnp.asarray(as_f32_matrix(query_mat))
        if q.shape[1] != self.dim:
            raise ValueError(f"query dim {q.shape[1]} != index dim {self.dim}")
        if self.metric == Dist.COSINE:
            q = normalise(q)
        k = max(1, min(k, self.n))
        nq = q.shape[0]
        best_d = jnp.full((nq, k), jnp.inf, jnp.float32)
        best_i = jnp.zeros((nq, k), jnp.int32)

        step = max(k, int(chunk_rows))
        for base in range(0, self.n, step):
            rows = min(step, self.n - base)
            xb = np.asarray(self._x[base : base + rows])
            if rows < step:  # pad the last chunk: one compiled shape
                xb = np.concatenate(
                    [xb, np.zeros((step - rows, self.dim), np.float32)]
                )
            xj = jax.device_put(xb)
            best_d, best_i = _fold_chunk(
                q, xj, best_d, best_i, base, rows, k, self.metric,
                self._norm_chunks,
            )
        return np.asarray(best_i), np.asarray(best_d)

    def generate_knn(self, k: int, **kw) -> tuple[np.ndarray, np.ndarray]:
        # self-query in query-batch blocks (queries also stream from host)
        outs_i, outs_d = [], []
        qb = 8192
        for s in range(0, self.n, qb):
            i, d = self.query(np.asarray(self._x[s : s + qb]), k, **kw)
            outs_i.append(i)
            outs_d.append(d)
        return np.concatenate(outs_i), np.concatenate(outs_d)

    def memory_usage_bytes(self) -> int:
        return 0  # host/mmap resident; device holds one chunk at a time


@functools.partial(jax.jit, static_argnames=("k", "metric", "norm"))
def _fold_chunk(q, xj, best_d, best_i, base, rows, k, metric, norm):
    if norm:
        xj = normalise(xj)
    d, i = chunked_topk(q, xj, k, metric, n_valid=rows)
    return merge_topk(best_d, best_i, d, i + base, k)
