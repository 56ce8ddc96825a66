"""Public API facade.

Free-function surface mirroring the reference's ``src/lib.rs``
(``build_<index>_index`` / ``query_<index>_index`` / ``query_<index>_self``).
Queries return ``(indices [nq, k] int, distances [nq, k] f32 | None)`` —
the array analogue of the reference's ``(Vec<Vec<usize>>, Option<Vec<Vec<T>>>)``.

Batch parallelism is implicit: instead of a rayon ``par_iter`` over query rows
(lib.rs:84-121) the whole query matrix is streamed through jitted blocked
kernels on the accelerator.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .models.exhaustive import ExhaustiveIndex
from .models.ivf import IvfIndex
from .models.quantised import (
    ExhaustiveIndexBf16,
    ExhaustiveOpqIndex,
    ExhaustivePqIndex,
    ExhaustiveSq8Index,
    IvfIndexBf16,
    IvfOpqIndex,
    IvfPqIndex,
    IvfSq8Index,
)

__all__ = [
    "build_exhaustive_index",
    "query_exhaustive_index",
    "query_exhaustive_self",
    "build_ivf_index",
    "query_ivf_index",
    "query_ivf_self",
    "build_exhaustive_bf16_index",
    "query_exhaustive_bf16_index",
    "query_exhaustive_bf16_self",
    "build_exhaustive_sq8_index",
    "query_exhaustive_sq8_index",
    "query_exhaustive_sq8_self",
    "build_exhaustive_pq_index",
    "query_exhaustive_pq_index",
    "query_exhaustive_pq_index_self",
    "build_exhaustive_opq_index",
    "query_exhaustive_opq_index",
    "query_exhaustive_opq_index_self",
    "build_ivf_bf16_index",
    "query_ivf_bf16_index",
    "query_ivf_bf16_self",
    "build_ivf_sq8_index",
    "query_ivf_sq8_index",
    "query_ivf_sq8_self",
    "build_ivf_pq_index",
    "query_ivf_pq_index",
    "query_ivf_pq_index_self",
    "build_ivf_opq_index",
    "query_ivf_opq_index",
    "query_ivf_opq_index_self",
    "build_exhaustive_index_binary",
    "query_exhaustive_index_binary",
    "query_exhaustive_index_binary_self",
    "build_ivf_index_binary",
    "query_ivf_index_binary",
    "query_ivf_index_binary_self",
    "build_exhaustive_index_rabitq",
    "query_exhaustive_index_rabitq",
    "query_exhaustive_index_rabitq_self",
    "build_ivf_index_rabitq",
    "query_ivf_index_rabitq",
    "query_ivf_index_rabitq_self",
    "build_nndescent_index",
    "query_nndescent_index",
    "query_nndescent_self",
    "build_nndescent_index_gpu",
    "query_nndescent_index_gpu",
    "query_nndescent_index_gpu_self",
    "extract_nndescent_knn_gpu",
    "build_exhaustive_index_gpu",
    "query_exhaustive_index_gpu",
    "query_exhaustive_index_gpu_self",
    "build_ivf_index_gpu",
    "query_ivf_index_gpu",
    "query_ivf_index_gpu_self",
    "build_hnsw_index",
    "query_hnsw_index",
    "query_hnsw_self",
    "build_vamana_index",
    "query_vamana_index",
    "query_vamana_self",
    "build_kmknn_index",
    "query_kmknn_index",
    "query_kmknn_self",
    "build_annoy_index",
    "query_annoy_index",
    "query_annoy_self",
    "build_balltree_index",
    "query_balltree_index",
    "query_balltree_self",
    "build_kd_tree_index",
    "query_kd_tree_index",
    "query_kd_tree_self",
    "build_lsh_index",
    "query_lsh_index",
    "query_lsh_self",
]


def _maybe_dist(idx: np.ndarray, dist: np.ndarray, return_dist: bool):
    return (idx, dist) if return_dist else (idx, None)


def _query(index, query_mat, verbose, *args, **kw):
    """Delegate to ``index.query`` with the reference's ``query_parallel``
    progress reporting (lib.rs:91-110): when verbose and the batch holds
    ≥100k queries, process in 100k chunks and print
    ``  Processed X / Y samples.`` after each (underscore-separated counts,
    like the reference's separate_with_underscores)."""
    try:
        nq = int(query_mat.shape[0])
    except AttributeError:
        nq = len(query_mat)
    if not verbose or nq < 100_000:
        return index.query(query_mat, *args, **kw)
    qa = np.asarray(query_mat)
    ids, dists = [], []
    for i0 in range(0, nq, 100_000):
        i, d = index.query(qa[i0 : i0 + 100_000], *args, **kw)
        ids.append(i)
        dists.append(d)
        print(f"  Processed {min(i0 + 100_000, nq):_} / {nq:_} samples.")
    return np.concatenate(ids), np.concatenate(dists)


# ----------------------------------------------------------------------------
# Exhaustive (reference lib.rs:211-271)
# ----------------------------------------------------------------------------


def build_exhaustive_index(mat: Any, dist_metric: str = "euclidean") -> ExhaustiveIndex:
    return ExhaustiveIndex(mat, dist_metric)


def query_exhaustive_index(
    query_mat: Any,
    index: ExhaustiveIndex,
    k: int,
    return_dist: bool = False,
    verbose: bool = False,
):
    idx, dist = _query(index, query_mat, verbose, k)
    return _maybe_dist(idx, dist, return_dist)


def query_exhaustive_self(
    index: ExhaustiveIndex,
    k: int,
    return_dist: bool = False,
    verbose: bool = False,
):
    idx, dist = index.generate_knn(k)
    return _maybe_dist(idx, dist, return_dist)


# ----------------------------------------------------------------------------
# IVF (reference lib.rs:658-766)
# ----------------------------------------------------------------------------


def build_ivf_index(
    mat: Any,
    nlist: int | None = None,
    max_iters: int | None = None,
    dist_metric: str = "euclidean",
    seed: int = 42,
    verbose: bool = False,
) -> IvfIndex:
    return IvfIndex(
        mat,
        dist_metric,
        nlist=nlist,
        max_iters=30 if max_iters is None else max_iters,
        seed=seed,
        verbose=verbose,
    )


def query_ivf_index(
    query_mat: Any,
    index: IvfIndex,
    k: int,
    nprobe: int | None = None,
    return_dist: bool = False,
    verbose: bool = False,
    certify: bool = False,
):
    """``certify=True`` runs the exact tier's triangle-inequality probe
    certificate (provably exact top-k; ``nprobe`` becomes the starting
    probe count) — see :meth:`IvfBase.query`."""
    idx, dist = _query(
        index, query_mat, verbose, k, nprobe=nprobe, certify=certify
    )
    return _maybe_dist(idx, dist, return_dist)


def query_ivf_self(
    index: IvfIndex,
    k: int,
    nprobe: int | None = None,
    return_dist: bool = False,
    verbose: bool = False,
):
    idx, dist = index.generate_knn(k, nprobe=nprobe)
    return _maybe_dist(idx, dist, return_dist)


# ----------------------------------------------------------------------------
# Quantised flat indexes (reference lib.rs:1191-1565)
# ----------------------------------------------------------------------------


def build_exhaustive_bf16_index(mat: Any, dist_metric: str = "euclidean") -> ExhaustiveIndexBf16:
    return ExhaustiveIndexBf16(mat, dist_metric)


def query_exhaustive_bf16_index(query_mat, index, k, return_dist=False, verbose=False):
    return _maybe_dist(*_query(index, query_mat, verbose, k), return_dist)


def query_exhaustive_bf16_self(index, k, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k), return_dist)


def build_exhaustive_sq8_index(mat: Any, dist_metric: str = "euclidean") -> ExhaustiveSq8Index:
    return ExhaustiveSq8Index(mat, dist_metric)


def query_exhaustive_sq8_index(query_mat, index, k, return_dist=False, verbose=False):
    return _maybe_dist(*_query(index, query_mat, verbose, k), return_dist)


def query_exhaustive_sq8_self(index, k, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k), return_dist)


def build_exhaustive_pq_index(
    mat: Any, m: int = 16, dist_metric: str = "euclidean", seed: int = 42,
    verbose: bool = False,
) -> ExhaustivePqIndex:
    return ExhaustivePqIndex(mat, m=m, metric=dist_metric, seed=seed)


def query_exhaustive_pq_index(query_mat, index, k, return_dist=False, verbose=False):
    return _maybe_dist(*_query(index, query_mat, verbose, k), return_dist)


def query_exhaustive_pq_index_self(index, k, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k), return_dist)


def build_exhaustive_opq_index(
    mat: Any, m: int = 16, dist_metric: str = "euclidean", seed: int = 42,
    verbose: bool = False,
) -> ExhaustiveOpqIndex:
    return ExhaustiveOpqIndex(mat, m=m, metric=dist_metric, seed=seed)


def query_exhaustive_opq_index(query_mat, index, k, return_dist=False, verbose=False):
    return _maybe_dist(*_query(index, query_mat, verbose, k), return_dist)


def query_exhaustive_opq_index_self(index, k, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k), return_dist)


# ----------------------------------------------------------------------------
# Quantised IVF indexes (reference lib.rs:1567-1996)
# ----------------------------------------------------------------------------


def build_ivf_bf16_index(
    mat: Any, nlist=None, max_iters=None, dist_metric="euclidean", seed=42,
    verbose=False,
) -> IvfIndexBf16:
    return IvfIndexBf16(
        mat, dist_metric, nlist=nlist,
        max_iters=30 if max_iters is None else max_iters, seed=seed,
        verbose=verbose,
    )


def query_ivf_bf16_index(query_mat, index, k, nprobe=None, return_dist=False, verbose=False):
    return _maybe_dist(*_query(index, query_mat, verbose, k, nprobe=nprobe), return_dist)


def query_ivf_bf16_self(index, k, nprobe=None, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k, nprobe=nprobe), return_dist)


def build_ivf_sq8_index(
    mat: Any, nlist=None, max_iters=None, dist_metric="euclidean", seed=42,
    verbose=False,
) -> IvfSq8Index:
    return IvfSq8Index(
        mat, dist_metric, nlist=nlist,
        max_iters=30 if max_iters is None else max_iters, seed=seed,
        verbose=verbose,
    )


def query_ivf_sq8_index(query_mat, index, k, nprobe=None, return_dist=False, verbose=False):
    return _maybe_dist(*_query(index, query_mat, verbose, k, nprobe=nprobe), return_dist)


def query_ivf_sq8_self(index, k, nprobe=None, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k, nprobe=nprobe), return_dist)


def build_ivf_pq_index(
    mat: Any, nlist=None, m: int = 16, max_iters=None, dist_metric="euclidean",
    seed=42, verbose=False,
) -> IvfPqIndex:
    return IvfPqIndex(
        mat, dist_metric, nlist=nlist, m=m,
        max_iters=30 if max_iters is None else max_iters, seed=seed,
        verbose=verbose,
    )


def query_ivf_pq_index(query_mat, index, k, nprobe=None, return_dist=False, verbose=False):
    return _maybe_dist(*_query(index, query_mat, verbose, k, nprobe=nprobe), return_dist)


def query_ivf_pq_index_self(index, k, nprobe=None, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k, nprobe=nprobe), return_dist)


def build_ivf_opq_index(
    mat: Any, nlist=None, m: int = 16, max_iters=None, dist_metric="euclidean",
    seed=42, verbose=False,
) -> IvfOpqIndex:
    return IvfOpqIndex(
        mat, dist_metric, nlist=nlist, m=m,
        max_iters=30 if max_iters is None else max_iters, seed=seed,
        verbose=verbose,
    )


def query_ivf_opq_index(query_mat, index, k, nprobe=None, return_dist=False, verbose=False):
    return _maybe_dist(*_query(index, query_mat, verbose, k, nprobe=nprobe), return_dist)


def query_ivf_opq_index_self(index, k, nprobe=None, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k, nprobe=nprobe), return_dist)


# ----------------------------------------------------------------------------
# Binary indexes (reference lib.rs:2402-2689)
# ----------------------------------------------------------------------------


def build_exhaustive_index_binary(
    mat: Any, dist_metric: str = "euclidean", n_bits=None,
    binarisation: str = "simhash", seed: int = 42, store=True,
    verbose: bool = False,
):
    from .models.binary import ExhaustiveIndexBinary

    return ExhaustiveIndexBinary(
        mat, dist_metric, n_bits=n_bits, binarisation=binarisation,
        seed=seed, store=store,
    )


def query_exhaustive_index_binary(
    query_mat, index, k, rerank=None, rerank_factor=20,
    return_dist=False, verbose=False,
):
    return _maybe_dist(
        *_query(index, query_mat, verbose, k, rerank=rerank, rerank_factor=rerank_factor),
        return_dist,
    )


def query_exhaustive_index_binary_self(
    index, k, rerank=None, rerank_factor=20, return_dist=False, verbose=False
):
    return _maybe_dist(
        *index.generate_knn(k, rerank=rerank, rerank_factor=rerank_factor),
        return_dist,
    )


def build_ivf_index_binary(
    mat: Any, dist_metric: str = "euclidean", nlist=None, n_bits=None,
    binarisation: str = "simhash", max_iters=None, seed: int = 42,
    store=True, verbose: bool = False,
):
    from .models.binary import IvfIndexBinary

    return IvfIndexBinary(
        mat, dist_metric, nlist=nlist, n_bits=n_bits,
        binarisation=binarisation,
        max_iters=30 if max_iters is None else max_iters, seed=seed,
        store=store, verbose=verbose,
    )


def query_ivf_index_binary(
    query_mat, index, k, nprobe=None, rerank=None, rerank_factor=20,
    return_dist=False, verbose=False,
):
    return _maybe_dist(
        *_query(
            index, query_mat, verbose, k, nprobe=nprobe, rerank=rerank,
            rerank_factor=rerank_factor,
        ),
        return_dist,
    )


def query_ivf_index_binary_self(
    index, k, nprobe=None, rerank=None, rerank_factor=20,
    return_dist=False, verbose=False,
):
    return _maybe_dist(
        *index.generate_knn(
            k, nprobe=nprobe, rerank=rerank, rerank_factor=rerank_factor
        ),
        return_dist,
    )


# ----------------------------------------------------------------------------
# RaBitQ indexes (reference lib.rs:2691-2930)
# ----------------------------------------------------------------------------


def build_exhaustive_index_rabitq(
    mat: Any, dist_metric: str = "euclidean", nlist=None, max_iters=None,
    seed: int = 42, store=True, verbose: bool = False,
):
    from .models.binary.rabitq import ExhaustiveIndexRaBitQ

    return ExhaustiveIndexRaBitQ(
        mat, dist_metric, nlist=nlist,
        max_iters=30 if max_iters is None else max_iters, seed=seed,
        store=store, verbose=verbose,
    )


def query_exhaustive_index_rabitq(
    query_mat, index, k, nprobe=None, rerank=None, rerank_factor=10,
    return_dist=False, verbose=False,
):
    return _maybe_dist(
        *_query(index, query_mat, verbose, k, nprobe=nprobe, rerank=rerank,
                     rerank_factor=rerank_factor),
        return_dist,
    )


def query_exhaustive_index_rabitq_self(
    index, k, nprobe=None, rerank=None, rerank_factor=10,
    return_dist=False, verbose=False,
):
    return _maybe_dist(
        *index.generate_knn(k, nprobe=nprobe, rerank=rerank,
                            rerank_factor=rerank_factor),
        return_dist,
    )


def build_ivf_index_rabitq(
    mat: Any, dist_metric: str = "euclidean", nlist=None, max_iters=None,
    seed: int = 42, store=True, verbose: bool = False,
):
    from .models.binary.rabitq import IvfIndexRaBitQ

    return IvfIndexRaBitQ(
        mat, dist_metric, nlist=nlist,
        max_iters=30 if max_iters is None else max_iters, seed=seed,
        store=store, verbose=verbose,
    )


def query_ivf_index_rabitq(
    query_mat, index, k, nprobe=None, rerank=None, rerank_factor=10,
    return_dist=False, verbose=False,
):
    return _maybe_dist(
        *_query(index, query_mat, verbose, k, nprobe=nprobe, rerank=rerank,
                     rerank_factor=rerank_factor),
        return_dist,
    )


def query_ivf_index_rabitq_self(
    index, k, nprobe=None, rerank=None, rerank_factor=10,
    return_dist=False, verbose=False,
):
    return _maybe_dist(
        *index.generate_knn(k, nprobe=nprobe, rerank=rerank,
                            rerank_factor=rerank_factor),
        return_dist,
    )


# ----------------------------------------------------------------------------
# Graph indexes (reference lib.rs:969-1093 CPU NNDescent; :2199-2400 GPU
# NNDescent/CAGRA). Here there is one accelerated engine, so the *_gpu
# names are aliases of the native implementation.
# ----------------------------------------------------------------------------


def build_nndescent_index(
    mat: Any, dist_metric: str = "euclidean", k: int = 30, n_trees=None,
    max_iters=None, delta: float = 0.001, seed: int = 42,
    verbose: bool = False, **kw,
):
    from .models.graph import NNDescentIndex

    return NNDescentIndex(
        mat, dist_metric, k=k,
        n_trees=4 if n_trees is None else n_trees,
        max_rounds=10 if max_iters is None else max_iters,
        delta=delta, seed=seed, verbose=verbose, **kw,
    )


def query_nndescent_index(
    query_mat, index, k, beam=None, iters=None, return_dist=False,
    verbose=False,
):
    return _maybe_dist(
        *_query(index, query_mat, verbose, k, beam=beam, iters=iters), return_dist
    )


def query_nndescent_self(index, k, return_dist=False, verbose=False, mode="graph"):
    return _maybe_dist(*index.generate_knn(k, mode=mode), return_dist)


# accelerated-path aliases (reference *_gpu surface)
build_nndescent_index_gpu = build_nndescent_index
query_nndescent_index_gpu = query_nndescent_index
query_nndescent_index_gpu_self = query_nndescent_self


def extract_nndescent_knn_gpu(index, k, return_dist=False, verbose=False):
    """Extract the built kNN graph (reference lib.rs:2325)."""
    return _maybe_dist(*index.generate_knn(k, mode="graph"), return_dist)


def build_exhaustive_index_gpu(mat: Any, dist_metric: str = "euclidean"):
    return build_exhaustive_index(mat, dist_metric)


def query_exhaustive_index_gpu(
    query_mat, index, k, return_dist=False, verbose=False,
):
    """The reference's GPU tiled scan (dist_gpu.rs:550-685) → the
    running-bins tile selector (selection-free scan; recall 1.0 measured)."""
    idx, dist = _query(index, query_mat, verbose, k, selector="bins")
    return _maybe_dist(idx, dist, return_dist)


def query_exhaustive_index_gpu_self(index, k, return_dist=False, verbose=False):
    idx, dist = index.generate_knn(k, selector="bins")
    return _maybe_dist(idx, dist, return_dist)


def build_ivf_index_gpu(
    mat: Any, nlist=None, max_iters=None, dist_metric="euclidean",
    seed=42, verbose=False,
):
    return build_ivf_index(mat, nlist, max_iters, dist_metric, seed, verbose)


def query_ivf_index_gpu(
    query_mat, index, k, nprobe=None, return_dist=False, verbose=False,
):
    """The reference's IVF GPU mega-kernel (ivf_gpu.rs:600-654) → the
    single-dispatch fused Pallas scan (route → device task lists → fused
    cell scan; falls back to the exact XLA scan where ineligible)."""
    idx, dist = _query(index, query_mat, verbose, k, nprobe=nprobe, approx=True)
    return _maybe_dist(idx, dist, return_dist)


def query_ivf_index_gpu_self(
    index, k, nprobe=None, return_dist=False, verbose=False,
):
    q = index.vectors_original_order()
    idx, dist = _query(index, q, verbose, k, nprobe=nprobe, approx=True)
    return _maybe_dist(idx, dist, return_dist)


# ----------------------------------------------------------------------------
# HNSW (reference lib.rs:553-657) / Vamana (lib.rs:1094-1190)
# ----------------------------------------------------------------------------


def build_hnsw_index(
    mat: Any, dist_metric: str = "euclidean", m: int = 16,
    ef_construction: int = 100, seed: int = 42, verbose: bool = False,
):
    from .models.hnsw import HnswIndex

    return HnswIndex(
        mat, dist_metric, m=m, ef_construction=ef_construction, seed=seed,
        verbose=verbose,
    )


def query_hnsw_index(
    query_mat, index, k, ef_search=None, return_dist=False, verbose=False
):
    return _maybe_dist(
        *_query(index, query_mat, verbose, k, ef_search=ef_search), return_dist
    )


def query_hnsw_self(index, k, ef_search=None, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k, ef_search=ef_search), return_dist)


def build_vamana_index(
    mat: Any, dist_metric: str = "euclidean", r_degree: int = 32,
    alpha: float = 1.2, seed: int = 42, verbose: bool = False,
):
    from .models.vamana import VamanaIndex

    return VamanaIndex(
        mat, dist_metric, r_degree=r_degree, alpha=alpha, seed=seed,
        verbose=verbose,
    )


def query_vamana_index(
    query_mat, index, k, beam=None, return_dist=False, verbose=False
):
    return _maybe_dist(*_query(index, query_mat, verbose, k, beam=beam), return_dist)


def query_vamana_self(index, k, beam=None, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k, beam=beam), return_dist)


# ----------------------------------------------------------------------------
# kMkNN (lib.rs:291-375) / Annoy (:376-465) / BallTree (:466-552) /
# KdForest (:768-860) / LSH (:861-968)
# ----------------------------------------------------------------------------


def build_kmknn_index(
    mat: Any, dist_metric: str = "euclidean", nlist=None, max_iters=None,
    seed: int = 42, verbose: bool = False,
):
    from .models.kmknn import KmknnIndex

    return KmknnIndex(
        mat, dist_metric, nlist=nlist,
        max_iters=30 if max_iters is None else max_iters, seed=seed,
        verbose=verbose,
    )


def query_kmknn_index(query_mat, index, k, return_dist=False, verbose=False):
    return _maybe_dist(*_query(index, query_mat, verbose, k), return_dist)


def query_kmknn_self(index, k, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k), return_dist)


def build_annoy_index(
    mat: Any, dist_metric: str = "euclidean", n_trees: int = 16,
    leaf: int = 64, seed: int = 42, verbose: bool = False,
):
    from .models.trees import AnnoyIndex

    return AnnoyIndex(mat, dist_metric, n_trees=n_trees, leaf=leaf, seed=seed)


def query_annoy_index(
    query_mat, index, k, n_probes: int = 2, search_k=None,
    return_dist=False, verbose=False,
):
    return _maybe_dist(*_query(index, query_mat, verbose, k, n_probes=n_probes), return_dist)


def query_annoy_self(
    index, k, n_probes: int = 2, search_k=None, return_dist=False,
    verbose=False,
):
    return _maybe_dist(*index.generate_knn(k, n_probes=n_probes), return_dist)


def build_balltree_index(
    mat: Any, dist_metric: str = "euclidean", seed: int = 42,
    verbose: bool = False,
):
    from .models.trees import BallTreeIndex

    return BallTreeIndex(mat, dist_metric, seed=seed)


def query_balltree_index(
    query_mat, index, k, budget=None, return_dist=False, verbose=False
):
    return _maybe_dist(*_query(index, query_mat, verbose, k, budget=budget), return_dist)


def query_balltree_self(index, k, budget=None, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k, budget=budget), return_dist)


def build_kd_tree_index(
    mat: Any, dist_metric: str = "euclidean", n_trees: int = 16,
    leaf: int = 64, seed: int = 42, verbose: bool = False,
):
    from .models.trees import KdTreeIndex

    return KdTreeIndex(mat, dist_metric, n_trees=n_trees, leaf=leaf, seed=seed)


def query_kd_tree_index(
    query_mat, index, k, n_probes: int = 2, search_k=None,
    return_dist=False, verbose=False,
):
    return _maybe_dist(*_query(index, query_mat, verbose, k, n_probes=n_probes), return_dist)


def query_kd_tree_self(
    index, k, n_probes: int = 2, search_k=None, return_dist=False,
    verbose=False,
):
    return _maybe_dist(*index.generate_knn(k, n_probes=n_probes), return_dist)


def build_lsh_index(
    mat: Any, dist_metric: str = "euclidean", num_tables: int = 8,
    bits_per_hash: int = 16, seed: int = 42, verbose: bool = False,
):
    from .models.lsh import LSHIndex

    return LSHIndex(
        mat, dist_metric, num_tables=num_tables, bits_per_hash=bits_per_hash,
        seed=seed,
    )


def query_lsh_index(
    query_mat, index, k, n_probes: int = 4, return_dist=False, verbose=False
):
    return _maybe_dist(*_query(index, query_mat, verbose, k, n_probes=n_probes), return_dist)


def query_lsh_self(index, k, n_probes: int = 4, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k, n_probes=n_probes), return_dist)
