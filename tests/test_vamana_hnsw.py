"""Vamana + HNSW tests (reference: vamana.rs / hnsw.rs tests — recall vs
exact, medoid entry, layer structure, ef/beam sweeps)."""

import numpy as np
import pytest

from annsearch_tpu.models.exhaustive import ExhaustiveIndex
from annsearch_tpu.models.hnsw import HnswIndex
from annsearch_tpu.models.vamana import VamanaIndex
from annsearch_tpu.utils.data import generate_clustered_data, subsample_with_noise
from annsearch_tpu.utils.metrics import calculate_recall


@pytest.fixture(scope="module")
def vdata():
    x, _ = generate_clustered_data(3000, 32, 8, seed=0)
    q = subsample_with_noise(x, 150, seed=0)
    exact = ExhaustiveIndex(x, "euclidean")
    ti, _ = exact.query(q, 10)
    return x, q, ti


def test_vamana_recall(vdata):
    x, q, ti = vdata
    index = VamanaIndex(x, r_degree=32, seed=0)
    ai, ad = index.query(q, 10)
    rec = calculate_recall(ti, ai, 10)
    assert rec > 0.85, rec
    assert (np.diff(np.where(np.isfinite(ad), ad, 1e30), axis=1) >= -1e-4).all()


def test_vamana_recall_high_degree(vdata):
    # r_degree=48 → first-pass graph is 72 wide (R + R/2 reverse), which
    # crosses the trail-pass degree cap (models/vamana._second_pass_pool
    # trail_cap=48: closest 24 + strided far ranks) — the capped walk
    # graph must still produce a high-recall final graph
    x, q, ti = vdata
    index = VamanaIndex(x, r_degree=48, seed=0)
    ai, _ = index.query(q, 10)
    rec = calculate_recall(ti, ai, 10)
    assert rec > 0.9, rec


def test_vamana_medoid(vdata):
    x, _, _ = vdata
    index = VamanaIndex(x, seed=0)
    mean = x.mean(0)
    d = ((x - mean) ** 2).sum(1)
    assert index.medoid == int(np.argmin(d))


def test_vamana_self_query(vdata):
    x, _, _ = vdata
    index = VamanaIndex(x[:500], r_degree=24, seed=0)
    ai, ad = index.query(x[:500], 3)
    assert (ai[:, 0] == np.arange(500)).mean() > 0.9


def test_hnsw_recall(vdata):
    x, q, ti = vdata
    index = HnswIndex(x, m=16, ef_construction=100, seed=0)
    ai, _ = index.query(q, 10, ef_search=100)
    rec = calculate_recall(ti, ai, 10)
    assert rec > 0.85, rec


def test_hnsw_layers_shrink(vdata):
    x, _, _ = vdata
    index = HnswIndex(x, m=16, seed=0)
    sizes = [len(np.asarray(g[0])) for g in index.layers]
    assert all(sizes[i] > sizes[i + 1] for i in range(len(sizes) - 1))
    # geometric decay ~1/16 per level
    if sizes:
        assert sizes[0] < 3000 / 4


def test_hnsw_ef_sweep(vdata):
    x, q, ti = vdata
    index = HnswIndex(x, m=16, seed=0)
    lo, _ = index.query(q, 10, ef_search=20)
    hi, _ = index.query(q, 10, ef_search=150)
    assert calculate_recall(ti, hi, 10) >= calculate_recall(ti, lo, 10) - 0.02


def test_hnsw_save_load(tmp_path, vdata):
    x, q, _ = vdata
    index = HnswIndex(x[:500], m=8, seed=0)
    p = str(tmp_path / "hnsw.npz")
    index.save(p)
    loaded = HnswIndex.load(p)
    i1, _ = index.query(q[:10], 5)
    i2, _ = loaded.query(q[:10], 5)
    np.testing.assert_array_equal(i1, i2)


def test_hnsw_cosine(vdata):
    x, q, _ = vdata
    exact = ExhaustiveIndex(x, "cosine")
    ti, _ = exact.query(q, 10)
    index = HnswIndex(x, m=16, dist_metric_unused=None, seed=0) if False else HnswIndex(x, "cosine", m=16, seed=0)
    ai, _ = index.query(q, 10, ef_search=100)
    assert calculate_recall(ti, ai, 10) > 0.8


def test_vamana_degree_bound(vdata):
    """Robust prune + reverse edges must bound node degree (vamana.rs
    degree invariant: R out-edges + R/2 reverse slots)."""
    x, _, _ = vdata
    idx = VamanaIndex(x, r_degree=16, seed=0)
    adj = np.asarray(idx.graph)[: len(x)]  # last row is the pad sentinel
    assert adj.shape[1] <= 16 + 8
    real = (adj >= 0) & (adj < len(x))
    assert real.any(axis=1).all()  # no isolated node
    rows = np.arange(len(x))[:, None]
    assert not ((adj == rows) & real).any()  # no self-loops


def test_hnsw_base_layer_degree_bound(vdata):
    """HNSW base layer degree <= 2M, upper layers <= M (hnsw.rs), layer
    member counts shrink geometrically."""
    x, _, _ = vdata
    idx = HnswIndex(x, m=8, seed=0)
    _, base_graph, _, _ = idx.layers[0]
    assert np.asarray(base_graph).shape[1] <= 16  # 2M
    for gids, graph, _, _ in idx.layers[1:]:
        assert np.asarray(graph).shape[1] <= 16
    sizes = [len(np.asarray(l[0])) for l in idx.layers]
    assert all(a >= b for a, b in zip(sizes, sizes[1:]))


def test_nnd_vs_brute_agreement():
    """Above the brute budget the NND path must still converge; below it
    the exact tensor-core path runs — both give high-recall graphs."""
    import os

    from annsearch_tpu.models.graph import NNDescentIndex
    from annsearch_tpu.models.exhaustive import ExhaustiveIndex
    from annsearch_tpu.utils.data import generate_clustered_data
    from annsearch_tpu.utils.metrics import calculate_recall

    x, _ = generate_clustered_data(3000, 16, 6, seed=23)
    ti, _ = ExhaustiveIndex(x).query(x, 11)
    idx = NNDescentIndex(x, k=10, seed=0)
    gi, gd = idx.generate_knn(10)
    # graph-mode self-kNN excludes self; compare against GT minus self col
    rec = calculate_recall(ti[:, 1:], gi, 10)
    assert rec > 0.9, rec
