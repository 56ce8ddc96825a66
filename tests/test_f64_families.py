"""f64 generics parity for the raw-row families (VERDICT r4 next-round #8).

The reference's distance kernels and every index are generic over f32/f64
(dist.rs:113-2263). The tensor-core has no f64 path, so f64 grade comes from a
widened device pre-selection + a host f64 rescore of the pool
(``models/base.rescore_f64_pool``, shared via ``BaseIndex._f64_roundtrip``).
These tests build each raw-row family from f64 data containing sub-f32-grain
pairs (rows that only f64 arithmetic can order) and require f64-exact
ids AND distances from ``.query()``.
"""

import numpy as np
import pytest

from annsearch_tpu.models.graph import NNDescentIndex
from annsearch_tpu.models.hnsw import HnswIndex
from annsearch_tpu.models.lsh import LSHIndex
from annsearch_tpu.models.trees import AnnoyIndex, BallTreeIndex, KdTreeIndex
from annsearch_tpu.models.vamana import VamanaIndex


def _subgrain_data(seed=7, n_base=300, d=12):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n_base, d))
    # each base row gets a twin offset ~1e-8 — squared-distance gaps ~1e-16,
    # far below f32 resolution of the O(1) distances
    x = np.concatenate([base, base + 1e-8 * rng.standard_normal((n_base, d))])
    q = base[:40] + 1e-9
    return x, q


def _f64_gt(x, q, k):
    diff = q[:, None, :] - x[None]
    dm = np.einsum("qnd,qnd->qn", diff, diff)
    gt = np.argsort(dm, axis=1)[:, :k]
    return gt, np.take_along_axis(dm, gt, axis=1)


FAMILIES = [
    ("annoy", lambda x: AnnoyIndex(x, "euclidean", n_trees=4, seed=0), {}),
    ("kdtree", lambda x: KdTreeIndex(x, "euclidean", n_trees=4, seed=0), {}),
    ("balltree", lambda x: BallTreeIndex(x, "euclidean", seed=0), {}),
    ("lsh", lambda x: LSHIndex(x, "euclidean", num_tables=4, bits_per_hash=6, seed=0),
     {}),
    ("nndescent", lambda x: NNDescentIndex(x, "euclidean", k=10, seed=0), {}),
    ("hnsw", lambda x: HnswIndex(x, "euclidean", m=8, seed=0), {}),
    ("vamana", lambda x: VamanaIndex(x, "euclidean", r_degree=16, seed=0), {}),
]


@pytest.mark.parametrize("name,build,qkw", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_f64_query_exact(name, build, qkw, monkeypatch):
    # the conftest forces native query paths suite-wide; exactness of the
    # f64 rescore needs the exact-fallback pre-selection (the native paths
    # are covered by test_f64_native_path_rescores_pool)
    monkeypatch.delenv("ANNSEARCH_NO_EXACT_FALLBACK", raising=False)
    x, q = _subgrain_data()
    index = build(x)
    ids, d = index.query(q, 5, **qkw)
    assert d.dtype == np.float64
    gt, gd = _f64_gt(x, q, 5)
    # small regime → exact fallback pre-selection: the 2k pool holds the
    # true top-5, so the f64 rescore must reproduce the f64 ground truth
    np.testing.assert_allclose(d, gd, rtol=1e-12, atol=0)
    agree = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(ids, gt)])
    assert agree >= 0.99, (name, agree)


def test_f64_native_path_rescores_pool():
    """With the exact fallback disabled the pool comes from the native
    algorithm; returned distances must still be f64-exact FOR THE RETURNED
    IDS (the rescore guarantee), and sub-grain twins must rank in true f64
    order whenever both are in the pool."""
    x, q = _subgrain_data()
    index = AnnoyIndex(x, "euclidean", n_trees=8, seed=0)
    ids, d = index.query(q, 5, n_probes=4, exact_fallback=False)
    assert d.dtype == np.float64
    diff = q[:, None, :] - x[None]
    dm = np.einsum("qnd,qnd->qn", diff, diff)
    np.testing.assert_allclose(
        d, np.take_along_axis(dm, ids, axis=1), rtol=1e-12, atol=0
    )
    # ascending f64 order, no duplicate ids
    assert np.all(np.diff(d, axis=1) >= 0)
    for row in ids:
        assert len(set(row.tolist())) == len(row)


def test_f64_cosine_family(monkeypatch):
    monkeypatch.delenv("ANNSEARCH_NO_EXACT_FALLBACK", raising=False)
    x, q = _subgrain_data()
    index = BallTreeIndex(x, "cosine", seed=0)
    ids, d = index.query(q, 5)
    assert d.dtype == np.float64
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    dm = 1.0 - qn @ xn.T
    gt = np.argsort(dm, axis=1)[:, :5]
    np.testing.assert_allclose(
        d, np.take_along_axis(dm, gt, axis=1), rtol=0, atol=1e-12
    )
