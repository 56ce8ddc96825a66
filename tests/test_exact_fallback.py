"""Small-regime exact query fallback (models/base.BRUTE_QUERY_FLOP_BUDGET).

Below the FLOP budget, indexes that keep full-precision rows answer
queries with one exact tensor-core scan — same economics inversion as the
build-side brute path (VERDICT r1 endorsed it for builds). These tests
run with the conftest's ANNSEARCH_NO_EXACT_FALLBACK temporarily lifted.
"""

import os

import numpy as np
import pytest

import annsearch_tpu as ann
from annsearch_tpu.utils.data import generate_clustered_data, subsample_with_noise
from annsearch_tpu.utils.metrics import calculate_recall


@pytest.fixture()
def fallback_enabled(monkeypatch):
    monkeypatch.delenv("ANNSEARCH_NO_EXACT_FALLBACK", raising=False)


@pytest.fixture(scope="module")
def data():
    x, _ = generate_clustered_data(3000, 16, 6, seed=3)
    q = subsample_with_noise(x, 64, seed=3)
    exact = ann.build_exhaustive_index(x)
    ti, td = exact.query(q, 10)
    return x, q, np.asarray(ti), np.asarray(td)


BUILDERS = [
    ("nndescent", lambda x: ann.build_nndescent_index(x, k=10, seed=1)),
    ("hnsw", lambda x: ann.build_hnsw_index(x, seed=1)),
    ("vamana", lambda x: ann.build_vamana_index(x, seed=1)),
    ("kmknn", lambda x: ann.build_kmknn_index(x, seed=1)),
    ("lsh", lambda x: ann.build_lsh_index(x, num_tables=2, bits_per_hash=6, seed=1)),
    ("annoy", lambda x: ann.build_annoy_index(x, n_trees=2, seed=1)),
    ("balltree", lambda x: ann.build_balltree_index(x, seed=1)),
]


@pytest.mark.parametrize("name,build", BUILDERS)
def test_fallback_is_exact(data, fallback_enabled, name, build):
    x, q, ti, td = data
    idx = build(x)
    ai, ad = idx.query(q, 10)
    assert calculate_recall(ti, np.asarray(ai), 10) >= 0.999, name
    np.testing.assert_allclose(np.asarray(ad), td, rtol=1e-3, atol=1e-3)


def test_fallback_optout_uses_native_path(data, fallback_enabled):
    x, q, ti, _ = data
    idx = ann.build_lsh_index(x, num_tables=1, bits_per_hash=8, seed=1)
    exact_i, _ = idx.query(q, 10)
    native_i, _ = idx.query(q, 10, exact_fallback=False)
    r_exact = calculate_recall(ti, np.asarray(exact_i), 10)
    r_native = calculate_recall(ti, np.asarray(native_i), 10)
    assert r_exact >= 0.999
    # a 1-table 8-bit LSH cannot be exact on clustered data — proves the
    # native path actually ran
    assert r_native < r_exact


def test_fallback_respects_budget(data, fallback_enabled, monkeypatch):
    import annsearch_tpu.models.base as base

    x, q, ti, _ = data
    monkeypatch.setattr(base, "BRUTE_QUERY_FLOP_BUDGET", 1)
    idx = ann.build_lsh_index(x, num_tables=1, bits_per_hash=8, seed=1)
    i_small, _ = idx.query(q, 10)
    assert calculate_recall(ti, np.asarray(i_small), 10) < 0.999
