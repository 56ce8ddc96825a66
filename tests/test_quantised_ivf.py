"""IVF quantised index tests: recall vs exact ground truth through the
cluster-major scan engine (reference: ivf_bf16/sq8/pq/opq tests)."""

import numpy as np
import pytest

import annsearch_tpu as ann
from annsearch_tpu.models.exhaustive import ExhaustiveIndex
from annsearch_tpu.models.quantised import (
    IvfIndexBf16,
    IvfOpqIndex,
    IvfPqIndex,
    IvfSq8Index,
)
from annsearch_tpu.utils.data import generate_clustered_data, subsample_with_noise
from annsearch_tpu.utils.metrics import calculate_recall


@pytest.fixture(scope="module")
def data():
    x, _ = generate_clustered_data(4000, 32, 10, seed=0)
    q = subsample_with_noise(x, 200, seed=0)
    exact = ExhaustiveIndex(x, "euclidean")
    ti, td = exact.query(q, 10)
    return x, q, ti, td


def test_ivf_bf16_recall(data):
    x, q, ti, _ = data
    index = IvfIndexBf16(x, "euclidean", nlist=32, seed=0)
    ai, ad = index.query(q, 10, nprobe=16)
    assert calculate_recall(ti, ai, 10) > 0.93
    assert (np.diff(ad, axis=1) >= -1e-5).all()


def test_ivf_bf16_full_probe_near_exact(data):
    x, q, ti, td = data
    index = IvfIndexBf16(x, "euclidean", nlist=16, seed=0)
    ai, ad = index.query(q, 10, nprobe=16)
    assert calculate_recall(ti, ai, 10) > 0.95
    # bf16 products on ‖x‖²≈2e3 magnitudes carry ~1% absolute distance fuzz
    assert np.median(np.abs(ad - td) / np.maximum(td, 1.0)) < 0.05


def test_ivf_sq8_recall(data):
    x, q, ti, _ = data
    index = IvfSq8Index(x, "euclidean", nlist=32, seed=0)
    ai, _ = index.query(q, 10, nprobe=32)
    # bounded by flat-SQ8 integer-space ceiling (~0.82 on this suite)
    assert calculate_recall(ti, ai, 10) > 0.7


def test_ivf_sq8_cosine(data):
    x, q, _, _ = data
    exact = ExhaustiveIndex(x, "cosine")
    ti, _ = exact.query(q, 10)
    index = IvfSq8Index(x, "cosine", nlist=16, seed=0)
    ai, _ = index.query(q, 10, nprobe=16)
    assert calculate_recall(ti, ai, 10) > 0.6


def test_ivf_pq_recall(data):
    x, q, ti, _ = data
    index = IvfPqIndex(x, "euclidean", nlist=32, m=8, seed=0)
    ai, _ = index.query(q, 10, nprobe=32)
    # m=8 on this suite has a verified quantisation ceiling of 0.68
    # (exact scoring on reconstructions gives the same number)
    assert calculate_recall(ti, ai, 10) > 0.6


def test_ivf_pq_self_query(data):
    x, _, _, _ = data
    index = IvfPqIndex(x[:1000], "euclidean", nlist=16, m=8, seed=0)
    idx, dist = index.generate_knn(3, nprobe=8)
    assert (idx[:, 0] == np.arange(1000)).mean() > 0.85


def test_ivf_opq_recall(data):
    x, q, ti, _ = data
    index = IvfOpqIndex(x, "euclidean", nlist=32, m=8, seed=0)
    ai, _ = index.query(q, 10, nprobe=32)
    assert calculate_recall(ti, ai, 10) > 0.6


def test_ivf_pq_cosine(data):
    x, q, _, _ = data
    exact = ExhaustiveIndex(x, "cosine")
    ti, _ = exact.query(q, 10)
    index = IvfPqIndex(x, "cosine", nlist=16, m=8, seed=0)
    ai, _ = index.query(q, 10, nprobe=16)
    assert calculate_recall(ti, ai, 10) > 0.6


def test_ivf_bf16_ids_valid_and_unique(data):
    x, q, _, _ = data
    index = IvfIndexBf16(x, "euclidean", nlist=32, seed=0)
    ai, _ = index.query(q[:20], 10, nprobe=4)
    assert (ai >= 0).all() and (ai < 4000).all()
    for row in ai:
        assert len(np.unique(row)) == 10


def test_ivf_pq_save_load(tmp_path, data):
    x, q, _, _ = data
    index = IvfPqIndex(x[:1000], "euclidean", nlist=16, m=8, seed=0)
    p = str(tmp_path / "ivfpq.npz")
    index.save(p)
    loaded = IvfPqIndex.load(p)
    i1, d1 = index.query(q[:10], 5, nprobe=8)
    i2, d2 = loaded.query(q[:10], 5, nprobe=8)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, atol=1e-5)


def test_facade_functions(data):
    x, q, ti, _ = data
    idx = ann.build_ivf_bf16_index(x[:1000], nlist=8, seed=0)
    knn, dist = ann.query_ivf_bf16_index(q[:10], idx, 5, nprobe=8, return_dist=True)
    assert knn.shape == (10, 5) and dist.shape == (10, 5)
    knn2, none = ann.query_ivf_bf16_self(idx, 3, nprobe=4)
    assert none is None and knn2.shape == (1000, 3)


def test_memory_compression(data):
    x, _, _, _ = data
    f32 = ann.build_ivf_index(x, nlist=32, seed=0)
    pq = IvfPqIndex(x, "euclidean", nlist=32, m=8, seed=0)
    # PQ codes are m bytes/vector vs 4·dim — storage should be far smaller
    assert pq.memory_usage_bytes() < f32.memory_usage_bytes()


def test_ivf_pq_qsplit_single_pass(fused_kernel):
    """q_split=False (bf16 query scoring on the approx fused tier) must
    match the f32-query path's recall where the ceiling is quantisation.

    The knob only acts inside the FUSED kernel on i8dec modes — a 128-d
    fixture (m=dim → i8dec) with the kernel forced on (the fused_kernel
    fixture; interpreted on the CPU mesh); asserted via fused_eligible,
    not assumed."""
    from annsearch_tpu.ops.ivf_scan_pallas import fused_eligible

    x, _ = generate_clustered_data(1500, 128, 8, seed=0)
    q = subsample_with_noise(x, 40, seed=0)
    ti, _ = ExhaustiveIndex(x, "euclidean").query(q, 10)
    index = IvfPqIndex(x, "euclidean", nlist=8, m=128, seed=0)
    assert index.mode in ("i8dec", "i8dec_residual")
    assert fused_eligible(
        index.mode, index.seg_size, int(index.storage.shape[1]), 10
    ), "fixture must route to the fused kernel or the parity check is vacuous"
    ai_split, _ = index.query(q, 10, nprobe=4, approx=True, q_split=True)
    ai_one, ad_one = index.query(q, 10, nprobe=4, approx=True, q_split=False)
    ai_auto, _ = index.query(q, 10, nprobe=4, approx=True)  # default → False
    r_split = calculate_recall(ti, ai_split, 10)
    r_one = calculate_recall(ti, ai_one, 10)
    assert r_one > r_split - 0.03
    np.testing.assert_array_equal(ai_auto, ai_one)
    assert (np.diff(ad_one, axis=1) >= -1e-5).all()
