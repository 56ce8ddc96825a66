"""The exact IVF tier (``approx=False``, the XLA exact cluster scan) against
a NumPy reference: brute force over exactly the rows of the probed cells.

Routing is recomputed in float64 from the index's own centroids, so the
reference scans the same cells; distances are computed in float64 (or in
exact integers for sq8's integer scoring space).
"""

import numpy as np
import pytest

from annsearch_tpu.models.exhaustive import ExhaustiveIndex
from annsearch_tpu.models.ivf import IvfIndex
from annsearch_tpu.models.quantised.ivf import IvfIndexBf16, IvfSq8Index
from annsearch_tpu.utils.data import (
    generate_clustered_data,
    subsample_with_noise,
)
from annsearch_tpu.utils.metrics import calculate_recall


def _probed_reference(idx, q_score, rows_score, nprobe, k, metric, q_route):
    """Top-k over the rows of each query's ``nprobe`` nearest cells.

    ``q_score``/``rows_score`` are in the index's scoring space
    (``rows_score`` in sorted-storage order); ``q_route`` in the routing
    space of ``idx.centroids``. Returns (original ids, float64 dists)."""
    cent = np.asarray(idx.centroids, np.float64)
    qr = np.asarray(q_route, np.float64)
    if metric == "cosine":
        rd = 1.0 - qr @ cent.T
    else:
        rd = ((qr[:, None, :] - cent[None]) ** 2).sum(-1)
    probes = np.argsort(rd, axis=1, kind="stable")[:, :nprobe]
    owner = np.asarray(idx._owner_clusters())
    oid = np.asarray(idx.original_ids)
    ids, dists = [], []
    for qi in range(q_score.shape[0]):
        rows = np.nonzero(np.isin(owner, probes[qi]))[0]
        v = rows_score[rows]
        if metric == "cosine":
            d = 1.0 - v @ q_score[qi]
        else:
            d = ((v - q_score[qi]) ** 2).sum(-1)
        o = np.argsort(d, kind="stable")[:k]
        ids.append(oid[rows[o]])
        dists.append(d[o])
    return np.stack(ids), np.stack(dists)


def _assert_matches(ids, d, ref_ids, ref_d, rtol, atol):
    """Distances equal the reference's in order; ids agree except where a
    near-tie at the k-th rank lets either of two rows qualify."""
    np.testing.assert_allclose(d, ref_d, rtol=rtol, atol=atol)
    agree = np.mean([len(set(a) & set(b)) / len(a) for a, b in zip(ids, ref_ids)])
    assert agree >= 0.99, agree


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_exact_tier_matches_numpy_split_cells(metric):
    """seg_size 128 splits cells (~250 rows each): the exact tier expands a
    cluster probe to all of its segments."""
    x, _ = generate_clustered_data(1500, 64, 6, seed=11)
    q = subsample_with_noise(x, 40, seed=12)
    idx = IvfIndex(x, metric, nlist=6, seg_size=128)
    assert idx._seg_s_max() > 1
    ids, d = idx.query(q, 10, nprobe=3, approx=False)
    qs = np.asarray(idx._prep_queries(q), np.float64)
    rows = np.asarray(idx.storage[: idx.n], np.float64)
    ref_ids, ref_d = _probed_reference(idx, qs, rows, 3, 10, metric, qs)
    _assert_matches(ids, d, ref_ids, ref_d, rtol=1e-4, atol=2e-3)


def test_exact_tier_sq8_matches_integer_reference():
    """sq8 scores in integer space: the exact tier's distances are the
    exact integer sums."""
    x, _ = generate_clustered_data(1200, 128, 5, seed=13)
    q = subsample_with_noise(x, 30, seed=14)
    idx = IvfSq8Index(x, "euclidean", nlist=5, seg_size=256)
    ids, d = idx.query(q, 10, nprobe=3, approx=False)
    qp = idx._prep_queries(q)
    qi = np.asarray(idx._encode_queries(qp), np.int64)
    rows = np.asarray(idx.storage[: idx.n], np.int64)
    ref_ids, ref_d = _probed_reference(
        idx, qi, rows, 3, 10, "euclidean", np.asarray(qp)
    )
    _assert_matches(ids, d, ref_ids, ref_d, rtol=0, atol=1e-3)


def test_exact_tier_full_probe_is_exhaustive():
    """Full probe must equal brute force exactly (recall 1.0)."""
    x, _ = generate_clustered_data(1200, 64, 5, seed=15)
    q = subsample_with_noise(x, 30, seed=16)
    idx = IvfIndex(x, "euclidean", nlist=5, seg_size=256)
    ids, d = idx.query(q, 10, nprobe=5, approx=False)
    xn = x.astype(np.float64)
    d2 = ((q[:, None, :].astype(np.float64) - xn[None]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1)[:, :10]
    assert calculate_recall(ids, gt, 10) >= 0.999
    np.testing.assert_allclose(d, np.sort(d2, 1)[:, :10], rtol=1e-4, atol=2e-3)


def test_exact_tier_bf16_small_dim_matches_numpy():
    """bf16 cells at d=32: distances are f32-grade over the bf16 rows (the
    query is not rounded to bf16), at recall no lower than the reference
    over the same probed cells."""
    x, _ = generate_clustered_data(4000, 32, 8, seed=3)
    q = subsample_with_noise(x, 60, seed=3)
    ti, _ = ExhaustiveIndex(x, "euclidean").query(q, 10)
    idx = IvfIndexBf16(x, "euclidean", nlist=16, seed=0)
    ai, ad = idx.query(q, 10, nprobe=8)
    rows = idx.vectors_original_order().astype(np.float64)
    q64 = np.asarray(q, np.float64)
    d_true = ((q64[:, None, :] - rows[ai]) ** 2).sum(-1)
    # the scan's f32 identity ‖q‖² + ‖x‖² − 2q·x rounds at ~2⁻²³ of its
    # operands; a bf16-rounded query would err at ~2⁻⁹ of ‖q‖·‖x‖
    scale = (q64**2).sum(-1)[:, None] + (rows[ai] ** 2).sum(-1)
    assert np.all(np.abs(ad - d_true) <= 1e-5 * d_true + 4e-6 * scale)
    srt = np.asarray(idx.storage[: idx.n].astype(np.float32), np.float64)
    ref_ids, ref_d = _probed_reference(idx, q64, srt, 8, 10, "euclidean", q64)
    _assert_matches(ai, ad, ref_ids, ref_d, rtol=1e-4, atol=2e-3)
    assert calculate_recall(ti, ai, 10) >= calculate_recall(ti, ref_ids, 10) - 1e-9


def test_exact_tier_sq8_small_dim_matches_integer_reference():
    """sq8 at d=32: integer-space distances, bit-exact against NumPy."""
    x, _ = generate_clustered_data(4000, 32, 8, seed=5)
    q = subsample_with_noise(x, 60, seed=5)
    idx = IvfSq8Index(x, "euclidean", nlist=16, seed=0)
    ids, d = idx.query(q, 10, nprobe=8)
    qp = idx._prep_queries(q)
    qi = np.asarray(idx._encode_queries(qp), np.int64)
    rows = np.asarray(idx.storage[: idx.n], np.int64)
    ref_ids, ref_d = _probed_reference(
        idx, qi, rows, 8, 10, "euclidean", np.asarray(qp)
    )
    _assert_matches(ids, d, ref_ids, ref_d, rtol=0, atol=1e-3)
