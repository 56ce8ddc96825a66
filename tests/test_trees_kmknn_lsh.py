"""Tree family + kMkNN + LSH tests (reference: annoy.rs / kd_forest.rs /
ball_tree.rs / kmknn.rs / lsh.rs tests)."""

import numpy as np
import pytest

from annsearch_tpu.models.exhaustive import ExhaustiveIndex
from annsearch_tpu.models.kmknn import KmknnIndex
from annsearch_tpu.models.lsh import LSHIndex
from annsearch_tpu.models.trees import AnnoyIndex, BallTreeIndex, KdTreeIndex
from annsearch_tpu.utils.data import generate_clustered_data, subsample_with_noise
from annsearch_tpu.utils.metrics import calculate_recall


@pytest.fixture(scope="module")
def tdata():
    x, _ = generate_clustered_data(3000, 32, 8, seed=0)
    q = subsample_with_noise(x, 150, seed=0)
    exact = ExhaustiveIndex(x, "euclidean")
    ti, td = exact.query(q, 10)
    return x, q, ti, td


def test_annoy_recall(tdata):
    x, q, ti, _ = tdata
    index = AnnoyIndex(x, n_trees=16, seed=0)
    ai, ad = index.query(q, 10)
    rec = calculate_recall(ti, ai, 10)
    assert rec > 0.85, rec
    # unique neighbours per row (cross-tree dedup)
    for row in ai[:20]:
        assert len(np.unique(row)) == 10


def test_annoy_more_trees_better(tdata):
    x, q, ti, _ = tdata
    small = AnnoyIndex(x, n_trees=4, seed=0)
    big = AnnoyIndex(x, n_trees=32, seed=0)
    rs = calculate_recall(ti, small.query(q, 10)[0], 10)
    rb = calculate_recall(ti, big.query(q, 10)[0], 10)
    assert rb >= rs - 0.02


@pytest.mark.parametrize("cls", [AnnoyIndex, KdTreeIndex])
def test_forest_fused_scan_parity(tdata, monkeypatch, fused_kernel, cls):
    """The fused forest query (multi-probe descent → per-tree cell scan →
    id dedup, one dispatch) must track the gather+rerank path at matched
    probes, and never return duplicate ids (cross-tree dedup)."""
    x, q, ti, _ = tdata
    index = cls(x, n_trees=8, seed=0)
    scan = index._scan_setup()
    assert scan is not None and scan["cell"] == 128
    counts = np.asarray(scan["counts"])
    assert counts.sum() == index.n * len(index.trees)
    fi, fd = index.query(q, 10, n_probes=4)
    for row in fi:
        assert len(np.unique(row)) == 10
    assert np.all(np.diff(fd, axis=-1) >= 0)
    monkeypatch.setenv("ANNSEARCH_NO_PALLAS", "1")
    oi, od = index.query(q, 10, n_probes=4)
    rec_f = calculate_recall(ti, fi, 10)
    rec_o = calculate_recall(ti, oi, 10)
    # both paths rerank the same probed leaves exactly; the fused merge
    # keeps k·nt lanes so the distinct top-k always survives
    assert rec_f >= rec_o - 0.02, (rec_f, rec_o)


def test_kd_forest_recall(tdata):
    x, q, ti, _ = tdata
    index = KdTreeIndex(x, n_trees=16, seed=0)
    ai, _ = index.query(q, 10)
    assert calculate_recall(ti, ai, 10) > 0.8


def test_ball_tree_recall(tdata):
    x, q, ti, _ = tdata
    index = BallTreeIndex(x, seed=0)
    ai, _ = index.query(q, 10)  # default 5% budget ≈ 3 leaves on 3k points
    assert calculate_recall(ti, ai, 10) > 0.6
    hi, _ = index.query(q, 10, budget=0.3)
    assert calculate_recall(ti, hi, 10) > 0.9


def test_ball_tree_budget_sweep(tdata):
    x, q, ti, _ = tdata
    index = BallTreeIndex(x, seed=0)
    lo, _ = index.query(q, 10, budget=0.01)
    hi, _ = index.query(q, 10, budget=0.2)
    assert calculate_recall(ti, hi, 10) >= calculate_recall(ti, lo, 10) - 0.02


def test_ball_tree_fused_scan_parity(tdata, monkeypatch, fused_kernel):
    """The fused cell-scan path (cells = 2-leaf segments of the sorted
    order, ranked by min leaf-centre distance) must track the leaf-precise
    rerank path; full-budget probing must be exact."""
    from annsearch_tpu.models import trees as trees_mod

    monkeypatch.setattr(trees_mod, "_BALL_FUSED_MIN_CELLS", 1)
    x, q, ti, _ = tdata
    index = BallTreeIndex(x, seed=0)
    scan = index._scan_setup()
    assert scan is not None and scan["cell"] == 128
    # counts: valid rows form the global suffix-padded prefix per cell
    counts = np.asarray(scan["counts"])
    assert counts.sum() == index.n
    assert np.all(np.diff(counts) <= 0)
    fi, fd = index.query(q, 10, budget=0.3)
    monkeypatch.setenv("ANNSEARCH_NO_PALLAS", "1")
    index._scan_cache = None
    oi, od = index.query(q, 10, budget=0.3)
    rec_f = calculate_recall(ti, fi, 10)
    rec_o = calculate_recall(ti, oi, 10)
    assert rec_f >= rec_o - 0.08, (rec_f, rec_o)
    monkeypatch.delenv("ANNSEARCH_NO_PALLAS")
    index._scan_cache = None
    xi, xd = index.query(q, 10, budget=1.0)
    assert calculate_recall(ti, xi, 10) > 0.999


def test_kmknn_exact(tdata):
    x, q, ti, td = tdata
    index = KmknnIndex(x, seed=0)
    ai, ad = index.query(q, 10)
    rec = calculate_recall(ti, ai, 10)
    assert rec > 0.999, rec
    np.testing.assert_allclose(ad, td, rtol=1e-3, atol=1e-3)


def test_kmknn_exact_small_p0(tdata):
    # exactness must hold even with a tiny first phase
    x, q, ti, td = tdata
    index = KmknnIndex(x, nlist=32, seed=0)
    ai, ad = index.query(q, 10, p0=1)
    assert calculate_recall(ti, ai, 10) > 0.999
    np.testing.assert_allclose(ad, td, rtol=1e-3, atol=1e-3)


def test_kmknn_cosine_semantics(tdata):
    x, q, _, _ = tdata
    exact = ExhaustiveIndex(x, "cosine")
    ti, td = exact.query(q, 10)
    index = KmknnIndex(x, "cosine", seed=0)
    ai, ad = index.query(q, 10)
    assert calculate_recall(ti, ai, 10) > 0.999
    # cosine distances = 1 − cos, matching the exhaustive index
    np.testing.assert_allclose(ad, td, rtol=1e-2, atol=1e-3)


def test_kmknn_self_query(tdata):
    x, _, _, _ = tdata
    index = KmknnIndex(x[:600], seed=0)
    idx, dist = index.generate_knn(3)
    np.testing.assert_array_equal(idx[:, 0], np.arange(600))


def test_lsh_recall(tdata):
    x, q, ti, _ = tdata
    index = LSHIndex(x, num_tables=8, bits_per_hash=10, seed=0)
    ai, _ = index.query(q, 10, n_probes=4)
    assert calculate_recall(ti, ai, 10) > 0.5


def test_lsh_probes_help(tdata):
    x, q, ti, _ = tdata
    index = LSHIndex(x, num_tables=8, bits_per_hash=12, seed=0)
    lo, _ = index.query(q, 10, n_probes=1)
    hi, _ = index.query(q, 10, n_probes=8)
    assert calculate_recall(ti, hi, 10) >= calculate_recall(ti, lo, 10) - 0.02


def test_lsh_cosine(tdata):
    x, q, _, _ = tdata
    exact = ExhaustiveIndex(x, "cosine")
    ti, _ = exact.query(q, 10)
    index = LSHIndex(x, "cosine", num_tables=8, bits_per_hash=10, seed=0)
    ai, _ = index.query(q, 10, n_probes=4)
    assert calculate_recall(ti, ai, 10) > 0.5


def test_lsh_rejects_wide_hash():
    x = np.zeros((10, 8), np.float32)
    try:
        LSHIndex(x, bits_per_hash=31)
        assert False
    except ValueError:
        pass


def test_kmknn_save_load(tmp_path, tdata):
    x, q, ti, _ = tdata
    index = KmknnIndex(x[:600], seed=0)
    p = str(tmp_path / "kmknn.npz")
    index.save(p)
    loaded = KmknnIndex.load(p)
    i1, d1 = index.query(q[:10], 5)
    i2, d2 = loaded.query(q[:10], 5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, atol=1e-5)


def test_lsh_save_load(tmp_path, tdata):
    x, q, _, _ = tdata
    index = LSHIndex(x[:600], num_tables=4, bits_per_hash=8, seed=0)
    p = str(tmp_path / "lsh.npz")
    index.save(p)
    loaded = LSHIndex.load(p)
    i1, _ = index.query(q[:10], 5)
    i2, _ = loaded.query(q[:10], 5)
    np.testing.assert_array_equal(i1, i2)


def test_annoy_multiprobe_improves_recall(tdata):
    x, q, ti, _ = tdata
    index = AnnoyIndex(x, n_trees=8, seed=0)
    r1 = calculate_recall(ti, index.query(q, 10, n_probes=1)[0], 10)
    r4 = calculate_recall(ti, index.query(q, 10, n_probes=4)[0], 10)
    assert r4 >= r1 - 0.01
    assert r4 > 0.85


def test_lsh_fused_scan_matches_xla(fused_kernel):
    """Bucket scans on the fused kernel (buckets ARE segments) must track
    the XLA engine."""
    import os

    from annsearch_tpu.models.lsh import LSHIndex

    x, q, ti, _ = _bigger_lsh_fixture()
    idx = LSHIndex(x, num_tables=4, bits_per_hash=6, seed=0)
    assert idx.seg_size % 128 == 0, "layout must be fused-eligible"
    i_f, d_f = idx.query(q, 10, n_probes=4, exact_fallback=False)
    os.environ["ANNSEARCH_NO_PALLAS"] = "1"
    try:
        i_s, d_s = idx.query(q, 10, n_probes=4, exact_fallback=False)
    finally:
        del os.environ["ANNSEARCH_NO_PALLAS"]
    assert (i_f == i_s).mean() > 0.99
    rec_f = calculate_recall(ti, i_f, 10)
    rec_s = calculate_recall(ti, i_s, 10)
    assert abs(rec_f - rec_s) < 0.01, (rec_f, rec_s)


def _bigger_lsh_fixture():
    from annsearch_tpu.models.exhaustive import ExhaustiveIndex

    x, _ = generate_clustered_data(20000, 32, 10, seed=22)
    q = subsample_with_noise(x, 200, seed=22)
    ti, td = ExhaustiveIndex(x).query(q, 10)
    return x, q, ti, td


def test_kmknn_f64_pool_rescore():
    """f64 input + f64 queries → f64-exact results from KmknnIndex.query
    (VERDICT r3 next-round #9)."""
    from annsearch_tpu.models.kmknn import KmknnIndex

    rng = np.random.default_rng(22)
    base = rng.standard_normal((300, 16))
    x = np.concatenate([base, base + 1e-8 * rng.standard_normal((300, 16))])
    q = base[:40] + 1e-9
    index = KmknnIndex(x, "euclidean", nlist=8, seed=0)
    ids, d = index.query(q, 5)
    assert d.dtype == np.float64
    diff = q[:, None, :] - x[None]
    dm = np.einsum("qnd,qnd->qn", diff, diff)
    gt = np.argsort(dm, axis=1)[:, :5]
    gd = np.take_along_axis(dm, gt, axis=1)
    np.testing.assert_allclose(d, gd, rtol=1e-12, atol=0)
    agree = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(ids, gt)])
    assert agree >= 0.99
    # native (non-fallback) path must agree too
    ids2, d2 = index.query(q, 5, exact_fallback=False)
    np.testing.assert_allclose(d2, gd, rtol=1e-12, atol=0)
