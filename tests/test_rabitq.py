"""RaBitQ tests: estimator sanity, recall with/without rerank
(reference: rabitq.rs + exhaustive_rabitq.rs/ivf_rabitq.rs tests)."""

import numpy as np
import jax.numpy as jnp
import pytest

from annsearch_tpu.models.binary.rabitq import (
    ExhaustiveIndexRaBitQ,
    IvfIndexRaBitQ,
    RaBitQEncoder,
)
from annsearch_tpu.models.exhaustive import ExhaustiveIndex
from annsearch_tpu.utils.data import generate_clustered_data, subsample_with_noise
from annsearch_tpu.utils.metrics import calculate_recall


def test_encoder_rotation_orthogonal():
    enc = RaBitQEncoder.create(32, seed=0)
    r = np.asarray(enc.rotation)
    np.testing.assert_allclose(r @ r.T, np.eye(32), atol=1e-5)


def test_encoder_metadata(rng):
    enc = RaBitQEncoder.create(32, seed=0)
    x = jnp.asarray(rng.standard_normal((50, 32)).astype(np.float32))
    c = jnp.zeros((50, 32), jnp.float32)
    codes, v_dist, corr = enc.encode_vectors(x, c)
    np.testing.assert_allclose(
        np.asarray(v_dist), np.linalg.norm(np.asarray(x), axis=1), rtol=1e-5
    )
    # dot correction = L1 norm of a rotated unit vector ∈ [1, √d]
    assert (np.asarray(corr) >= 0.99).all()
    assert (np.asarray(corr) <= np.sqrt(32) + 1e-3).all()


@pytest.fixture(scope="module")
def rdata():
    x, _ = generate_clustered_data(3000, 64, 8, seed=0)
    q = subsample_with_noise(x, 150, seed=0)
    exact = ExhaustiveIndex(x, "euclidean")
    ti, _ = exact.query(q, 10)
    return x, q, ti


def test_exhaustive_rabitq_estimates(rdata):
    x, q, ti = rdata
    index = ExhaustiveIndexRaBitQ(x, seed=0)
    ai, ad = index.query(q, 10, nprobe=index.nlist)  # probe everything
    r = calculate_recall(ti, ai, 10)
    # 1-bit codes + exact sign-dot, no rerank: ~0.5 on this suite (the
    # reference's headline numbers always use exact rerank)
    assert r > 0.4, r
    # estimates are non-squared euclidean: compare to sqrt of true dists
    full = np.sqrt(((q[:3, None, :] - x[None, :, :]) ** 2).sum(-1))
    est = ad[:3, 0]
    true_near = full.min(axis=1)
    np.testing.assert_allclose(est, true_near, rtol=0.5, atol=1.0)


def test_exhaustive_rabitq_rerank(rdata):
    x, q, ti = rdata
    index = ExhaustiveIndexRaBitQ(x, seed=0)
    ai, ad = index.query(q, 10, nprobe=index.nlist, rerank="exact", rerank_factor=10)
    assert calculate_recall(ti, ai, 10) > 0.95


def test_ivf_rabitq_recall(rdata):
    x, q, ti = rdata
    index = IvfIndexRaBitQ(x, nlist=16, seed=0)
    ai, _ = index.query(q, 10, nprobe=16, rerank="exact", rerank_factor=10)
    assert calculate_recall(ti, ai, 10) > 0.95


def test_ivf_rabitq_cosine(rdata):
    x, q, _ = rdata
    exact = ExhaustiveIndex(x, "cosine")
    ti, _ = exact.query(q, 10)
    index = IvfIndexRaBitQ(x, "cosine", nlist=16, seed=0)
    ai, _ = index.query(q, 10, nprobe=16, rerank="exact", rerank_factor=10)
    assert calculate_recall(ti, ai, 10) > 0.9


def test_rabitq_self_query(rdata):
    x, _, _ = rdata
    index = IvfIndexRaBitQ(x[:800], nlist=8, seed=0)
    idx, _ = index.generate_knn(3, nprobe=8, rerank="exact")
    assert (idx[:, 0] == np.arange(800)).mean() > 0.95


def test_rabitq_memory_compression(rdata):
    x, _, _ = rdata
    index = ExhaustiveIndexRaBitQ(x, seed=0, store=False)
    # ~1 bit/dim + 8B metadata + rotation ≈ far below f32
    assert index.memory_usage_bytes() < x.size * 4 / 3


def test_rerank_factor_monotone(rdata):
    """More rerank candidates must never lower recall (guards the exact
    rerank's precision: a reduced-precision DEFAULT product made rf20 <
    rf10)."""
    import annsearch_tpu as ann
    from annsearch_tpu.utils.metrics import calculate_recall

    x, q, ti = rdata
    idx = ann.build_exhaustive_index_rabitq(x, seed=0)
    recs = []
    for rf in (2, 5, 10):
        ai, _ = idx.query(q, 10, nprobe=idx.nlist, rerank="exact",
                          rerank_factor=rf)
        recs.append(calculate_recall(np.asarray(ti), np.asarray(ai), 10))
    assert recs[0] <= recs[1] + 1e-9 and recs[1] <= recs[2] + 1e-9, recs
    assert recs[-1] >= 0.95


def test_fused_estimator_matches_xla_scan(fused_kernel):
    """fast_scan RaBitQ (fused i8dec_residual with sn/corr folded into ±1
    rows + exact clipped rescore of the returned slots) must track the XLA
    estimator scan: same recall, near-identical values on matched slots."""
    import numpy as np
    from annsearch_tpu.models.binary.rabitq import ExhaustiveIndexRaBitQ
    from annsearch_tpu.models.exhaustive import ExhaustiveIndex
    from annsearch_tpu.utils.data import generate_clustered_data, subsample_with_noise
    from annsearch_tpu.utils.metrics import calculate_recall

    x, _ = generate_clustered_data(4000, 128, 10, seed=12)
    q = subsample_with_noise(x, 200, seed=12)
    ti, _ = ExhaustiveIndex(x).query(q, 10)
    fast = ExhaustiveIndexRaBitQ(x, seed=0, fast_scan=True)
    slow = ExhaustiveIndexRaBitQ(x, seed=0, fast_scan=False)
    assert fast._fused_est_ok(10)
    i_f, d_f = fast.query(q, 10, nprobe=15)
    i_s, d_s = slow.query(q, 10, nprobe=15)
    r_f = calculate_recall(ti, i_f, 10)
    r_s = calculate_recall(ti, i_s, 10)
    assert abs(r_f - r_s) < 0.02, (r_f, r_s)
    m = (i_f == i_s) & np.isfinite(d_s) & (d_s > 1e-3)
    assert m.mean() > 0.9
    rel = np.abs(d_f[m] - d_s[m]) / d_s[m]
    assert np.percentile(rel, 99) < 0.05
    # exact tier identical
    i_f, _ = fast.query(q, 10, nprobe=15, rerank="exact", rerank_factor=10,
                        exact_fallback=False)
    i_s, _ = slow.query(q, 10, nprobe=15, rerank="exact", rerank_factor=10,
                        exact_fallback=False)
    assert (i_f == i_s).mean() > 0.999
