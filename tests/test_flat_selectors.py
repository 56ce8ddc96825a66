"""Flat top-k selectors (``ops/topk.blocked_query_topk``) against a NumPy
float64 brute force: the exact tile merge, per-tile approx selection and the
selection-free running bins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from annsearch_tpu.ops.topk import blocked_query_topk
from annsearch_tpu.utils.data import generate_clustered_data
from annsearch_tpu.utils.dist import Dist, normalise
from annsearch_tpu.utils.metrics import calculate_recall

P = jax.lax.Precision


def _numpy_topk(q, x, k, metric):
    q = np.asarray(q, np.float64)
    x = np.asarray(x, np.float64)
    if metric == Dist.COSINE:
        d = 1.0 - q @ x.T
    else:
        d = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    i = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, i, axis=1), i


@pytest.fixture(scope="module")
def data():
    x, _ = generate_clustered_data(700, 32, 5, seed=7)
    q = x[:50] + 0.01
    return jnp.asarray(x), jnp.asarray(q)


@pytest.mark.parametrize("metric", [Dist.EUCLIDEAN, Dist.COSINE])
@pytest.mark.parametrize(
    "precision,selector",
    [(P.HIGHEST, "exact"), (P.HIGHEST, "bins"), (P.DEFAULT, "approx")],
)
def test_flat_selector_parity(data, metric, precision, selector):
    x, q = data
    if metric == Dist.COSINE:
        x = normalise(x)
        q = normalise(q)
    ref_d, ref_i = _numpy_topk(q, x, 10, metric)
    d, i = blocked_query_topk(
        q, x, 10, metric, db_chunk=128, precision=precision,
        selector=selector,
    )
    rec = calculate_recall(ref_i, np.asarray(i), 10)
    assert rec >= (0.99 if precision == P.HIGHEST else 0.9)
    if precision == P.HIGHEST:
        # f32 identity ‖q‖² + ‖x‖² − 2q·x: near-zero distances carry
        # absolute error ~‖q‖‖x‖·2⁻²³
        np.testing.assert_allclose(np.asarray(d), ref_d, rtol=1e-3, atol=1e-2)
    assert np.all(np.diff(np.asarray(d), axis=-1) >= -1e-6)


def test_flat_n_valid_and_small_n():
    x, _ = generate_clustered_data(150, 32, 3, seed=8)
    x = jnp.asarray(x)
    d, i = blocked_query_topk(
        x[:10], x, 5, Dist.EUCLIDEAN, n_valid=100, db_chunk=128,
        selector="bins",
    )
    assert np.asarray(i).max() < 100
    _, ref_i = _numpy_topk(x[:10], x[:100], 5, Dist.EUCLIDEAN)
    assert calculate_recall(ref_i, np.asarray(i), 5) >= 0.99


def test_flat_k_exceeds_tile():
    """k larger than a query block's worth of rows still returns k exact
    neighbours (every row is a candidate)."""
    x = jnp.asarray(np.random.RandomState(0).randn(40, 32).astype(np.float32))
    d, i = blocked_query_topk(x[:4], x, 20, Dist.EUCLIDEAN, query_block=8)
    assert d.shape == (4, 20)
    ref_d, ref_i = _numpy_topk(x[:4], x, 20, Dist.EUCLIDEAN)
    np.testing.assert_array_equal(np.asarray(i), ref_i)
    np.testing.assert_allclose(np.asarray(d), ref_d, rtol=1e-4, atol=1e-4)
