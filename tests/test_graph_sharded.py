"""Sharded CAGRA graph index on the virtual 8-device CPU mesh
(BASELINE config 5: graph index sharded over a device mesh)."""

import numpy as np
import pytest

from annsearch_tpu.parallel.graph_sharded import (
    ShardedGraphIndex,
    ring_self_knn,
)
from annsearch_tpu.parallel.mesh import DB_AXIS, make_mesh
from annsearch_tpu.utils.data import generate_clustered_data


@pytest.fixture(scope="module")
def gdata():
    x, _ = generate_clustered_data(800, 16, 8, seed=5)
    return x


def _exact_knn(x, k):
    d = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    ids = np.argsort(d, axis=1)[:, :k]
    return ids, np.take_along_axis(d, ids, axis=1)


def test_ring_self_knn_exact(gdata):
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import jax

    from annsearch_tpu.utils.dist import Dist

    x = gdata[:777]  # not divisible by 8 → pad rows in the last shard
    mesh = make_mesh(8)
    pad = (-777) % 8
    xp = np.concatenate([x, np.zeros((pad, x.shape[1]), np.float32)])
    xs = jax.device_put(jnp.asarray(xp), NamedSharding(mesh, P(DB_AXIS)))
    ids, dists = ring_self_knn(xs, 10, Dist.EUCLIDEAN, 777, mesh)
    ids = np.asarray(ids)[:777]
    dists = np.asarray(dists)[:777]
    gt_ids, gt_d = _exact_knn(x, 10)
    # distances must match the exact graph (ids may swap on ties)
    np.testing.assert_allclose(dists, gt_d, rtol=1e-3, atol=1e-3)
    recall = np.mean([
        len(set(ids[r]) & set(gt_ids[r])) / 10 for r in range(777)
    ])
    assert recall > 0.999
    assert (ids < 777).all()


def test_sharded_graph_self_query(gdata):
    mesh = make_mesh(8)
    index = ShardedGraphIndex(gdata, "euclidean", k=10, mesh=mesh)
    q = gdata[:32]
    idx, dist = index.query(q, 8)
    np.testing.assert_array_equal(idx[:, 0], np.arange(32))
    # beam scores are f32-grade via 2-part mantissa splits: self-distance
    # floor ~‖x‖²·2⁻¹⁵ (same semantics the single-chip test asserts as
    # median < 1e-3)
    np.testing.assert_allclose(dist[:, 0], 0.0, atol=5e-3)
    assert np.median(dist[:, 0]) < 1e-3
    # ascending distances
    assert (np.diff(dist, axis=1) >= -1e-6).all()


def test_sharded_graph_recall(gdata):
    mesh = make_mesh(8)
    index = ShardedGraphIndex(gdata, "euclidean", k=10, mesh=mesh)
    q = gdata[100:200] + 0.01
    idx, _ = index.query(q, 10, beam=32)
    d = ((q[:, None, :] - gdata[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1)[:, :10]
    recall = np.mean([
        len(set(idx[r]) & set(gt[r])) / 10 for r in range(len(q))
    ])
    assert recall > 0.9


def test_sharded_graph_generate_knn(gdata):
    mesh = make_mesh(8)
    index = ShardedGraphIndex(gdata, "euclidean", k=10, mesh=mesh)
    ids, dists = index.generate_knn(8, mode="graph")
    gt_ids, gt_d = _exact_knn(gdata, 8)
    np.testing.assert_allclose(dists, gt_d[:, :8], rtol=1e-3, atol=1e-3)
    recall = np.mean([
        len(set(ids[r]) & set(gt_ids[r])) / 8 for r in range(len(gdata))
    ])
    assert recall > 0.999


def test_sharded_graph_cosine(gdata):
    mesh = make_mesh(8)
    index = ShardedGraphIndex(gdata, "cosine", k=10, mesh=mesh)
    q = gdata[:16]
    idx, dist = index.query(q, 5)
    np.testing.assert_array_equal(idx[:, 0], np.arange(16))
    np.testing.assert_allclose(dist[:, 0], 0.0, atol=5e-3)


def test_sharded_graph_padding(gdata):
    # n not divisible by ndev → pad rows must never be returned
    x = gdata[:701]
    mesh = make_mesh(8)
    index = ShardedGraphIndex(x, "euclidean", k=8, mesh=mesh)
    idx, dist = index.query(x[:16], 8)
    assert (idx < 701).all()
    np.testing.assert_array_equal(idx[:, 0], np.arange(16))
    ids, _ = index.generate_knn(8)
    assert (ids < 701).all()


def test_sharded_graph_grid_query(gdata):
    """2-D (batch, db) grid: query batches shard along `batch` (VERDICT r3
    next-round #5). Self-query + recall parity with the 1-D path."""
    from annsearch_tpu.parallel.mesh import make_mesh2d

    grid = make_mesh2d(2, 4)
    index = ShardedGraphIndex(gdata, "euclidean", k=10, mesh=grid)
    q = gdata[:33]  # nq not divisible by batch axis → padding
    idx, dist = index.query(q, 8)
    assert idx.shape == (33, 8)
    np.testing.assert_array_equal(idx[:, 0], np.arange(33))
    np.testing.assert_allclose(dist[:, 0], 0.0, atol=5e-3)
    qn = gdata[100:200] + 0.01
    gi, _ = index.query(qn, 10, beam=32)
    d = ((qn[:, None, :] - gdata[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1)[:, :10]
    recall = np.mean([
        len(set(gi[r]) & set(gt[r])) / 10 for r in range(len(qn))
    ])
    assert recall > 0.9, recall


def test_sharded_graph_knn_beam_tier(gdata):
    """FLOP-budget routing in generate_knn (VERDICT r3 next-round #8): a
    tiny budget must push the self-kNN onto the approximate beam ring, and
    its graph recall must stay high (each travelling block beam-searches
    every sub-graph, so the union covers the whole database)."""
    mesh = make_mesh(8)
    index = ShardedGraphIndex(gdata, "euclidean", k=10, mesh=mesh)
    # budget 1 ⇒ per-device m·n·d MACs always exceed it ⇒ beam ring
    ids, dists = index.generate_knn(8, mode="graph", flop_budget=1)
    assert (ids < len(gdata)).all()
    gt_ids, _ = _exact_knn(gdata, 8)
    recall = np.mean([
        len(set(ids[r]) & set(gt_ids[r])) / 8 for r in range(len(gdata))
    ])
    assert recall > 0.9, recall
    # no self-loops
    assert not (ids == np.arange(len(gdata))[:, None]).any()
    # ascending distances
    assert (np.diff(np.where(np.isinf(dists), 1e30, dists), axis=1) >= -1e-6).all()
