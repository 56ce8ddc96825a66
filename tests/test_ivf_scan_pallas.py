"""Fused cell-scan kernel: parity against the XLA scan, and its routing.

The kernel runs compiled on a GPU only; here it runs in Pallas interpret
mode (same program, Python-evaluated) called at the ops level, so these
tests pin the kernel's *semantics*: distances and recall must match the
exact-selection XLA scan (``ops/ivf_scan.ivf_cluster_scan``) on the same
task lists.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from annsearch_tpu.models.ivf import IvfIndex
from annsearch_tpu.models.ivf_base import route_to_cells
from annsearch_tpu.models.quantised.ivf import (
    IvfIndexBf16,
    IvfOpqIndex,
    IvfPqIndex,
    IvfSq8Index,
)
from annsearch_tpu.ops.ivf_scan import ivf_cluster_scan
from annsearch_tpu.ops.ivf_scan_pallas import fused_eligible, fused_ivf_scan
from annsearch_tpu.ops.probe_device import (
    build_probe_lists_device,
    device_probe_shapes,
)
from annsearch_tpu.utils.data import (
    generate_clustered_data,
    subsample_with_noise,
)
from annsearch_tpu.utils.dist import Dist
from annsearch_tpu.utils.metrics import calculate_recall


@pytest.fixture(scope="module")
def data128():
    x, _ = generate_clustered_data(1200, 128, 6, seed=3)
    q = subsample_with_noise(x, 25, seed=4)
    return x, q


def _scan_both(idx, query_mat, k, nprobe, q_split=False):
    """Route to segments and build device task lists the way the fused
    query path does, then run the kernel (interpreted) and the exact XLA
    scan on the SAME lists. Returns ``(fused, xla)``, each ``(original ids,
    dists)``."""
    q = idx._prep_queries(query_mat)
    nseg = int(idx.seg_offsets.shape[0])
    nprobe_seg = min(nseg, max(nprobe, -(-nprobe * nseg) // idx.nlist))
    maxq, R = device_probe_shapes(q.shape[0], nprobe_seg, nseg, 1)
    probes = route_to_cells(q, idx.seg_centroids, nprobe_seg, idx.metric)
    cids, lists, gmap = build_probe_lists_device(
        probes.astype(jnp.int32), nseg, maxq, R
    )
    qe = idx._encode_queries(q)
    common = (
        qe, cids, lists, gmap, idx.storage, idx.store_sqnorms,
        idx.seg_offsets, idx.seg_counts, idx._scan_seg_centroids(),
    )
    kb = max(8, 1 << (k - 1).bit_length())
    df, pf = fused_ivf_scan(
        *common, k, idx.metric, idx.mode, idx._codebooks(), kb,
        q_split=q_split, interpret=True,
    )
    dx, px = ivf_cluster_scan(
        *common, k, idx.metric, idx.seg_size, idx.mode,
        codebooks=idx._codebooks(),
    )
    oid = np.asarray(idx.original_ids)

    def ids(p):
        return oid[np.clip(np.asarray(p), 0, idx.n - 1)]

    return (ids(pf), np.asarray(df)), (ids(px), np.asarray(dx))


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize(
    "cls,kw",
    [
        (IvfPqIndex, {"m": 128}),
        (IvfOpqIndex, {"m": 128}),
        (IvfIndexBf16, {}),
        (IvfIndex, {}),
    ],
)
def test_fused_matches_xla_scan(data128, cls, kw, metric):
    x, q = data128
    idx = cls(x, metric, nlist=8, seg_size=256, **kw)
    (ia, da), (ie, _) = _scan_both(idx, q, 10, nprobe=4)
    # the fold keeps >= k candidates per (query, cell) and the final
    # cross-cell top-k is exact; near-ties may swap which candidate wins
    # (bf16 vs f32 scoring), so assert recall + per-hit distance correctness
    # against an f32 recomputation from the decoded reconstructions
    assert calculate_recall(ie, ia, 10) >= 0.95
    recon = idx.vectors_original_order()          # decoded, original ids
    qn = np.asarray(q, np.float32)
    rsel = recon[ia]                              # [nq, k, d]
    if metric == "cosine":
        qn = qn / np.linalg.norm(qn, axis=1, keepdims=True)
        sim = np.einsum("qd,qkd->qk", qn, rsel)
        dtrue = 1.0 - sim / np.maximum(np.linalg.norm(rsel, axis=-1), 1e-12)
    else:
        diff = qn[:, None, :] - rsel
        dtrue = np.sum(diff * diff, axis=-1)
    # bf16 scoring error scales with the dot magnitude (‖q‖·‖x‖·2⁻⁸), which
    # for euclidean-with-cancellation can exceed the distance itself
    mag = np.linalg.norm(qn, axis=1)[:, None] * np.linalg.norm(rsel, axis=-1)
    tol = 2e-2 + 2e-2 * np.abs(dtrue) + 1.5e-2 * mag
    assert np.all(np.abs(da - dtrue) <= tol)
    assert np.all(np.diff(da, axis=-1) >= 0)


def test_fused_self_query(data128):
    x, _ = data128
    idx = IvfPqIndex(x, "euclidean", nlist=8, m=128, seg_size=256)
    (ids, dists), _ = _scan_both(idx, x[:20], 5, nprobe=4)
    assert (ids[:, 0] == np.arange(20)).mean() >= 0.95
    assert np.all(np.diff(dists, axis=-1) >= -1e-5)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_fused_sq8_matches_xla_scan(data128, metric):
    """sq8 integer-space distances are exact in the fused kernel (int8 codes
    are exact in bf16, products accumulate exactly in f32)."""
    x, q = data128
    idx = IvfSq8Index(x, metric, nlist=8, seg_size=256)
    (ia, da), (ie, de) = _scan_both(idx, q, 10, nprobe=4)
    # distances are bit-exact; the fold may swap the odd near-tie, so
    # compare element-wise agreement rather than full equality
    assert calculate_recall(ie, ia, 10) >= 0.97
    agree = np.isclose(
        np.sort(de, axis=-1), np.sort(da, axis=-1), rtol=1e-5, atol=1e-5
    )
    # one swapped near-tie shifts every later sorted entry in its row, so
    # element-wise agreement understates set agreement
    assert agree.mean() >= 0.9


def test_fused_gate_rejects_unaligned(fused_kernel):
    # ineligible shapes must fall back to the XLA scan, not crash
    x, _ = generate_clustered_data(800, 32, 4, seed=5)
    idx = IvfIndexBf16(x, "euclidean", nlist=8, seg_size=64)
    assert not fused_eligible(idx.mode, idx.seg_size, 32, 10)
    assert not fused_eligible("bf16", 256, 96, 10)   # non-pow2 row width
    assert not fused_eligible("pq", 256, 16, 10)     # coded rows
    ids, d = idx.query(x[:10], 5, nprobe=4, approx=True)
    assert ids.shape == (10, 5)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("dim", [32, 64])
def test_fused_packed_small_dim_matches_xla(dim, metric):
    """Small-dim f32 cells: the kernel's f32 product must match the exact
    XLA scan at f32 grade."""
    x, _ = generate_clustered_data(1500, dim, 6, seed=21)
    q = subsample_with_noise(x, 40, seed=21)
    idx = IvfIndex(x, metric, nlist=10, seed=0)
    (idf, df), (ide, de) = _scan_both(idx, q, 10, nprobe=10)
    # full probe → both exact over the same candidate set
    agree = np.asarray([len(set(a) & set(b)) / 10 for a, b in zip(idf, ide)])
    assert agree.mean() >= 0.97, agree.mean()
    np.testing.assert_allclose(
        np.sort(df, 1), np.sort(de, 1), rtol=5e-3, atol=5e-3
    )


def test_fused_q_split_scores_queries_in_f32(data128):
    """``q_split=True`` keeps i8dec queries in f32: the kernel's distances
    then agree with the XLA scan's f32 scoring to f32 rounding."""
    x, q = data128
    idx = IvfPqIndex(x, "euclidean", nlist=8, m=128, seg_size=256)
    (ia, da), (ie, de) = _scan_both(idx, q, 10, nprobe=8, q_split=True)
    assert calculate_recall(ie, ia, 10) >= 0.99
    np.testing.assert_allclose(
        np.sort(da, 1), np.sort(de, 1), rtol=1e-4, atol=1e-3
    )


def _pallas_calls(jaxpr):
    """Every pallas_call equation in a (nested) jaxpr."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            out.append(eqn)
        for v in eqn.params.values():
            inner = getattr(v, "jaxpr", None)
            if inner is not None and hasattr(inner, "eqns"):
                out.extend(_pallas_calls(inner))
            elif hasattr(v, "eqns"):
                out.extend(_pallas_calls(v))
    return out


@pytest.mark.parametrize(
    "backend,no_pallas,fused",
    [("gpu", False, True), ("gpu", True, False), ("cpu", False, False)],
)
def test_fused_routing_rule(monkeypatch, backend, no_pallas, fused):
    """The fused kernel is taken on a GPU and nowhere else (and not under
    ``ANNSEARCH_NO_PALLAS``), and the library always asks for the compiled
    kernel (never the interpreter)."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if no_pallas:
        monkeypatch.setenv("ANNSEARCH_NO_PALLAS", "1")
    assert fused_eligible("i8dec_residual", 1024, 128, 10) is fused
    # shapes used by no other test: tracing fills jit caches
    nq, d, R, maxq, nseg, npad = 5, 16, 3, 32, 2, 512
    f32 = jnp.float32
    args = (
        jax.ShapeDtypeStruct((nq, d), f32),
        jax.ShapeDtypeStruct((R,), jnp.int32),
        jax.ShapeDtypeStruct((R, maxq), jnp.int32),
        jax.ShapeDtypeStruct((nq, 2), jnp.int32),
        jax.ShapeDtypeStruct((npad, d), jnp.int8),
        jax.ShapeDtypeStruct((npad,), f32),
        jax.ShapeDtypeStruct((nseg,), jnp.int32),
        jax.ShapeDtypeStruct((nseg,), jnp.int32),
        jax.ShapeDtypeStruct((nseg, d), f32),
    )
    closed = jax.make_jaxpr(
        lambda *a: fused_ivf_scan(
            *a, 3, Dist.EUCLIDEAN, "i8dec_residual", jnp.ones((d,), f32), 8
        )
    )(*args)
    calls = _pallas_calls(closed.jaxpr)
    assert len(calls) == 1
    assert calls[0].params["interpret"] is False
    assert calls[0].params["backend"] == "triton"
