"""Cluster-major IVF scan engine.

The reference GPU IVF pipeline builds a host-side task list
(query, cluster-range, write offset) and launches one mega-kernel over it
(``src/gpu/ivf_gpu.rs:575-697``). This reformulation keeps the host-built
probe lists but inverts the loop to make every step a *dense* matmul:

  scan over active clusters c:
    cell   = storage[offsets[c] : offsets[c]+cap]          (one DMA, shared)
    dec    = decode(cell)                                  (variant-specific)
    qg     = queries[probe_lists[c]]                       ([maxq, d] gather)
    dists  = distance(qg, dec)                             ([maxq, cap] matmul)
    ys[c]  = per-(query,cell) top-k_cell                   (dense stacked write)

Each cell is read/decoded ONCE per query batch regardless of how many queries
probe it, and the scoring matmul is [maxq, d] × [d, cap] — dense matrix-unit
work. Per-step results are stacked densely by ``lax.scan`` (contiguous writes —
the previous design's scatter into a per-query proposal buffer was ~40% of step
time); one host-built gather map regroups lanes per query for the final top-k.

Supports storage variants: f32, bf16, int8 (SQ8 integer-space), PQ codes
(+ residual PQ for IVF-PQ/OPQ), int8 fast-scan decode caches
(i8dec/i8dec_residual — PQ reconstructions requantised per-dim to int8 so
the scan is a pure matmul with zero decode work; exact int8 values are
loss-free in bf16 on the tensor cores).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.dist import Dist, sq_norms
from .binary import unpack_pm1
from .quantised import pq_decode_tile

__all__ = ["ivf_cluster_scan", "build_probe_lists", "build_probe_lists_from_pairs"]

_INF = jnp.float32(jnp.inf)


def _next_pow2(v: int) -> int:
    return 1 << (max(v, 1) - 1).bit_length()


def build_probe_lists(
    probes: np.ndarray, nlist: int, nq: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Invert [nq, nprobe] probe assignments into per-cluster query lists.

    Returns ``(cluster_ids [ncl], lists [ncl, maxq], gather_map [nq, T])``
    covering only clusters probed by ≥1 query; ``lists`` is padded with
    ``nq`` (a sentinel query row), ``cluster_ids`` is padded to a power of
    two with ``nlist`` (sentinel cluster with zero count). Host-side — the
    analogue of the reference's CPU task-list construction
    (ivf_gpu.rs:600-635). Both dims are rounded up to powers of two to bound
    recompilation.
    """
    probes = np.asarray(probes)
    flat_c = probes.reshape(-1)
    flat_q = np.repeat(
        np.arange(probes.shape[0], dtype=np.int32), probes.shape[1]
    )
    return build_probe_lists_from_pairs(flat_q, flat_c, nlist, nq)


def build_probe_lists_from_pairs(
    flat_q: np.ndarray,
    flat_c: np.ndarray,
    nlist: int,
    nq: int,
    maxq_cap: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build per-cluster padded query lists from explicit (query, cluster)
    task pairs. Fully vectorised host work (the self-kNN path pushes
    nq·nprobe into the millions — no python loops).

    Returns ``(cluster_ids [ncl], lists [ncl, maxq], gather_map [nq, T])``.
    ``gather_map[q, t]`` is the flat scan lane (``row·maxq + col``) holding
    query ``q``'s ``t``-th task result, padded with ``-1`` (out-of-bounds →
    ``jnp.take(mode="fill")`` yields +inf). ``T`` is the padded max task
    count per query.

    Skewed probe distributions make the padded width ``maxq`` balloon (a
    popular cluster sets the pad for every row). ``maxq_cap`` chunks a
    popular cluster's query list across several scan rows (the same cell is
    scanned once per chunk), bounding padding waste; defaults to
    4× the mean row occupancy.
    """
    flat_q = np.asarray(flat_q, dtype=np.int32)
    flat_c = np.asarray(flat_c, dtype=np.int64)
    order = np.argsort(flat_c, kind="stable")
    counts = np.bincount(flat_c, minlength=nlist)
    active = np.nonzero(counts)[0]
    if len(active) == 0:
        return (
            np.full(1, nlist, np.int32),
            np.full((1, 1), nq, np.int32),
            np.full((nq, 1), -1, np.int32),
        )
    acounts = counts[active]
    if maxq_cap is None:
        mean = max(1, int(acounts.mean()))
        maxq_cap = _next_pow2(4 * mean)
    maxq = min(_next_pow2(int(acounts.max())), _next_pow2(maxq_cap))

    # rows per active cluster after chunking
    nchunks = -(-acounts // maxq)
    total_rows = int(nchunks.sum())
    ncl = _next_pow2(total_rows)

    # smallest dtypes that fit — probe lists travel host→device every query
    # batch, and on bandwidth-limited links the upload is measurable
    q_dtype = np.uint16 if nq < 2**16 - 1 else np.int32
    c_dtype = np.uint16 if nlist < 2**16 - 1 else np.int32
    cluster_ids = np.full(ncl, nlist, dtype=c_dtype)
    cluster_ids[:total_rows] = np.repeat(active, nchunks).astype(c_dtype)
    lists = np.full((ncl, maxq), nq, dtype=q_dtype)

    qs = flat_q[order]
    # rank of each task within its cluster
    starts = np.concatenate([[0], np.cumsum(acounts)[:-1]])
    ranks = np.arange(len(qs)) - np.repeat(starts, acounts)
    # row = cluster's first row + rank // maxq; col = rank % maxq
    row_base = np.concatenate([[0], np.cumsum(nchunks)[:-1]])
    rows = np.repeat(row_base, acounts) + ranks // maxq
    cols = ranks % maxq
    lists[rows, cols] = qs

    # per-task ordinal within its query (0..T-1): occurrence index of the
    # query id over the task stream — gives each (query, task) a column in
    # the final gather map
    qorder = np.argsort(flat_q, kind="stable")
    qcounts = np.bincount(flat_q, minlength=nq)
    qstarts = np.concatenate([[0], np.cumsum(qcounts)[:-1]])
    qranks = np.empty(len(flat_q), np.int32)
    qranks[qorder] = (
        np.arange(len(flat_q)) - np.repeat(qstarts, qcounts)
    ).astype(np.int32)
    t_max = int(qcounts.max()) if len(flat_q) else 1
    T = _next_pow2(max(t_max, 1))
    gather_map = np.full((nq, T), -1, np.int32)
    gather_map[qs, qranks[order]] = (rows * maxq + cols).astype(np.int32)
    return cluster_ids, lists, gather_map


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "metric", "cap", "mode", "k_cell", "precision", "approx",
        "s_rows",
    ),
)
def ivf_cluster_scan(
    queries: jax.Array,      # [nq, d] effective queries (f32, u32 or i8)
    cluster_ids: jax.Array,  # [ncl] int active clusters (pad = nlist)
    probe_lists: jax.Array,  # [ncl, maxq] int query ids (pad = nq)
    gather_map: jax.Array,   # [nq, T] int32 flat scan lanes (pad = -1)
    storage: jax.Array,      # [n_pad, d] (f32/bf16/i8) or [n_pad, m] u8/u32
    sqnorms: jax.Array,      # [n_pad] f32|i32 — ‖row‖² in the scoring space
    offsets: jax.Array,      # [nlist] int32 into the sorted storage
    counts: jax.Array,       # [nlist] int32 cell sizes
    centroids: jax.Array,    # [nlist, d] f32 (residual shift / cosine dot)
    k: int,
    metric: Dist,
    cap: int,
    mode: str,
    codebooks: jax.Array | None = None,  # [m, 256, ds] for pq; [d] scales for i8dec
    k_cell: int | None = None,
    aux: jax.Array | None = None,        # [n_pad] extra (rabitq: dot_corr)
    approx: bool = False,                # approx_min_k per-cell selection
    precision=None,
    s_rows: int = 4,                     # scan rows batched per step
) -> tuple[jax.Array, jax.Array]:
    """Dense-output cluster scan.

    Each step scores ``s_rows`` scan rows and emits that tile's per-(query,
    task) top-``k_cell`` as a stacked ``lax.scan`` output — a contiguous
    write, no read-modify-write carry and no scatter. The final phase
    gathers each query's ``T`` task lanes (host-built ``gather_map``) and
    runs one exact top-k.

    Returns ``(best_d, best_i)`` of shape ``[nq, k]`` ascending.
    ``best_i`` are positions in the sorted storage. ``storage``/``sqnorms``
    must be padded with ≥ ``cap`` trailing rows.
    """
    nq, dq = queries.shape
    nlist = offsets.shape[0]
    kc = min(k_cell if k_cell is not None else k, cap)
    prec_pq = jax.lax.Precision.DEFAULT if precision is None else precision
    prec_f32 = jax.lax.Precision.HIGHEST if precision is None else precision

    ncl, maxq = probe_lists.shape
    S = max(1, min(s_rows, ncl))
    pad_rows = (-ncl) % S
    if pad_rows:
        cluster_ids = jnp.concatenate(
            [cluster_ids,
             jnp.full((pad_rows,), nlist, cluster_ids.dtype)]
        )
        probe_lists = jnp.concatenate(
            [probe_lists,
             jnp.full((pad_rows, maxq), nq, probe_lists.dtype)]
        )
    n_steps = cluster_ids.shape[0] // S

    if mode in ("hamming", "binary_asym", "rabitq"):
        q_sq = jnp.zeros((nq,), jnp.float32)
    elif mode == "sq8":
        q_sq = jnp.sum(
            queries.astype(jnp.int32) * queries.astype(jnp.int32), axis=-1
        ).astype(jnp.float32)
    else:
        q_sq = sq_norms(queries)
    queries_x = jnp.concatenate(
        [queries, jnp.zeros((1, dq), queries.dtype)]
    )
    q_sq = jnp.concatenate([q_sq, jnp.zeros((1,), jnp.float32)])
    offsets_x = jnp.concatenate([offsets, jnp.zeros((1,), offsets.dtype)])
    counts_x = jnp.concatenate([counts, jnp.zeros((1,), counts.dtype)])
    centroids_x = jnp.concatenate(
        [centroids, jnp.zeros((1, centroids.shape[1]), centroids.dtype)]
    )

    def step(_, si):
        rows = si * S + jnp.arange(S)
        c = cluster_ids[rows].astype(jnp.int32)      # [S]
        qid = probe_lists[rows].astype(jnp.int32)    # [S, maxq]
        starts = offsets_x[c]                        # [S]
        cells = jnp.stack(
            [
                jax.lax.dynamic_slice_in_dim(storage, starts[j], cap, 0)
                for j in range(S)
            ]
        )                                            # [S, cap, w]
        sn = jnp.stack(
            [
                jax.lax.dynamic_slice_in_dim(sqnorms, starts[j], cap, 0)
                for j in range(S)
            ]
        ).astype(jnp.float32)                        # [S, cap]
        qid_safe = jnp.minimum(qid, nq)
        qg = queries_x[qid_safe]                     # [S, maxq, d]
        lane = jax.lax.broadcasted_iota(jnp.int32, (S, 1, cap), 2)
        valid = lane < counts_x[c][:, None, None]

        def dots_of(lhs, rhs, prec=None, pref=jnp.float32):
            return jnp.einsum(
                "smd,scd->smc", lhs, rhs, precision=prec,
                preferred_element_type=pref,
            )

        if mode in ("pq", "pq_residual", "i8dec", "i8dec_residual"):
            if mode.startswith("i8dec"):
                # int8 fast-scan decode cache: storage holds per-dim
                # requantised PQ reconstructions; decode = one VPU multiply
                # (codebooks arg carries the [d] scales)
                dec = cells.astype(jnp.float32) * codebooks[None, None, :]
            else:
                dec = pq_decode_tile(
                    cells.reshape(S * cap, -1), codebooks
                ).reshape(S, cap, -1)                # [S, cap, d] f32
            if mode.endswith("_residual"):
                if metric == Dist.COSINE:
                    num = dots_of(qg, dec, prec_pq) + jnp.einsum(
                        "smd,sd->sm", qg, centroids_x[c]
                    )[:, :, None]
                    d = 1.0 - num / jnp.sqrt(jnp.maximum(sn, 1e-12))[:, None, :]
                else:
                    qr = qg - centroids_x[c][:, None, :]
                    qr_sq = jnp.sum(qr * qr, axis=-1)
                    d = jnp.maximum(
                        qr_sq[:, :, None] + sn[:, None, :]
                        - 2.0 * dots_of(qr, dec, prec_pq),
                        0.0,
                    )
            else:
                dots = dots_of(qg, dec, prec_pq)
                if metric == Dist.COSINE:
                    d = 1.0 - dots / jnp.sqrt(jnp.maximum(sn, 1e-12))[:, None, :]
                else:
                    d = jnp.maximum(
                        q_sq[qid_safe][:, :, None] + sn[:, None, :]
                        - 2.0 * dots,
                        0.0,
                    )
        elif mode == "rabitq":
            # RaBitQ unbiased estimator (reference dist_binary.rs:466-588,
            # rabitq.rs:97-207). queries/centroids arrive pre-rotated and
            # zero-padded to w·32 lanes; sn = ‖x−c‖; aux = ‖R·u‖₁.
            # Deviation: the sign dot is an exact ±1 matmul instead of
            # the reference's int4-quantised SIMD dot.
            nbits = storage.shape[1] * 32
            rqr = qg - centroids_x[c][:, None, :]
            q_dist = jnp.sqrt(jnp.sum(rqr * rqr, axis=-1))    # [S, maxq]
            qru = rqr / jnp.maximum(q_dist, 1e-12)[:, :, None]
            x_pm = unpack_pm1(cells.reshape(S * cap, -1), nbits).reshape(
                S, cap, nbits
            )
            inner = dots_of(qru.astype(jnp.bfloat16), x_pm)
            corr = jnp.stack(
                [
                    jax.lax.dynamic_slice_in_dim(aux, starts[j], cap, 0)
                    for j in range(S)
                ]
            )                                                  # [S, cap]
            q_dot_v = jnp.where(
                corr[:, None, :] > 1e-6,
                jnp.clip(
                    inner / jnp.maximum(corr, 1e-12)[:, None, :], -1.0, 1.0
                ),
                0.0,
            )
            d2 = (
                sn[:, None, :] ** 2
                + q_dist[:, :, None] ** 2
                - 2.0 * sn[:, None, :] * q_dist[:, :, None] * q_dot_v
            )
            d = jnp.sqrt(jnp.maximum(d2, 0.0))
        elif mode in ("hamming", "binary_asym"):
            # packed uint32; pad bits are 0 on both sides so the ±1
            # identity over w·32 lanes is exact hamming
            nbits = storage.shape[1] * 32
            x_pm = unpack_pm1(cells.reshape(S * cap, -1), nbits).reshape(
                S, cap, nbits
            )
            if mode == "hamming":
                q_pm = unpack_pm1(
                    qg.reshape(S * maxq, -1), nbits
                ).reshape(S, maxq, nbits)
                dot = dots_of(q_pm, x_pm)
                d = (jnp.float32(nbits) - dot) * 0.5
            else:
                dot = dots_of(qg.astype(jnp.bfloat16), x_pm)
                d = -dot
        elif mode == "sq8":
            dots = dots_of(qg, cells, pref=jnp.int32).astype(jnp.float32)
            if metric == Dist.COSINE:
                denom = (
                    jnp.sqrt(q_sq[qid_safe])[:, :, None]
                    * jnp.sqrt(sn)[:, None, :]
                )
                d = jnp.where(denom > 0, 1.0 - dots / denom, 1.0)
            else:
                d = jnp.maximum(
                    q_sq[qid_safe][:, :, None] + sn[:, None, :] - 2.0 * dots,
                    0.0,
                )
        else:  # f32 / bf16 dense vectors (bf16 rows widen exactly to f32,
            # so distances are f32-exact over the stored rows)
            dots = dots_of(qg, cells.astype(jnp.float32), prec_f32)
            if metric == Dist.COSINE:
                d = 1.0 - dots
            else:
                d = jnp.maximum(
                    q_sq[qid_safe][:, :, None] + sn[:, None, :] - 2.0 * dots,
                    0.0,
                )

        d = jnp.where(valid, d, _INF)
        d2 = d.reshape(S * maxq, cap)
        if approx:
            cd, ci = jax.lax.approx_min_k(d2, kc)
        else:
            ncd, ci = jax.lax.top_k(-d2, kc)
            cd = -ncd
        gi = (
            jnp.repeat(starts, maxq)[:, None] + ci
        )                                            # [S·maxq, kc]
        return 0, (cd, gi)

    _, (ds, gs) = jax.lax.scan(step, 0, jnp.arange(n_steps))
    flat_d = ds.reshape(-1, kc)                      # [ncl_pad·maxq, kc]
    flat_i = gs.reshape(-1, kc)

    # regroup lanes per query (pad lanes -1 → +inf) and take the final top-k.
    # NOTE: ``mode="fill"`` only fills for indices ≥ size — NEGATIVE indices
    # wrap to the array tail (XLA gather semantics), so a -1 pad lane would
    # silently inject the LAST scan lane's results into every short query
    # row; remap pads to ``size`` (a true out-of-bounds index) first.
    gm = jnp.where(gather_map < 0, flat_d.shape[0], gather_map)
    gd = jnp.take(flat_d, gm, axis=0, mode="fill", fill_value=float("inf"))
    gi2 = jnp.take(flat_i, gm, axis=0, mode="fill", fill_value=0)
    gd = gd.reshape(nq, -1)
    gi2 = gi2.reshape(nq, -1)
    kk = min(k, gd.shape[1])
    nd, pos = jax.lax.top_k(-gd, kk)
    best_i = jnp.take_along_axis(gi2, pos, axis=-1)
    best_d = -nd
    if kk < k:  # tiny indexes: pad out to k with inf/0
        best_d = jnp.concatenate(
            [best_d, jnp.full((nq, k - kk), _INF, jnp.float32)], axis=-1
        )
        best_i = jnp.concatenate(
            [best_i, jnp.zeros((nq, k - kk), jnp.int32)], axis=-1
        )
    return best_d, best_i
