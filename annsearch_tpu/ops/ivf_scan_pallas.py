"""Fused IVF cell-scan kernel (Pallas, Triton route).

The XLA cluster scan (``ops/ivf_scan.py``) writes every ``[maxq, cap]``
distance tile to device memory and reads it back for a ``top_k``; on a
memory-bound scan that round trip is the largest byte stream. This kernel
keeps the tile on chip: one grid block owns one scan row (a cell segment and
the padded list of queries that probe it) and ``_BQ`` of those queries. It
gathers its queries, walks the cell in ``_BS``-row chunks — one ``pl.dot``
per chunk, the metric epilogue, then a fold of the chunk into per-residue
-class (best, runner-up) survivors held in registers — and after the cell
extracts ``kb`` candidates per query. Only ``[maxq, kb]`` per row reaches
device memory. Each cell is read once per block of queries that probes it:
the task-list design of the reference's GPU IVF path
(``src/gpu/ivf_gpu.rs:575-697``).

Selection is approximate-with-recovery: the fold keeps the best two rows of
each residue class mod ``_BS``, ``kb ≥ k`` candidates per (query, task)
survive, and the final cross-task top-k outside the kernel is exact — the
quality of ``lax.approx_min_k`` per-cell selection (the XLA scan's
``approx=True`` mode).

Cells are read in place from the cluster-sorted storage (rows
``seg_offsets[s] .. + seg_counts[s]``); the storage carries at least
``seg_size`` trailing pad rows, so a chunk never reads past its end.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..utils.dist import Dist

__all__ = ["fused_eligible", "fused_ivf_scan"]

#: queries per grid block, cell rows per chunk (= the fold's residue
#: classes), warps per block and software-pipeline stages — chosen on an
#: H100 at the 1M×128d IVF-PQ shape (8 warps beat 4 by ~1.6×; BQ 64 beat
#: 32 and 128; stage count moved the time by a few per cent)
_BQ = 64
_BS = 128
_NUM_WARPS = 8
_NUM_STAGES = 1
#: finite "masked" sentinel inside the kernel; mapped to +inf on the way out
_BIG = 3.0e38


def _on_gpu() -> bool:
    return jax.default_backend() == "gpu"


def fused_eligible(mode: str, seg_size: int, dim_w: int, k: int) -> bool:
    """Whether a scan takes the fused kernel: on a GPU only (every other
    backend takes the XLA scan), for dense-row storage (one matmul per
    chunk) whose row width is a power of two in [16, 256] (the kernel's
    tiles are powers of two, and a chunk of wider rows outgrows a block's
    shared memory), with segments a multiple of the chunk and ``k`` within
    the extraction width. ``ANNSEARCH_NO_PALLAS=1`` forces the XLA scan."""
    if os.environ.get("ANNSEARCH_NO_PALLAS") or not _on_gpu():
        return False
    return (
        mode in ("f32", "bf16", "i8dec", "i8dec_residual", "sq8")
        and 16 <= dim_w <= 256
        and dim_w & (dim_w - 1) == 0
        and seg_size % _BS == 0
        and k <= _BS
    )


def _scan_kernel(
    starts_ref,   # [R] int32 first storage row of each scan row's segment
    counts_ref,   # [R] int32 valid rows of that segment (0 = sentinel row)
    lists_ref,    # [BQ] int32 query ids of this block (pad = nq)
    q_ref,        # [nq+1, d] f32 queries (row nq = zeros)
    qn_ref,       # [nq+1] f32 per-query additive term
    cent_ref,     # [d] f32 this row's centroid (residual modes)
    scales_ref,   # [d] f32 per-dim decode scales (i8dec modes)
    x_ref,        # [n_pad, d] cell storage (f32 / bf16 / int8)
    sn_ref,       # [n_pad] row norms in the scoring space
    cd_ref,       # [BQ, kb] f32 out
    ci_ref,       # [BQ, kb] int32 out (row within the segment)
    *,
    epilogue: str,
    residual: bool,
    scaled: bool,
    f32_dot: bool,
    kb: int,
):
    r = pl.program_id(0)
    start = starts_ref[r]
    cnt = counts_ref[r]
    qids = lists_ref[...]
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, q_ref.shape[1]), 1)
    q = plt.load(q_ref.at[qids[:, None], cols])          # [BQ, d] gather
    if residual:
        c = cent_ref[...][None, :]
        if epilogue == "l2":
            q = q - c
            qadd = jnp.sum(q * q, axis=1)
        else:
            qadd = jnp.sum(q * c, axis=1)
    else:
        qadd = plt.load(qn_ref.at[qids])
    if scaled:
        q = q * scales_ref[...][None, :]
    op_dtype = jnp.float32 if f32_dot else jnp.bfloat16
    q = q.astype(op_dtype)
    prec = jax.lax.Precision.HIGHEST if f32_dot else None

    bq = q.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (bq, _BS), 1)

    def chunk(c, carry):
        v1, i1, v2, i2 = carry
        row0 = start + c * _BS
        x = plt.load(x_ref.at[pl.ds(row0, _BS), :]).astype(op_dtype)
        sn = plt.load(sn_ref.at[pl.ds(row0, _BS)]).astype(jnp.float32)
        dots = pl.dot(q, x, trans_b=True, precision=prec)  # [BQ, BS]
        sn = sn[None, :]
        if epilogue == "l2":
            dist = jnp.maximum(qadd[:, None] + sn - 2.0 * dots, 0.0)
        elif epilogue == "cos_renorm":
            dist = 1.0 - (dots + qadd[:, None]) * jax.lax.rsqrt(
                jnp.maximum(sn, 1e-12)
            )
        elif epilogue == "cos_qnorm":
            dist = 1.0 - dots * qadd[:, None] * jax.lax.rsqrt(
                jnp.maximum(sn, 1e-12)
            )
        else:  # cos_plain: rows pre-normalised
            dist = 1.0 - dots
        ni = c * _BS + lane
        dist = jnp.where(ni < cnt, dist, _BIG)
        # depth-2 residue-class fold: on clustered data a query's top-k
        # concentrates in one cell, and a single survivor per class would
        # lose every pair of top-k rows that collide mod _BS
        upd = dist < v1
        lose_v = jnp.where(upd, v1, dist)
        lose_i = jnp.where(upd, i1, ni)
        v1 = jnp.where(upd, dist, v1)
        i1 = jnp.where(upd, ni, i1)
        upd2 = lose_v < v2
        v2 = jnp.where(upd2, lose_v, v2)
        i2 = jnp.where(upd2, lose_i, i2)
        return v1, i1, v2, i2

    big = jnp.full((bq, _BS), _BIG, jnp.float32)
    zero = jnp.zeros((bq, _BS), jnp.int32)
    n_chunks = (cnt + _BS - 1) // _BS
    v1, i1, v2, i2 = jax.lax.fori_loop(
        0, n_chunks, chunk, (big, zero, big, zero)
    )

    # kb min-extractions over the 2·_BS survivors; each row index sits in
    # at most one survivor slot, so (value, index) identifies it
    no_idx = jnp.int32(2**30)
    for t in range(kb):
        m = jnp.minimum(jnp.min(v1, axis=1), jnp.min(v2, axis=1))
        hit1 = v1 == m[:, None]
        hit2 = v2 == m[:, None]
        li = jnp.minimum(
            jnp.min(jnp.where(hit1, i1, no_idx), axis=1),
            jnp.min(jnp.where(hit2, i2, no_idx), axis=1),
        )
        cd_ref[:, t] = m
        ci_ref[:, t] = li
        v1 = jnp.where(hit1 & (i1 == li[:, None]), _BIG, v1)
        v2 = jnp.where(hit2 & (i2 == li[:, None]), _BIG, v2)


@functools.partial(
    jax.jit,
    static_argnames=(
        "kb", "epilogue", "residual", "scaled", "f32_dot", "interpret",
    ),
)
def _cell_scan(
    starts: jax.Array,    # [R] int32
    counts: jax.Array,    # [R] int32
    lists: jax.Array,     # [R, maxq] int32
    q: jax.Array,         # [nq+1, d] f32
    qn: jax.Array,        # [nq+1] f32
    cent: jax.Array,      # [R, d] f32
    scales: jax.Array,    # [d] f32
    storage: jax.Array,   # [n_pad, d]
    sqnorms: jax.Array,   # [n_pad]
    *,
    kb: int,
    epilogue: str,
    residual: bool,
    scaled: bool,
    f32_dot: bool,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """``[R, maxq, kb]`` (distances ascending, rows within the segment)."""
    R, maxq = lists.shape
    d = q.shape[1]
    bq = min(_BQ, maxq)
    whole = pl.BlockSpec(memory_space=None)
    kern = functools.partial(
        _scan_kernel, epilogue=epilogue, residual=residual, scaled=scaled,
        f32_dot=f32_dot, kb=kb,
    )
    return pl.pallas_call(
        kern,
        grid=(R, pl.cdiv(maxq, bq)),
        in_specs=[
            whole,
            whole,
            pl.BlockSpec((None, bq), lambda r, b: (r, b)),
            whole,
            whole,
            pl.BlockSpec((None, d), lambda r, b: (r, 0)),
            whole,
            whole,
            whole,
        ],
        out_specs=[
            pl.BlockSpec((None, bq, kb), lambda r, b: (r, b, 0)),
            pl.BlockSpec((None, bq, kb), lambda r, b: (r, b, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((R, maxq, kb), jnp.float32),
            jax.ShapeDtypeStruct((R, maxq, kb), jnp.int32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES
        ),
        interpret=interpret,
        name="ivf_cell_scan",
    )(starts, counts, lists, q, qn, cent, scales, storage, sqnorms)


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "mode", "kb", "q_split", "groups",
                     "interpret"),
)
def fused_ivf_scan(
    queries: jax.Array,       # [nq, d] f32 (int8 for sq8) effective queries
    cluster_ids: jax.Array,   # [R] int segment ids (pad = nseg)
    probe_lists: jax.Array,   # [R, maxq] int query ids (pad = nq)
    gather_map: jax.Array,    # [nq, T] int32 flat scan lanes (pad = -1)
    storage: jax.Array,       # [n_pad, d] cluster-sorted cells
    sqnorms: jax.Array,       # [n_pad] row norms in the scoring space
    seg_offsets: jax.Array,   # [nseg] int32 first row of each segment
    seg_counts: jax.Array,    # [nseg] int32
    seg_centroids: jax.Array, # [nseg, d] f32 (scoring space)
    k: int,
    metric: Dist,
    mode: str,
    scales: jax.Array | None, # [d] f32 decode scales (i8dec modes)
    kb: int,
    q_split: bool = True,
    groups: int = 1,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Fused-kernel replacement for ``ivf_cluster_scan`` (approx selection).

    Scoring precision: ``f32`` cells take an f32 product (IEEE, as the XLA
    scan's HIGHEST); bf16 / int8 cells take one bf16 pass (their values are
    exact in bf16) with the queries rounded to bf16, except that
    ``q_split=True`` keeps i8dec queries in f32 as well.

    ``groups > 1`` splits each query's ``T`` task lanes into ``groups``
    equal runs (T must divide) and takes an independent top-k per run —
    the forest path's per-tree merge. Output is then ``[nq, groups·k]``,
    group-major.

    Returns ``(best_d, best_i)`` of shape ``[nq, k]`` ascending (or
    ``[nq, groups·k]``), with ``best_i`` positions in the sorted storage.
    """
    nq, d = queries.shape
    nseg = seg_offsets.shape[0]

    def ext(a, fill=0):
        return jnp.concatenate([a, jnp.full((1,) + a.shape[1:], fill, a.dtype)])

    qf = ext(queries.astype(jnp.float32))                      # [nq+1, d]
    offs_x = ext(seg_offsets.astype(jnp.int32))
    cnts_x = ext(seg_counts.astype(jnp.int32))
    cid = jnp.minimum(cluster_ids.astype(jnp.int32), nseg)     # [R]
    lists = jnp.minimum(probe_lists.astype(jnp.int32), nq)     # [R, maxq]
    starts = offs_x[cid]

    residual = mode == "i8dec_residual"
    scaled = mode in ("i8dec", "i8dec_residual")
    q_sq = jnp.sum(qf * qf, axis=-1)
    if mode.startswith("i8dec"):
        epilogue = "cos_renorm" if metric == Dist.COSINE else "l2"
        qn = jnp.zeros_like(q_sq) if metric == Dist.COSINE else q_sq
    elif mode == "sq8":
        # integer-space cosine: qn carries 1/‖q‖ (0 for a zero query)
        if metric == Dist.COSINE:
            qn = jnp.where(
                q_sq > 0, jax.lax.rsqrt(jnp.maximum(q_sq, 1e-12)), 0.0
            )
            epilogue = "cos_qnorm"
        else:
            qn, epilogue = q_sq, "l2"
    else:  # f32 / bf16 dense rows
        epilogue = "cos_plain" if metric == Dist.COSINE else "l2"
        qn = q_sq
    cent = (
        ext(seg_centroids.astype(jnp.float32))[cid]
        if residual else jnp.zeros((cid.shape[0], d), jnp.float32)
    )
    sc = (
        scales.astype(jnp.float32) if scaled
        else jnp.ones((d,), jnp.float32)
    )
    f32_dot = mode == "f32" or (q_split and scaled)
    cd, ci = _cell_scan(
        starts, cnts_x[cid], lists, qf, qn, cent, sc, storage, sqnorms,
        kb=kb, epilogue=epilogue, residual=residual, scaled=scaled,
        f32_dot=f32_dot, interpret=interpret,
    )
    cd = jnp.where(cd >= _BIG, jnp.inf, cd)
    gi = starts[:, None, None] + ci                            # storage rows

    flat_d = cd.reshape(-1, kb)
    flat_i = gi.reshape(-1, kb)
    # pad lanes (-1) must map to a true out-of-bounds index: ``mode="fill"``
    # wraps negative indices to the array tail instead of filling
    gm = jnp.where(gather_map < 0, flat_d.shape[0], gather_map)
    gd = jnp.take(
        flat_d, gm, axis=0, mode="fill", fill_value=float("inf")
    ).reshape(nq, -1)
    gi2 = jnp.take(flat_i, gm, axis=0, mode="fill", fill_value=0).reshape(
        nq, -1
    )
    if groups > 1:
        gd = gd.reshape(nq * groups, -1)
        gi2 = gi2.reshape(nq * groups, -1)
    kk = min(k, gd.shape[1])
    nd, pos = jax.lax.top_k(-gd, kk)
    best_i = jnp.take_along_axis(gi2, pos, axis=-1)
    best_d = -nd
    if kk < k:
        best_d = jnp.concatenate(
            [best_d,
             jnp.full((best_d.shape[0], k - kk), jnp.inf, jnp.float32)],
            axis=-1,
        )
        best_i = jnp.concatenate(
            [best_i, jnp.zeros((best_i.shape[0], k - kk), jnp.int32)],
            axis=-1,
        )
    if groups > 1:
        best_d = best_d.reshape(nq, -1)
        best_i = best_i.reshape(nq, -1)
    return best_d, best_i
