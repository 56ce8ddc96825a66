"""Quantised distance scan kernels: bf16, int8 (SQ8), and PQ codes.

Replaces the reference's quantised SIMD kernels (``utils/dist.rs`` —
``euclidean_bf16_simd`` :2376-4010, ``VectorDistanceSq8`` :4228-4324,
``VectorDistanceAdc`` :4333-4495) with tensor-core matmul scans:

  * bf16  — the tensor cores' native dtype; dot in bf16, accumulate f32.
  * SQ8   — int8×int8→int32 matmul; distances in quantised integer space
            (exact reference semantics: scales ignored at query time).
  * PQ    — **decode-by-one-hot-matmul**: instead of the reference's ADC
            LUT-gather scan (dist.rs:4447, unrolled u8 gathers — fast on CPU,
            scattered reads on an accelerator), each code tile is decoded on
            the fly with per-subspace one-hot × codebook matmuls and scored
            with a dense distance matmul. Mathematically identical to ADC
            (d(q, x̂) over the same reconstruction x̂); decode FLOPs are
            ~256/bq of the scoring matmul, so the tensor cores stay
            saturated.

All kernels stream DB tiles with the same running top-k carry as
``ops/topk.py``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..utils.dist import Dist, sq_norms
from .topk import merge_topk

__all__ = ["chunked_topk_bf16", "chunked_topk_sq8", "chunked_topk_pq", "pq_decode_tile"]

_INF = jnp.float32(jnp.inf)


def _pad_rows(x, multiple):
    n = x.shape[0]
    pad = (-n) % multiple
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)
    return x


def _run_tiles(step, n_chunks, bq, k):
    init = (
        jnp.full((bq, k), _INF, jnp.float32),
        jnp.zeros((bq, k), jnp.int32),
    )
    (d, i), _ = jax.lax.scan(step, init, jnp.arange(n_chunks))
    return d, i


@functools.partial(jax.jit, static_argnames=("k", "metric", "db_chunk"))
def chunked_topk_bf16(
    q: jax.Array,          # [bq, d] f32 (normalised if cosine)
    x: jax.Array,          # [n, d] bf16 (normalised-then-cast if cosine)
    x_sqnorm: jax.Array,   # [n] f32 (‖decode(x)‖², euclidean only)
    k: int,
    metric: Dist,
    n_valid,
    db_chunk: int = 16384,
) -> tuple[jax.Array, jax.Array]:
    """Top-k over bf16 storage; query cast to bf16, f32 accumulation
    (reference mixed bf16×f32 kernels, dist.rs:2376-4010)."""
    x = _pad_rows(x, db_chunk)
    x_sqnorm = _pad_rows(x_sqnorm, db_chunk)
    n_chunks = x.shape[0] // db_chunk
    bq = q.shape[0]
    q16 = q.astype(jnp.bfloat16)
    q_sq = sq_norms(q)

    def step(carry, ci):
        base = ci * db_chunk
        xc = jax.lax.dynamic_slice_in_dim(x, base, db_chunk, 0)
        xs = jax.lax.dynamic_slice_in_dim(x_sqnorm, base, db_chunk, 0)
        dots = jax.lax.dot_general(
            q16, xc, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        if metric == Dist.COSINE:
            d = 1.0 - dots
        else:
            d = jnp.maximum(q_sq[:, None] + xs[None, :] - 2.0 * dots, 0.0)
        col = base + jax.lax.broadcasted_iota(jnp.int32, (1, db_chunk), 1)
        d = jnp.where(col < n_valid, d, _INF)
        cd, cidx = jax.lax.top_k(-d, min(k, db_chunk))
        return merge_topk(carry[0], carry[1], -cd, base + cidx, k), None

    return _run_tiles(step, n_chunks, bq, k)


@functools.partial(jax.jit, static_argnames=("k", "metric", "db_chunk"))
def chunked_topk_sq8(
    q_i8: jax.Array,        # [bq, d] int8 (quantised query)
    codes: jax.Array,       # [n, d] int8
    code_sqnorm: jax.Array, # [n] int32 (Σ c², quantised space)
    k: int,
    metric: Dist,
    n_valid,
    db_chunk: int = 16384,
) -> tuple[jax.Array, jax.Array]:
    """Integer-space distance scan (reference VectorDistanceSq8 semantics:
    euclidean = Σ(q̂−ĉ)², cosine = 1 − dot/(‖q̂‖‖ĉ‖), all in int space)."""
    codes = _pad_rows(codes, db_chunk)
    code_sqnorm = _pad_rows(code_sqnorm, db_chunk)
    n_chunks = codes.shape[0] // db_chunk
    bq = q_i8.shape[0]
    q_sq = jnp.sum(
        q_i8.astype(jnp.int32) * q_i8.astype(jnp.int32), axis=-1
    )  # [bq] i32

    def step(carry, ci):
        base = ci * db_chunk
        xc = jax.lax.dynamic_slice_in_dim(codes, base, db_chunk, 0)
        xs = jax.lax.dynamic_slice_in_dim(code_sqnorm, base, db_chunk, 0)
        dots = jax.lax.dot_general(
            q_i8, xc, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        if metric == Dist.COSINE:
            qn = jnp.sqrt(q_sq.astype(jnp.float32))[:, None]
            cn = jnp.sqrt(xs.astype(jnp.float32))[None, :]
            denom = qn * cn
            d = jnp.where(
                denom > 0, 1.0 - dots.astype(jnp.float32) / denom, 1.0
            )
        else:
            d = (
                q_sq[:, None] + xs[None, :] - 2 * dots
            ).astype(jnp.float32)
            d = jnp.maximum(d, 0.0)
        col = base + jax.lax.broadcasted_iota(jnp.int32, (1, db_chunk), 1)
        d = jnp.where(col < n_valid, d, _INF)
        cd, cidx = jax.lax.top_k(-d, min(k, db_chunk))
        return merge_topk(carry[0], carry[1], -cd, base + cidx, k), None

    return _run_tiles(step, n_chunks, bq, k)


def pq_decode_tile(codes_tile: jax.Array, codebooks: jax.Array) -> jax.Array:
    """Decode a ``[t, m]`` uint8 code tile to ``[t, d]`` via a batched
    one-hot × codebook einsum (a matrix-unit replacement for LUT gathers:
    XLA fuses the one-hot into one batched contraction instead of m
    separate [t,256]×[256,ds] products)."""
    t, m = codes_tile.shape
    # XLA:CPU lowers this batched contraction to a DotThunk with no
    # BF16×BF16→F32 kernel at narrow subspace widths ("Unsupported element
    # type for DotThunk::Execute"), so the CPU keeps f32 operands
    dt = jnp.float32 if jax.default_backend() == "cpu" else jnp.bfloat16
    oh = jax.nn.one_hot(codes_tile.astype(jnp.int32), 256, dtype=dt)
    dec = jnp.einsum(
        "tmc,mcs->tms",
        oh,
        codebooks.astype(dt),
        preferred_element_type=jnp.float32,
    )
    return dec.reshape(t, -1)  # [t, d] f32


@functools.partial(jax.jit, static_argnames=("k", "metric", "db_chunk"))
def chunked_topk_pq(
    q: jax.Array,            # [bq, d] f32 in codebook space (rotated for OPQ)
    codes: jax.Array,        # [n, m] uint8
    code_sqnorm: jax.Array,  # [n] f32 = ‖x̂‖²
    codebooks: jax.Array,    # [m, 256, d/m] f32
    k: int,
    metric: Dist,
    n_valid,
    db_chunk: int = 4096,
) -> tuple[jax.Array, jax.Array]:
    """ADC-equivalent top-k over PQ codes: decode tile on the fly, score
    with one dense matmul. ``d(q, x̂) = ‖q‖² + ‖x̂‖² − 2 q·x̂`` — identical to
    the reference's LUT ADC sum (dist.rs:4447) for the same reconstruction."""
    codes = _pad_rows(codes, db_chunk)
    code_sqnorm = _pad_rows(code_sqnorm, db_chunk)
    n_chunks = codes.shape[0] // db_chunk
    bq = q.shape[0]
    q_sq = sq_norms(q)
    q16 = q.astype(jnp.bfloat16)

    def step(carry, ci):
        base = ci * db_chunk
        ct = jax.lax.dynamic_slice_in_dim(codes, base, db_chunk, 0)
        sn = jax.lax.dynamic_slice_in_dim(code_sqnorm, base, db_chunk, 0)
        dec = pq_decode_tile(ct, codebooks)  # [t, d] f32
        dots = jax.lax.dot_general(
            q16, dec.astype(jnp.bfloat16), (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        if metric == Dist.COSINE:
            # x̂ is only approximately unit — normalise by ‖x̂‖
            d = 1.0 - dots / jnp.sqrt(jnp.maximum(sn, 1e-12))[None, :]
        else:
            d = jnp.maximum(q_sq[:, None] + sn[None, :] - 2.0 * dots, 0.0)
        col = base + jax.lax.broadcasted_iota(jnp.int32, (1, db_chunk), 1)
        d = jnp.where(col < n_valid, d, _INF)
        cd, cidx = jax.lax.top_k(-d, min(k, db_chunk))
        return merge_topk(carry[0], carry[1], -cd, base + cidx, k), None

    return _run_tiles(step, n_chunks, bq, k)
