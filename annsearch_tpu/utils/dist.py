"""Distance metric plumbing.

JAX replacement for the reference's SIMD distance layer
(ann-search-rs ``src/utils/dist.rs``): instead of runtime-dispatched
scalar/SSE/AVX kernels, every distance in this framework funnels into a single
tensor-core matmul identity

    euclidean²(q, x) = ‖q‖² + ‖x‖² − 2 q·x
    cosine(q, x)     = 1 − q·x / (‖q‖‖x‖)

Cosine-mode indexes store pre-normalised vectors so the cosine distance is a
plain ``1 − QXᵀ`` matmul (the reference instead keeps raw vectors plus a norm
array — same information, but renormalising up front keeps the hot path a
single GEMM; see reference ``src/cpu/kmknn.rs:147-153`` for precedent).

Semantics matched to the reference (``src/utils/dist.rs:27-54``):
  * ``euclidean`` is the *squared* L2 distance,
  * ``cosine`` is ``1 − similarity``,
  * unknown metric strings fall back to euclidean (reference uses
    ``unwrap_or_default()``).
"""

from __future__ import annotations

import enum

import jax
import jax.numpy as jnp

__all__ = [
    "Dist",
    "parse_ann_dist",
    "mantissa_split",
    "sq_norms",
    "norms",
    "normalise",
    "pairwise_sq_euclidean",
    "pairwise_cosine",
    "pairwise_dist",
]


class Dist(enum.Enum):
    """Supported distance metrics (reference ``Dist`` enum, dist.rs:27-33)."""

    EUCLIDEAN = "euclidean"
    COSINE = "cosine"


def parse_ann_dist(name: str) -> Dist:
    """Parse a metric string; falls back to euclidean like the reference
    (``parse_ann_dist`` + ``unwrap_or_default``, dist.rs:36-54, lib.rs:215)."""
    if isinstance(name, Dist):
        return name
    lowered = str(name).strip().lower()
    if lowered == "cosine":
        return Dist.COSINE
    return Dist.EUCLIDEAN


def mantissa_split(x: jax.Array, parts: int) -> tuple[jax.Array, ...]:
    """Split f32 into ``parts`` bf16 terms whose bf16-matmul passes sum to an
    (≈)f32-precision product: ``x ≈ Σ terms`` with ``terms[0]`` holding the
    top 8 mantissa bits, ``terms[1]`` the next 7, …

    The head terms are built by INTEGER mantissa masking (bitcast → zero the
    low 16 bits → bitcast), not ``astype(bfloat16)`` rounding. XLA
    compiles with excess-precision allowances that may keep a value rounded
    to bf16 at f32 precision, which silently folds the residual
    ``x − hi`` to ~0 and degrades a multi-pass split to single-pass
    accuracy. Integer ops cannot be elided, so the residual is
    exact; the masked value has a zeroed low mantissa and converts to bf16
    exactly.
    """
    terms = []
    r = x.astype(jnp.float32)
    for _ in range(parts - 1):
        # round-to-nearest-bf16 via integer add-then-mask (+0x8000 carries
        # into the exponent correctly at binade boundaries); truncation
        # alone would bias every residual positive, which shows up as a
        # systematic inflation of near-zero distances
        hi = jax.lax.bitcast_convert_type(
            (jax.lax.bitcast_convert_type(r, jnp.int32) + jnp.int32(0x8000))
            & jnp.int32(-65536),
            jnp.float32,
        )
        terms.append(hi.astype(jnp.bfloat16))
        r = r - hi
    terms.append(r.astype(jnp.bfloat16))
    return tuple(terms)


def sq_norms(x: jax.Array) -> jax.Array:
    """Row-wise squared L2 norms, f32 accumulate."""
    x = x.astype(jnp.float32)
    return jnp.sum(x * x, axis=-1)


def norms(x: jax.Array) -> jax.Array:
    """Row-wise L2 norms."""
    return jnp.sqrt(sq_norms(x))


def normalise(x: jax.Array, eps: float = 1e-30) -> jax.Array:
    """L2-normalise rows (zero rows stay zero)."""
    n = norms(x)
    return x / jnp.maximum(n, eps)[..., None]


def _matmul(q: jax.Array, x: jax.Array, precision) -> jax.Array:
    """Q · Xᵀ on the tensor cores with f32 accumulation."""
    return jax.lax.dot_general(
        q,
        x,
        dimension_numbers=(((q.ndim - 1,), (x.ndim - 1,)), ((), ())),
        precision=precision,
        preferred_element_type=jnp.float32,
    )


def pairwise_sq_euclidean(
    q: jax.Array,
    x: jax.Array,
    x_sqnorm: jax.Array | None = None,
    q_sqnorm: jax.Array | None = None,
    precision=jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """Squared euclidean distance matrix ``[nq, nx]``.

    ``‖q‖² + ‖x‖² − 2 q·x`` — the single-GEMM form the reference reaches via
    its k-means GEMM path (k_means_utils.rs:425-727); here it is *the* distance
    primitive for every index. Clamped at 0 to absorb cancellation error.
    """
    if x_sqnorm is None:
        x_sqnorm = sq_norms(x)
    if q_sqnorm is None:
        q_sqnorm = sq_norms(q)
    dots = _matmul(q, x, precision)
    d = q_sqnorm[..., :, None] + x_sqnorm[..., None, :] - 2.0 * dots
    return jnp.maximum(d, 0.0)


def pairwise_cosine(
    q_normed: jax.Array,
    x_normed: jax.Array,
    precision=jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """Cosine distance matrix ``1 − QXᵀ`` for *pre-normalised* inputs."""
    return 1.0 - _matmul(q_normed, x_normed, precision)


def pairwise_dist(
    q: jax.Array,
    x: jax.Array,
    metric: Dist,
    x_sqnorm: jax.Array | None = None,
    precision=jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """Distance matrix under ``metric``.

    For cosine, ``q`` and ``x`` must already be L2-normalised (indexes do this
    at build/query time).
    """
    if metric == Dist.COSINE:
        return pairwise_cosine(q, x, precision)
    return pairwise_sq_euclidean(q, x, x_sqnorm=x_sqnorm, precision=precision)
