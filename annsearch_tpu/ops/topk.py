"""Running top-k over database tiles.

JAX replacement for the reference's per-query heaps
(``src/utils/heap_structs.rs`` — ``BinaryHeap`` / ``SortedBuffer``) and its GPU
top-k kernels (``src/gpu/dist_gpu.rs:245-512`` — ``extract_topk`` /
``extract_topk_coalesced``): instead of sequential insertion per thread we
scan the database in tensor-core-sized tiles and carry a running ``[bq, k]``
(distance, index) state, merging each tile's local top-k with ``lax.top_k``.
This is the reference's ``query_batch_gpu`` streaming design
(dist_gpu.rs:533-705) expressed as a ``lax.scan`` so XLA fuses the distance
matmul and keeps the carry on chip.

All top-k results are sorted ascending by distance (reference semantics:
sorted output, ``k = min(k, n)`` clamp done by callers).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..utils.dist import Dist, pairwise_dist, sq_norms

__all__ = [
    "topk_smallest",
    "merge_topk",
    "chunked_topk",
    "chunked_topk_bins",
    "blocked_query_topk",
    "DEFAULT_DB_CHUNK",
    "DEFAULT_QUERY_BLOCK",
]

# Tile sizes (the reference GPU layer uses QUERY_CHUNK_SIZE=8192 /
# DB_CHUNK_SIZE=16384, gpu/mod.rs:17-21): the distance tile
# [query_block, db_chunk] stays bounded in memory but wide enough to keep
# the matrix units busy. Not yet tuned on the GPU.
DEFAULT_DB_CHUNK = 16384
DEFAULT_QUERY_BLOCK = 1024

_INF = jnp.float32(jnp.inf)


def topk_smallest(d: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """Exact top-k smallest along the last axis, ascending. Returns (vals, idx)."""
    neg, idx = jax.lax.top_k(-d, k)
    return -neg, idx


def merge_topk(
    d_a: jax.Array,
    i_a: jax.Array,
    d_b: jax.Array,
    i_b: jax.Array,
    k: int,
) -> tuple[jax.Array, jax.Array]:
    """Merge two (dists, idx) top-k sets along the last axis → best k ascending."""
    d = jnp.concatenate([d_a, d_b], axis=-1)
    i = jnp.concatenate([i_a, i_b], axis=-1)
    vals, pos = topk_smallest(d, k)
    return vals, jnp.take_along_axis(i, pos, axis=-1)


def _pad_rows(x: jax.Array, multiple: int) -> jax.Array:
    n = x.shape[0]
    pad = (-n) % multiple
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)
    return x


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "db_chunk", "precision", "approx"),
)
def chunked_topk(
    q: jax.Array,
    x: jax.Array,
    k: int,
    metric: Dist,
    x_sqnorm: jax.Array | None = None,
    n_valid: int | jax.Array | None = None,
    db_chunk: int = DEFAULT_DB_CHUNK,
    precision=jax.lax.Precision.HIGHEST,
    approx: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Top-k nearest database rows for a block of queries.

    Args:
      q: ``[bq, d]`` query block (pre-normalised if cosine).
      x: ``[n, d]`` database (pre-normalised if cosine).
      k: neighbours to return (must be ≤ n; callers clamp).
      metric: distance metric.
      x_sqnorm: optional precomputed squared norms of ``x`` (euclidean only).
      n_valid: number of valid database rows (rows ≥ n_valid are padding).
      db_chunk: database tile size for the scan.
      approx: use ``lax.approx_min_k`` for the per-tile selection (slightly
        lossy — never used for ground-truth paths).

    Returns:
      ``(dists [bq, k], indices [bq, k])`` ascending by distance.
    """
    n = x.shape[0]
    if n_valid is None:
        n_valid = n
    if metric == Dist.EUCLIDEAN and x_sqnorm is None:
        x_sqnorm = sq_norms(x)

    db_chunk = min(db_chunk, max(k, n))
    x = _pad_rows(x, db_chunk)
    if x_sqnorm is not None:
        x_sqnorm = _pad_rows(x_sqnorm, db_chunk)
    n_pad = x.shape[0]
    n_chunks = n_pad // db_chunk
    bq = q.shape[0]

    def select(d: jax.Array, kk: int):
        if approx:
            return jax.lax.approx_min_k(d, kk)
        return topk_smallest(d, kk)

    def step(carry, chunk_idx):
        best_d, best_i = carry
        base = chunk_idx * db_chunk
        xc = jax.lax.dynamic_slice_in_dim(x, base, db_chunk, axis=0)
        xs = (
            jax.lax.dynamic_slice_in_dim(x_sqnorm, base, db_chunk, axis=0)
            if x_sqnorm is not None
            else None
        )
        d = pairwise_dist(q, xc, metric, x_sqnorm=xs, precision=precision)
        # mask padding / out-of-range rows
        col = base + jax.lax.broadcasted_iota(jnp.int32, (1, db_chunk), 1)
        d = jnp.where(col < n_valid, d, _INF)
        kk = min(k, db_chunk)
        cd, ci = select(d, kk)
        md, mi = merge_topk(best_d, best_i, cd, base + ci, k)
        return (md, mi), None

    init = (
        jnp.full((bq, k), _INF, jnp.float32),
        jnp.zeros((bq, k), jnp.int32),
    )
    (best_d, best_i), _ = jax.lax.scan(step, init, jnp.arange(n_chunks))
    return best_d, best_i


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "bins", "precision"),
)
def chunked_topk_bins(
    q: jax.Array,
    x: jax.Array,
    k: int,
    metric: Dist,
    x_sqnorm: jax.Array | None = None,
    n_valid: int | jax.Array | None = None,
    bins: int = 4096,
    precision=jax.lax.Precision.DEFAULT,
) -> tuple[jax.Array, jax.Array]:
    """Selection-free running top-k: the bins/partial-reduce design.

    The database is scanned in tiles of width ``bins``; column-residue class
    j (one "bin") keeps its best TWO distances with a pure elementwise
    min-update — NO per-tile sort or top-k at all (the per-tile
    ``lax.top_k`` is what dominates the exact scan's runtime). One final
    exact top-k over the ``[bq, 2·bins]`` bin minima returns the answer.

    Approximation: a true top-k entry is lost only when ≥3 of the true
    top-k share one bin — probability ~ (k choose 3)/bins² (≈1e-5 at k=15,
    bins=4096). This is the partial-reduce idea behind ``lax.approx_min_k``,
    applied *across* DB tiles so the whole scan is matmul + elementwise.
    """
    n = x.shape[0]
    if n_valid is None:
        n_valid = n
    if metric == Dist.EUCLIDEAN and x_sqnorm is None:
        x_sqnorm = sq_norms(x)

    bins = min(bins, max(128, n))
    x = _pad_rows(x, bins)
    if x_sqnorm is not None:
        x_sqnorm = _pad_rows(x_sqnorm, bins)
    n_chunks = x.shape[0] // bins
    bq = q.shape[0]

    def step(carry, ci):
        m1, i1, m2, i2 = carry
        base = ci * bins
        xc = jax.lax.dynamic_slice_in_dim(x, base, bins, 0)
        xs = (
            jax.lax.dynamic_slice_in_dim(x_sqnorm, base, bins, 0)
            if x_sqnorm is not None
            else None
        )
        d = pairwise_dist(q, xc, metric, x_sqnorm=xs, precision=precision)
        col = base + jax.lax.broadcasted_iota(jnp.int32, (1, bins), 1)
        d = jnp.where(col < n_valid, d, _INF)
        colb = jnp.broadcast_to(col, d.shape)
        b1 = d < m1
        nm1 = jnp.where(b1, d, m1)
        ni1 = jnp.where(b1, colb, i1)
        spill = jnp.where(b1, m1, d)          # displaced or non-best value
        spi = jnp.where(b1, i1, colb)
        b2 = spill < m2
        nm2 = jnp.where(b2, spill, m2)
        ni2 = jnp.where(b2, spi, i2)
        return (nm1, ni1, nm2, ni2), None

    init = (
        jnp.full((bq, bins), _INF, jnp.float32),
        jnp.zeros((bq, bins), jnp.int32),
        jnp.full((bq, bins), _INF, jnp.float32),
        jnp.zeros((bq, bins), jnp.int32),
    )
    (m1, i1, m2, i2), _ = jax.lax.scan(step, init, jnp.arange(n_chunks))
    all_d = jnp.concatenate([m1, m2], axis=-1)
    all_i = jnp.concatenate([i1, i2], axis=-1)
    kk = min(k, all_d.shape[1])
    nd, pos = jax.lax.top_k(-all_d, kk)
    return -nd, jnp.take_along_axis(all_i, pos, axis=-1)


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "metric", "query_block", "db_chunk", "precision", "approx",
        "selector",
    ),
)
def blocked_query_topk(
    q: jax.Array,
    x: jax.Array,
    k: int,
    metric: Dist,
    x_sqnorm: jax.Array | None = None,
    n_valid: int | None = None,
    query_block: int = DEFAULT_QUERY_BLOCK,
    db_chunk: int = DEFAULT_DB_CHUNK,
    precision=jax.lax.Precision.HIGHEST,
    approx: bool = False,
    selector: str = "exact",   # "exact" | "approx" | "bins"
) -> tuple[jax.Array, jax.Array]:
    """Top-k for an arbitrary number of queries.

    Streams query blocks through :func:`chunked_topk` (``lax.map`` — one
    compiled program reused per block) so ``[nq, n]`` is never materialised;
    this is the batched analogue of the reference's query-chunk × db-chunk
    double loop (dist_gpu.rs:550-685). ``selector="bins"`` swaps in the
    selection-free running-bins scan.
    """
    nq = q.shape[0]
    qb = min(query_block, max(nq, 8))
    qp = _pad_rows(q, qb)
    blocks = qp.reshape(-1, qb, q.shape[1])

    def run(block):
        if selector == "bins":
            return chunked_topk_bins(
                block,
                x,
                k,
                metric,
                x_sqnorm=x_sqnorm,
                n_valid=n_valid,
                bins=min(db_chunk, 2048),
                precision=precision,
            )
        return chunked_topk(
            block,
            x,
            k,
            metric,
            x_sqnorm=x_sqnorm,
            n_valid=n_valid,
            db_chunk=db_chunk,
            precision=precision,
            approx=approx or selector == "approx",
        )

    d, i = jax.lax.map(run, blocks)
    d = d.reshape(-1, k)[:nq]
    i = i.reshape(-1, k)[:nq]
    return d, i
