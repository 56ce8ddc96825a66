"""k-means engine — the coarse-quantiser trainer behind IVF/kMkNN/PQ/RaBitQ.

JAX rebuild of the reference's k-means layer (``src/utils/k_means_utils.rs``).
The reference maintains four Lloyd variants (Hamerly+GEMM, Hamerly+SIMD,
GEMM-cosine, plain parallel — :961-1645) because on CPU the triangle-inequality
bookkeeping pays for itself. On matrix units it does not: a full GEMM
assignment each iteration is the fast path (SURVEY §7), so there is exactly one
Lloyd loop here — blocked distance matmul → argmin → ``segment_sum`` update —
jitted with ``lax.while_loop`` convergence on centroid shift.

Init strategies follow the reference's split (k_means_utils.rs:217-405):
k-means++ -style D² seeding for small k (≤200), random row picks for large k.
Mini-batch (Sculley) training for PQ codebooks lives in
:func:`train_centroids_minibatch` (reference ``quantised/k_means.rs``).
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.dist import Dist, normalise, pairwise_sq_euclidean, sq_norms

__all__ = [
    "train_centroids",
    "assign_clusters",
    "build_cells",
    "segment_layout",
    "expand_probes_to_segments",
    "KMEANS_SEED_CAP",
]

#: above this k, D²-seeding is replaced by random row picks
#: (reference switches at 200, k_means_utils.rs:1884)
KMEANS_SEED_CAP = 200

#: training-sample cap: min(256·k, 250k) rows (reference ivf.rs:158)
def train_sample_size(n: int, k: int) -> int:
    return min(n, min(256 * k, 250_000))


# ---------------------------------------------------------------------------
# assignment
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("chunk",))
def _assign_chunked(
    x: jax.Array,
    c: jax.Array,
    x_sqnorm: jax.Array,
    chunk: int = 65536,
) -> tuple[jax.Array, jax.Array]:
    """argmin_c ‖x − c‖² for every row, blocked over rows.

    Returns (assignment [n] int32, min squared distance [n] f32).
    """
    n = x.shape[0]
    pad = (-n) % chunk
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad, x.shape[1]), x.dtype)])
        x_sqnorm = jnp.concatenate([x_sqnorm, jnp.zeros((pad,), x_sqnorm.dtype)])
    c_sqnorm = sq_norms(c)

    def block(args):
        xb, xs = args
        d = (
            xs[:, None]
            + c_sqnorm[None, :]
            - 2.0
            * jax.lax.dot_general(
                xb,
                c,
                (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
        )
        return jnp.argmin(d, axis=1).astype(jnp.int32), jnp.maximum(
            d.min(axis=1), 0.0
        )

    xb = x.reshape(-1, chunk, x.shape[1])
    xs = x_sqnorm.reshape(-1, chunk)
    a, dmin = jax.lax.map(block, (xb, xs))
    return a.reshape(-1)[:n], dmin.reshape(-1)[:n]


def assign_clusters(
    x: jax.Array, centroids: jax.Array, metric: Dist, chunk: int = 65536
) -> tuple[jax.Array, jax.Array]:
    """Assign every row of ``x`` to its nearest centroid.

    For cosine, callers pass pre-normalised ``x``/centroids: nearest-by-dot
    equals nearest-by-euclidean on the unit sphere, so one code path serves
    both metrics (the reference's cosine trick in kmknn.rs:147-153).
    """
    return _assign_chunked(x, centroids, sq_norms(x), chunk=chunk)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _dsq_seed_init(
    key: jax.Array, x: jax.Array, k: int
) -> jax.Array:
    """D²-weighted sequential seeding (k-means++ flavour of the reference's
    k-means‖ oversampling init, k_means_utils.rs:217-373): k rounds, each
    picking a row with probability ∝ min-distance² to the chosen set."""
    n = x.shape[0]
    xs = sq_norms(x)

    k0, key = jax.random.split(key)
    first = jax.random.randint(k0, (), 0, n)
    centroids = jnp.zeros((k, x.shape[1]), x.dtype).at[0].set(x[first])
    dmin = jnp.sum((x - x[first]) ** 2, axis=1)

    def step(i, carry):
        centroids, dmin, key = carry
        key, kc = jax.random.split(key)
        # categorical over log-probs; guard the all-zero case
        logits = jnp.log(jnp.maximum(dmin, 1e-30))
        pick = jax.random.categorical(kc, logits)
        cnew = x[pick]
        centroids = centroids.at[i].set(cnew)
        d_new = xs + jnp.sum(cnew * cnew) - 2.0 * (x @ cnew)
        dmin = jnp.minimum(dmin, jnp.maximum(d_new, 0.0))
        return centroids, dmin, key

    centroids, _, _ = jax.lax.fori_loop(1, k, step, (centroids, dmin, key))
    return centroids


def _random_init(key: jax.Array, x: jax.Array, k: int) -> jax.Array:
    """Shuffle-pick k unique rows (reference fast_random_init :391-405)."""
    idx = jax.random.permutation(key, x.shape[0])[:k]
    return x[idx]


# ---------------------------------------------------------------------------
# Lloyd
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("k", "max_iters", "spherical", "chunk")
)
def _lloyd(
    x: jax.Array,
    init_centroids: jax.Array,
    k: int,
    max_iters: int,
    tol: float,
    spherical: bool,
    chunk: int = 65536,
) -> tuple[jax.Array, jax.Array]:
    """Full-GEMM Lloyd iterations with segment-sum updates.

    Empty clusters keep their previous centroid. ``spherical=True``
    renormalises centroids each iteration (cosine mode).
    Returns (centroids [k, d], iterations run).
    """
    xs = sq_norms(x)
    n = x.shape[0]

    def cond(carry):
        c, prev_shift, it = carry
        return jnp.logical_and(it < max_iters, prev_shift > tol)

    def body(carry):
        c, _, it = carry
        a, _ = _assign_chunked(x, c, xs, chunk=chunk)
        sums = jax.ops.segment_sum(x, a, num_segments=k)
        counts = jax.ops.segment_sum(jnp.ones((n,), jnp.float32), a, num_segments=k)
        new_c = jnp.where(
            counts[:, None] > 0, sums / jnp.maximum(counts, 1.0)[:, None], c
        )
        if spherical:
            new_c = normalise(new_c)
        shift = jnp.sum((new_c - c) ** 2)
        return new_c, shift, it + 1

    c, _, iters = jax.lax.while_loop(
        cond, body, (init_centroids, jnp.float32(jnp.inf), jnp.int32(0))
    )
    return c, iters


def train_centroids(
    x: jax.Array,
    k: int,
    metric: Dist = Dist.EUCLIDEAN,
    max_iters: int = 30,
    seed: int = 42,
    tol: float = 1e-4,
    sample: bool = True,
    chunk: int = 65536,
) -> jax.Array:
    """Train ``k`` centroids on (a sample of) ``x``.

    Mirrors the reference ``train_centroids`` driver
    (k_means_utils.rs:1860-1995): subsample to min(256k, 250k) rows, seed,
    run Lloyd. Cosine mode expects pre-normalised ``x`` and returns unit
    centroids (spherical k-means).
    """
    n = x.shape[0]
    k = min(k, n)
    key = jax.random.key(seed)

    if sample:
        m = train_sample_size(n, k)
        if m < n:
            key, ks = jax.random.split(key)
            idx = jax.random.choice(ks, n, (m,), replace=False)
            x_train = x[idx]
        else:
            x_train = x
    else:
        x_train = x

    key, ki = jax.random.split(key)
    if k <= KMEANS_SEED_CAP:
        init = _dsq_seed_init(ki, x_train, k)
    else:
        init = _random_init(ki, x_train, k)

    c, _ = _lloyd(
        x_train,
        init,
        k,
        max_iters,
        tol,
        spherical=(metric == Dist.COSINE),
        chunk=chunk,
    )
    return c


# ---------------------------------------------------------------------------
# mini-batch Lloyd (PQ codebooks; reference quantised/k_means.rs:14-334)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("k", "iters", "batch"))
def train_centroids_minibatch(
    x: jax.Array,
    init_centroids: jax.Array,
    k: int,
    iters: int = 20,
    batch: int = 10_240,
    seed: int = 42,
) -> jax.Array:
    """Sculley mini-batch k-means: per-centroid learning rate 1/count.

    Used for PQ sub-codebooks on large training sets where full Lloyd per
    sub-space is wasteful (reference mini-batch threshold n>10k,
    quantised/k_means.rs).
    """
    n = x.shape[0]
    key = jax.random.key(seed)
    xs = sq_norms(x)

    def step(carry, key_i):
        c, counts = carry
        idx = jax.random.randint(key_i, (batch,), 0, n)
        xb = x[idx]
        d = (
            xs[idx][:, None]
            + sq_norms(c)[None, :]
            - 2.0 * (xb @ c.T)
        )
        a = jnp.argmin(d, axis=1)
        bsum = jax.ops.segment_sum(xb, a, num_segments=k)
        bcnt = jax.ops.segment_sum(jnp.ones((batch,), jnp.float32), a, num_segments=k)
        counts = counts + bcnt
        lr = jnp.where(counts > 0, 1.0 / jnp.maximum(counts, 1.0), 0.0)
        mean_b = bsum / jnp.maximum(bcnt, 1.0)[:, None]
        c = jnp.where(
            bcnt[:, None] > 0,
            c + (mean_b - c) * (bcnt * lr)[:, None],
            c,
        )
        return (c, counts), None

    keys = jax.random.split(key, iters)
    (c, _), _ = jax.lax.scan(step, (init_centroids, jnp.zeros((k,), jnp.float32)), keys)
    return c


# ---------------------------------------------------------------------------
# padded cell layout (the reference's CSR, build_csr_layout :2012-2037,
# re-shaped for static shapes: fixed [nlist, cell_cap] member table + mask)
# ---------------------------------------------------------------------------


def build_cells(
    assignments: np.ndarray, nlist: int, cap_quantile: float = 1.0
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group row indices by cluster into a padded member table.

    Returns ``(members [nlist, cap] int32, counts [nlist] int32, order [n])``
    where ``members[c, j] = -1`` beyond ``counts[c]`` and ``order`` is the
    cluster-sorted permutation of row ids (the reference's
    ``optimise_memory_layout`` reorder, ivf.rs:407-444).

    ``cap_quantile < 1`` truncates pathologically large cells at that size
    quantile (imbalance control; truncated members are dropped from the
    padded table but kept in ``order``).
    """
    a = np.asarray(assignments, dtype=np.int64)
    n = a.shape[0]
    counts = np.bincount(a, minlength=nlist).astype(np.int32)
    order = np.argsort(a, kind="stable").astype(np.int32)

    if cap_quantile >= 1.0:
        cap = int(counts.max()) if n else 0
    else:
        cap = int(np.quantile(counts, cap_quantile)) if n else 0
    cap = max(cap, 1)

    members = np.full((nlist, cap), -1, dtype=np.int32)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    for c in range(nlist):
        m = min(int(counts[c]), cap)
        members[c, :m] = order[offsets[c] : offsets[c] + m]
    counts = np.minimum(counts, cap)
    return members, counts, order


class SegmentLayout:
    """Cluster-sorted storage split into bounded-size segments.

    Imbalanced cells make a padded cluster scan waste compute (the scan's
    static cell cap is the max cell size — measured 10-30× waste on skewed
    k-means layouts). Cells larger than ``seg_size`` are split into several
    segments sharing the owner cluster's centroid, so the scan cap is
    ``seg_size`` and padding waste is bounded. The reference hits the same
    irregularity with variable-length GPU task lists (ivf_gpu.rs:600-654);
    segments are the static-shape answer.

    Attributes:
      order:        [n] cluster-sorted permutation of row ids
      seg_offsets:  [nseg] int32 start of each segment in sorted order
      seg_counts:   [nseg] int32 valid rows per segment (≤ seg_size)
      seg_cluster:  [nseg] int32 owner cluster of each segment
      cluster_ptr:  [nlist+1] int32 CSR of segments per cluster
      seg_size:     static scan cap
    """

    def __init__(self, order, seg_offsets, seg_counts, seg_cluster,
                 cluster_ptr, seg_size, counts):
        self.order = order
        self.seg_offsets = seg_offsets
        self.seg_counts = seg_counts
        self.seg_cluster = seg_cluster
        self.cluster_ptr = cluster_ptr
        self.seg_size = seg_size
        self.counts = counts  # [nlist] full cell sizes

    @property
    def nseg(self) -> int:
        return len(self.seg_offsets)


def segment_layout(
    assignments: np.ndarray, nlist: int, seg_size: int | None = None
) -> SegmentLayout:
    """Build the segmented cell layout from cluster assignments."""
    a = np.asarray(assignments, dtype=np.int64)
    n = a.shape[0]
    counts = np.bincount(a, minlength=nlist).astype(np.int64)
    order = np.argsort(a, kind="stable").astype(np.int32)
    if seg_size is None:
        mean = max(1, n // max(nlist, 1))
        seg_size = 1 << int(np.ceil(np.log2(max(64, mean))))

    offsets = np.concatenate([[0], np.cumsum(counts)])
    seg_offsets, seg_counts, seg_cluster = [], [], []
    cluster_ptr = np.zeros(nlist + 1, np.int64)
    for c in range(nlist):
        cnt = int(counts[c])
        start = int(offsets[c])
        nseg_c = max(1, -(-cnt // seg_size)) if cnt > 0 else 0
        for s in range(nseg_c):
            seg_offsets.append(start + s * seg_size)
            seg_counts.append(min(seg_size, cnt - s * seg_size))
            seg_cluster.append(c)
        cluster_ptr[c + 1] = cluster_ptr[c] + nseg_c
    return SegmentLayout(
        order,
        np.asarray(seg_offsets, np.int32),
        np.asarray(seg_counts, np.int32),
        np.asarray(seg_cluster, np.int32),
        cluster_ptr,
        seg_size,
        counts.astype(np.int32),
    )


def expand_probes_to_segments(
    probes: np.ndarray, layout: SegmentLayout
) -> tuple[np.ndarray, np.ndarray]:
    """Expand [nq, nprobe] cluster probes into flat (query, segment) pairs."""
    probes = np.asarray(probes, dtype=np.int64)
    nq, nprobe = probes.shape
    flat_c = probes.reshape(-1)
    flat_q = np.repeat(np.arange(nq, dtype=np.int32), nprobe)
    spc = (layout.cluster_ptr[1:] - layout.cluster_ptr[:-1])  # segs/cluster
    reps = spc[flat_c]
    q_out = np.repeat(flat_q, reps)
    # segment ids: for each (q, c) pair, range(cluster_ptr[c], ...+reps)
    starts = layout.cluster_ptr[flat_c]
    total = int(reps.sum())
    # vectorised ragged-range: cumulative trick
    idx = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(reps)[:-1]]), reps
    )
    seg_out = (np.repeat(starts, reps) + idx).astype(np.int32)
    return q_out, seg_out
