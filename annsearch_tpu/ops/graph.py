"""Graph-index kernels: kNN-graph construction rounds + batched beam search.

JAX rebuild of the reference's graph machinery — CPU NNDescent
(``src/cpu/nndescent.rs``: candidate sampling, local joins, radix-sort
merges), GPU NNDescent (``src/gpu/nndescent_gpu.rs``: reverse-candidate
kernels, shared-memory local joins, atomic proposal merges) and the CAGRA
search kernel (``src/gpu/cagra_gpu_search.rs``: one workgroup per query,
candidate queue + visited hash). None of those shapes map to XLA, so the
algorithms are reformulated:

  * **construction** is gather-form NN-descent: each round, node u scores
    candidates from the two-hop union adjacency B(B(u)) (forward lists,
    sibling/reverse lists, and an old-edge reverse channel — see
    ``nnd_round``) against itself and merges into its own row only. Every
    step is a contiguous-tile gather + batched distance einsum + per-row
    sort-dedup-top-k — no proposal scatters, no locks (the reference's
    disjoint-segment writes, nndescent.rs:160-169, become "each node owns
    its row" by construction). Reverse edges are sampled with blocked
    hashed scatters per round (collision-overwrite ≈ reservoir sampling,
    like the GPU xorshift reservoir, nndescent_gpu.rs:189).
  * **RP-forest init** exploits that a random-projection tree over a 1-D
    projection is contiguous ranges of the sort order: L levels of
    sort-by-(group, projection) produce leaves; intra-leaf all-pairs
    distances are dense [leaf × leaf] tensor-core matmuls (the reference's
    leaf_pairwise_proposals in shared memory, forest_gpu.rs).
  * **CAGRA pruning** (nndescent_gpu.rs:827-1056): rank-based detour pruning
    batched over node tiles; reverse-edge fill via hashed scatter; merge.
  * **query** is a fixed-iteration batched beam search: `[bq, B]` beam state,
    per iteration expand the best unexpanded entries, gather neighbours,
    sort-based dedup, distance einsum, merge — `lax.fori_loop`, no visited
    hash table (the beam + expanded bits subsume it).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.dist import Dist, sq_norms

__all__ = [
    "random_init_graph",
    "rp_forest_round",
    "nnd_round",
    "cagra_prune",
    "diversify_graph",
    "add_reverse_edges",
    "beam_search",
    "nav_hl_split",
    "pack_neighbor_table",
    "neighbor_pack_bytes",
]


def nav_hl_split(vectors: jax.Array):
    """bf16 hi/lo split of a vector table for beam-search candidate scoring
    (see ``beam_search`` ``vectors_hl``): candidate gathers move two bf16
    rows instead of one f32 row plus its norm reduction. The split costs an
    extra 2×bf16 copy of the whole table (5.1 GB at 10M×128d) next to the
    f32 original, so it is gated on a device-memory budget like the
    neighbour packing: ``ANNSEARCH_HL_BYTES`` (default 3 GiB; 0 disables).
    Returns None when the table is over budget."""
    import os

    budget = int(os.environ.get("ANNSEARCH_HL_BYTES", 3 << 30))
    if 4 * vectors.shape[0] * vectors.shape[1] > budget:
        # recall-affecting fallback (candidate scoring drops to a single
        # bf16 pass) — say so once, so mid-size-table recall regressions
        # trace to the gate instead of being debugged blind
        global _HL_GATE_WARNED
        if not _HL_GATE_WARNED:
            _HL_GATE_WARNED = True
            print(
                "annsearch: hi/lo split table skipped "
                f"({4 * vectors.shape[0] * vectors.shape[1] / 2**30:.1f} "
                f"GiB > ANNSEARCH_HL_BYTES budget {budget / 2**30:.1f} "
                "GiB) — beam candidate scoring falls back to single-pass "
                "bf16",
                flush=True,
            )
        return None
    from ..utils.dist import mantissa_split

    return mantissa_split(vectors, 2)


_HL_GATE_WARNED = False

_INF = jnp.float32(jnp.inf)
_BIG = jnp.float32(1e30)

#: default reverse-sample widths of :func:`nnd_round` — NEW-edge reverse
#: slots (hop blocks + sibling lists) and OLD-edge reverse slots (the
#: second half of two-sided new×old joins)
NND_R_NEW = 16
NND_R_OLD = 8

#: rows above which chunked NN-descent rounds merge IN PLACE
#: (Gauss-Seidel) — see :func:`nnd_round_chunked`
NND_INPLACE_MIN_N = 8_000_000


def nnd_cand_width(kk: int, c_active: int, r_slots: int = NND_R_NEW,
                   r_old: int = NND_R_OLD) -> int:
    """Per-row candidate width of a flagged :func:`nnd_round` call — for
    sizing the gather tile (see ``models/graph._nnd_tile``)."""
    base_w = kk + r_slots + r_old
    s_blk = max(1, min(c_active // kk, base_w))
    return s_blk * (kk + r_slots) + r_slots + r_old


def neighbor_pack_bytes(n: int, deg: int, d: int) -> int:
    """HBM cost of :func:`pack_neighbor_table` — bf16 ``[n+1, deg·(2d+2)]``."""
    return 2 * (n + 1) * deg * (2 * d + 2)


def maybe_pack_neighbors(
    vectors: jax.Array, sqnorms: jax.Array, graph: jax.Array
) -> jax.Array | None:
    """:func:`pack_neighbor_table` gated on an HBM budget
    (``ANNSEARCH_NBR_PACK_BYTES``, default 4 GiB — the table trades
    ``deg·(2d+2)/d`` × the vector bytes for multi-KB beam-search DMAs)."""
    import os

    np1, d = vectors.shape
    budget = int(os.environ.get("ANNSEARCH_NBR_PACK_BYTES", 4 << 30))
    if neighbor_pack_bytes(np1 - 1, graph.shape[1], d) > budget:
        return None
    return pack_neighbor_table(vectors, sqnorms, graph)


@functools.partial(jax.jit, static_argnames=("chunk",))
def pack_neighbor_table(
    vectors: jax.Array,     # [n+1, d] f32 (sentinel row n)
    sqnorms: jax.Array,     # [n+1]
    graph: jax.Array,       # [n+1, deg] int32 (sentinel id = n)
    chunk: int = 4096,
) -> jax.Array:
    """Materialise each node's neighbourhood as ONE contiguous bf16 row.

    The per-iteration floor of :func:`beam_search` is the candidate-row
    gather: ``expand·deg`` random 64–128 B reads per query from the vector
    table waste most of each memory transaction (device-memory gathers want
    long contiguous rows).
    Packing each node's neighbour vectors next to the node turns that into
    ``expand`` reads of ``deg·(2d+2)·2`` B (multi-KB DMAs) — the same trade
    the reference's GPU CAGRA kernel gets from coalesced warp loads
    (src/gpu/cagra_gpu_search.rs:382-817), achieved here through layout
    instead of thread scheduling.

    Per edge j of node u the packed lanes are ``[xh(d) | xl(d) | sh | sl]``
    where (xh, xl) is the f32-grade mantissa split of the neighbour vector
    (qh·xh + qh·xl + ql·xh recovers HIGH-precision dots — see _tile_dists)
    and (sh, sl) splits its squared norm (one bf16 lane would cost
    ~|x|²·2⁻⁹, above the ~1e-3 neighbour gaps of clustered data).
    Returns ``[n+1, deg·(2d+2)]`` bf16; sentinel edges pack as zeros
    (callers mask ``id ≥ n`` via the id graph they gather anyway).
    """
    from ..utils.dist import mantissa_split

    np1, d = vectors.shape
    deg = graph.shape[1]
    pad = (-np1) % chunk

    def block(g):
        safe = jnp.minimum(g, np1 - 1)
        nv = vectors[safe]                       # [c, deg, d]
        nsq = sqnorms[safe]                      # [c, deg]
        valid = (g < np1 - 1)[..., None]
        xh, xl = mantissa_split(nv, 2)
        sh, sl = mantissa_split(nsq[..., None], 2)
        row = jnp.concatenate(
            [xh.astype(jnp.bfloat16), xl.astype(jnp.bfloat16),
             sh.astype(jnp.bfloat16), sl.astype(jnp.bfloat16)], axis=-1
        )
        row = jnp.where(valid, row, jnp.bfloat16(0))
        return row.reshape(g.shape[0], deg * (2 * d + 2))

    gp = jnp.concatenate(
        [graph, jnp.full((pad, deg), np1 - 1, graph.dtype)]
    ) if pad else graph
    out = jax.lax.map(block, gp.reshape(-1, chunk, deg))
    return out.reshape(-1, deg * (2 * d + 2))[:np1]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _row_dedup_inf(ids: jax.Array, dists: jax.Array) -> jax.Array:
    """Set dist = inf for duplicate ids within each row (keeps one copy).
    ids/dists: [..., C].

    Narrow rows (C ≤ 128, the common merge/beam widths) use an O(C²)
    broadcast compare — pure elementwise work, cheaper than the two
    argsorts of the sort-mark-unsort scheme that dominated round time.
    Wide rows keep the argsort path."""
    C = ids.shape[-1]
    if C <= 128:
        earlier = jnp.tril(jnp.ones((C, C), bool), -1)
        dup = jnp.any(
            (ids[..., None, :] == ids[..., :, None]) & earlier, axis=-1
        )
        return jnp.where(dup, _INF, dists)
    order = jnp.argsort(ids, axis=-1)
    sorted_ids = jnp.take_along_axis(ids, order, axis=-1)
    dup_sorted = jnp.concatenate(
        [
            jnp.zeros(sorted_ids.shape[:-1] + (1,), bool),
            sorted_ids[..., 1:] == sorted_ids[..., :-1],
        ],
        axis=-1,
    )
    inv = jnp.argsort(order, axis=-1)
    dup = jnp.take_along_axis(dup_sorted, inv, axis=-1)
    return jnp.where(dup, _INF, dists)


def _merge_rows(
    ids_a, d_a, ids_b, d_b, k: int
) -> tuple[jax.Array, jax.Array]:
    """Merge two candidate row-sets, dedup by id, keep k smallest (asc)."""
    ids = jnp.concatenate([ids_a, ids_b], axis=-1)
    d = jnp.concatenate([d_a, d_b], axis=-1)
    d = _row_dedup_inf(ids, d)
    nd, pos = jax.lax.top_k(-d, k)
    return jnp.take_along_axis(ids, pos, axis=-1), -nd


# ---------------------------------------------------------------------------
# bitonic networks (sorted-beam maintenance without lax.top_k)
#
# `lax.top_k` + its payload `take_along_axis` gathers dominated a
# beam-search iteration.
# Hand-rolled compare-exchange stages are pure elementwise where/min/max on
# statically reshaped lanes — XLA fuses the whole network, payload lanes ride
# each exchange as one extra `where`, and no gather is ever emitted.
# ---------------------------------------------------------------------------


def _bitonic_stage(key, payloads, j, dirmask):
    """One compare-exchange stage at partner distance ``j`` (a power of 2).

    ``dirmask`` — bool[N//(2j), j], True where the pair sorts ascending
    (precomputed per stage on host); None = all ascending.
    """
    N = key.shape[-1]
    g = N // (2 * j)

    def re(x):
        return x.reshape(x.shape[:-1] + (g, 2, j))

    k2 = re(key)
    a, b = k2[..., 0, :], k2[..., 1, :]
    swap = a > b
    if dirmask is not None:
        swap = swap != dirmask  # descending pairs exchange on a < b

    def ex(x):
        x2 = re(x)
        xa, xb = x2[..., 0, :], x2[..., 1, :]
        lo = jnp.where(swap, xb, xa)
        hi = jnp.where(swap, xa, xb)
        return jnp.stack([lo, hi], axis=-2).reshape(x.shape)

    return ex(key), [ex(p) for p in payloads]


def bitonic_sort(key, *payloads):
    """Ascending row sort of ``key`` [..., N] (N a power of 2) with payload
    lanes exchanged alongside. Returns ``(key, *payloads)`` sorted."""
    N = key.shape[-1]
    assert N & (N - 1) == 0, f"bitonic_sort needs pow2 width, got {N}"
    payloads = list(payloads)
    idx = np.arange(N)
    k = 2
    while k <= N:
        asc = (idx & k) == 0
        j = k // 2
        while j >= 1:
            dm = (
                None
                if bool(asc.all())
                else jnp.asarray(asc.reshape(N // (2 * j), 2, j)[:, 0, :])
            )
            key, payloads = _bitonic_stage(key, payloads, j, dm)
            j //= 2
        k *= 2
    return (key, *payloads)


def bitonic_merge_sorted(key_a, key_b, payloads_a, payloads_b):
    """Merge two ascending-sorted rows into one sorted row.

    ``key_a`` [..., A], ``key_b`` [..., B] with A = B a power of 2. Concatenating
    A-ascending with B-reversed forms a bitonic sequence, so log2(A+B) stages
    finish the sort — ~4× fewer exchanges than a full sort, no gathers.
    Returns ``(key, *payloads)`` of width A+B.
    """
    A, B = key_a.shape[-1], key_b.shape[-1]
    assert A == B and A & (A - 1) == 0, (A, B)
    key = jnp.concatenate([key_a, jnp.flip(key_b, -1)], axis=-1)
    payloads = [
        jnp.concatenate([pa, jnp.flip(pb, -1)], axis=-1)
        for pa, pb in zip(payloads_a, payloads_b)
    ]
    j = (A + B) // 2
    while j >= 1:
        key, payloads = _bitonic_stage(key, payloads, j, None)
        j //= 2
    return (key, *payloads)


def _pad_row(x, width: int, fill):
    """Right-pad the last dim to ``width`` with ``fill``."""
    pad = width - x.shape[-1]
    if pad == 0:
        return x
    return jnp.concatenate(
        [x, jnp.full(x.shape[:-1] + (pad,), fill, x.dtype)], axis=-1
    )


def _next_pow2(v: int) -> int:
    return 1 << max(v - 1, 0).bit_length()


def _tile_dists(
    q_vecs: jax.Array,      # [t, d]
    cand_vecs: jax.Array,   # [t, C, d]
    q_sq: jax.Array,        # [t]
    cand_sq: jax.Array,     # [t, C]
    metric: Dist,
) -> jax.Array:
    # hi/lo mantissa split ≈ f32 dots: a single bf16 pass carries absolute
    # error ~|x|²·2⁻⁹, far above the ~1e-3 neighbour gaps of large clustered
    # sets — measured as an NN-descent recall ceiling of 0.72 at 1M with
    # rounds that never converge (noise-driven merge churn). The split costs
    # two extra small matmuls per tile; the row gathers dominate regardless.
    from ..utils.dist import mantissa_split

    qh, ql = mantissa_split(q_vecs, 2)
    ch, cl = mantissa_split(cand_vecs, 2)
    e = functools.partial(
        jnp.einsum, "td,tcd->tc", preferred_element_type=jnp.float32
    )
    dots = e(qh, ch) + e(qh, cl) + e(ql, ch)
    if metric == Dist.COSINE:
        return 1.0 - dots
    return jnp.maximum(q_sq[:, None] + cand_sq - 2.0 * dots, 0.0)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("kk", "metric", "tile"))
def random_init_graph(
    key: jax.Array,
    vectors: jax.Array,     # [n+1, d] (last row = sentinel zeros)
    sqnorms: jax.Array,     # [n+1]
    kk: int,
    metric: Dist,
    tile: int = 1024,
) -> tuple[jax.Array, jax.Array]:
    """Random kk-NN graph init with true distances (GPU reference
    init_random_graph, nndescent_gpu.rs:189). Returns ([n, kk] ids asc-by-d,
    [n, kk] dists); self-edges masked."""
    n = vectors.shape[0] - 1
    n_pad = -(-n // tile) * tile
    cand = jax.random.randint(key, (n_pad, kk), 0, n)

    def block(args):
        u, c = args
        cv = vectors[c]
        d = _tile_dists(vectors[u], cv, sqnorms[u], sqnorms[c], metric)
        d = jnp.where(c == u[:, None], _INF, d)
        d = _row_dedup_inf(c, d)
        nd, pos = jax.lax.top_k(-d, kk)
        return jnp.take_along_axis(c, pos, axis=-1), -nd

    us = jnp.arange(n_pad).reshape(-1, tile)
    cs = cand.reshape(-1, tile, kk)
    ids, dists = jax.lax.map(block, (us, cs))
    ids = ids.reshape(n_pad, kk)[:n]
    dists = dists.reshape(n_pad, kk)[:n]
    ids = jnp.where(jnp.isinf(dists), n, ids)
    return ids.astype(jnp.int32), dists


@functools.partial(jax.jit, static_argnames=("levels", "leaf", "kk", "metric"))
def rp_forest_round(
    key: jax.Array,
    vectors: jax.Array,     # [n+1, d]
    sqnorms: jax.Array,     # [n+1]
    graph_ids: jax.Array,   # [n, kk]
    graph_dists: jax.Array, # [n, kk]
    levels: int,
    leaf: int,
    kk: int,
    metric: Dist,
) -> tuple[jax.Array, jax.Array]:
    """One random-projection tree pass merged into the graph.

    L rounds of sort-by-(group, random projection) partition the points into
    contiguous leaves of size ``leaf``; intra-leaf all-pairs distances are
    then merged into each member's row. The reference builds explicit trees
    with median splits (forest_gpu.rs:603-725); sorting by projection within
    a group IS the median split, applied to all groups at once.
    """
    n = graph_ids.shape[0]
    n_pad = -(-n // leaf) * leaf
    # pad with sentinel points (group them to the end)
    ids = jnp.arange(n_pad, dtype=jnp.int32)
    group = jnp.zeros((n_pad,), jnp.float32).at[n:].set(1.0)

    keys = jax.random.split(key, levels)
    for lv in range(levels):
        v = jax.random.normal(keys[lv], (vectors.shape[1],), jnp.float32)
        proj = vectors[jnp.minimum(ids, n)] @ v
        proj = jnp.where(ids < n, proj, _BIG)
        # sort by (group, projection) as a TWO-KEY lexicographic sort. A
        # float composite (group·BIG + proj) silently loses the projection:
        # at group ≥ 1 the f32 resolution near group·4e30 is ~2.4e23, every
        # real projection value ties, and the stable sort degenerates to
        # re-chopping the level-0 ordering — i.e. the whole "tree" was one
        # projection split (measured: 1M forest+NND stalled at recall 0.64).
        group, _, ids = jax.lax.sort(
            (group, proj, ids), num_keys=2, is_stable=False
        )
        # split each group in half: new group id = rank within array // half
        ranks = jnp.arange(n_pad)
        group = (ranks // max(n_pad // (2 ** (lv + 1)), leaf)).astype(
            jnp.int32
        )

    leaves = ids.reshape(-1, leaf)                      # [g, leaf]
    return leaf_join_merge(
        leaves, vectors, sqnorms, graph_ids, graph_dists, kk, metric
    )


def leaf_join_merge(
    leaves: jax.Array,      # [g, leaf] member ids (≥ n = pad sentinel)
    vectors: jax.Array,     # [n+1, d]
    sqnorms: jax.Array,     # [n+1]
    graph_ids: jax.Array,   # [n, kk]
    graph_dists: jax.Array, # [n, kk]
    kk: int,
    metric: Dist,
) -> tuple[jax.Array, jax.Array]:
    """All-pairs join inside each leaf, merged into the members' graph rows.

    The join is pure GEMM (the matmul substitute for the reference's
    random-access local joins) and is chunked over leaf blocks with a
    top-kk pre-select per member, so peak memory is O(n·kk) instead of
    O(n·leaf): top-kk(row ∪ leaf) ≡ top-kk(row ∪ top-kk(leaf)), which
    admits large (tensor-core-efficient) leaves. Scatters are collision-free —
    leaves partition the points.
    """
    n = graph_ids.shape[0]
    g, leaf = leaves.shape
    ksel = min(kk, leaf - 1)
    # ~32k members per chunk bounds the [bg, leaf, leaf] distance tile
    bg = max(1, min(g, 32768 // leaf))
    g_pad = -(-g // bg) * bg
    if g_pad != g:
        leaves = jnp.concatenate(
            [leaves, jnp.full((g_pad - g, leaf), n, jnp.int32)]
        )

    # Stream leaf blocks through join+merge+scatter as ONE jitted step per
    # block: stacking all candidates first ([n, ksel] ids+dists) plus the
    # full-width merge workspace exceeds large-n device-memory budgets
    # (10M×128d next to the 5.1 GB vector table), while per-block
    # transients are a few hundred MB. The scatter stays collision-free —
    # leaves partition the points, so blocks touch disjoint rows. Blocks
    # are uniform [bg, leaf], so the step compiles exactly once.
    n_blocks = g_pad // bg
    gi, gd = graph_ids, graph_dists
    blocks = leaves.reshape(n_blocks, bg, leaf)
    for b in range(n_blocks):
        gi, gd = _leaf_step(
            blocks[b], gi, gd, vectors, sqnorms, kk=kk, ksel=ksel,
            metric=metric,
        )
    return gi, gd


@functools.partial(
    jax.jit, static_argnames=("kk", "ksel", "metric")
)
def _leaf_step(lv, gi, gd, vectors, sqnorms, *, kk, ksel, metric):
    """One leaf block of :func:`leaf_join_merge`: all-pairs join on the
    tensor-core, top-ksel pre-select, merge into the members' graph rows."""
    from ..utils.dist import mantissa_split

    n = gi.shape[0]
    leaf = lv.shape[1]
    safe = jnp.minimum(lv, n)
    lv_vecs = vectors[safe]                             # [bg, leaf, d]
    lv_sq = sqnorms[safe]
    lh, ll = mantissa_split(lv_vecs, 2)                 # f32-grade pairs
    e = functools.partial(
        jnp.einsum, "gld,gmd->glm", preferred_element_type=jnp.float32
    )
    dots = e(lh, lh) + e(lh, ll) + e(ll, lh)
    if metric == Dist.COSINE:
        d = 1.0 - dots
    else:
        d = jnp.maximum(
            lv_sq[:, :, None] + lv_sq[:, None, :] - 2.0 * dots, 0.0
        )
    eye = jnp.eye(leaf, dtype=bool)[None]
    invalid = (lv[:, None, :] >= n) | (lv[:, :, None] >= n) | eye
    d = jnp.where(invalid, _INF, d)
    nd, pos = jax.lax.top_k(-d, ksel)                   # [bg, leaf, ksel]
    cid = jnp.take_along_axis(
        jnp.broadcast_to(lv[:, None, :], d.shape), pos, axis=-1
    )
    m = lv.reshape(-1)
    cur_ids = gi[jnp.minimum(m, n - 1)]
    cur_d = gd[jnp.minimum(m, n - 1)]
    new_ids, new_d = _merge_rows(
        cur_ids, cur_d, cid.reshape(-1, ksel), (-nd).reshape(-1, ksel), kk
    )
    # pads scatter OUT of range and are dropped — clamping them to n-1
    # would collide with (and nondeterministically clobber) the real last
    # member's update
    safe_m = jnp.where(m < n, m, n)
    return (
        gi.at[safe_m].set(new_ids, mode="drop"),
        gd.at[safe_m].set(new_d, mode="drop"),
    )


@functools.partial(jax.jit, static_argnames=("jth", "leaf", "metric", "tile"))
def kmeans_leaves(
    key: jax.Array,
    vectors: jax.Array,      # [n+1, d]
    centroids: jax.Array,    # [nc, d]
    jth: int,
    leaf: int,
    metric: Dist,
    tile: int = 131072,
) -> jax.Array:
    """Contiguous leaves grouped by the (jth+1)-nearest k-means cell,
    sub-ordered inside each cell by a fresh random projection.

    A k-means partition co-locates true neighbours far more often than a
    random-projection split, and rotating ``jth`` across passes (spill
    assignment — the same idea as IVF multi-probe) catches cell-boundary
    pairs; the projection sub-order moves chunk boundaries inside large
    cells between passes. Combined with ``leaf_join_merge`` this is the
    tensor-core-shaped replacement for the reference's NN-descent sampling at
    scale (nndescent.rs:706-801): all candidate generation is GEMM + sort,
    no random-access gathers.
    """
    n = vectors.shape[0] - 1
    nc = centroids.shape[0]
    j = min(jth, nc - 1)
    v = jax.random.normal(key, (vectors.shape[1],), jnp.float32)
    csq = sq_norms(centroids)
    cb = centroids.astype(jnp.bfloat16)

    # bound the [tile, nc] distance transients: the iterated-argmin
    # rounds (jth > 0) keep up to jth+1 copies live — the sequential
    # mask chain breaks XLA's matmul→reduce fusion — and nc grows with n
    # (19.5k cells at 10M ⇒ 10 GB per copy at the default tile). ~640 MB
    # per copy keeps the worst case under 2 GB.
    tile = min(tile, max(8192, ((5 << 27) // (4 * nc)) // 8192 * 8192))

    n_pad_t = -(-n // tile) * tile

    def blk(i0):
        rows = jnp.minimum(i0 + jnp.arange(tile, dtype=jnp.int32), n)
        x = vectors[rows]
        dots = jax.lax.dot_general(
            x.astype(jnp.bfloat16), cb, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        dc = -dots if metric == Dist.COSINE else csq[None, :] - 2.0 * dots
        # (jth+1)-nearest cell via j masked argmin rounds, NOT top_k:
        # iterated argmin is cheaper than a k=2 top_k — the where-mask
        # fuses into the tile
        for _ in range(j):
            m = jnp.argmin(dc, axis=1)
            dc = jnp.where(
                jnp.arange(dc.shape[1])[None, :] == m[:, None], _INF, dc
            )
        return jnp.argmin(dc, axis=1).astype(jnp.int32), x @ v

    cells, projs = jax.lax.map(
        blk, jnp.arange(0, n_pad_t, tile, dtype=jnp.int32)
    )
    cells = cells.reshape(-1)[:n]
    projs = projs.reshape(-1)[:n]

    n_pad = -(-n // leaf) * leaf
    ids = jnp.arange(n_pad, dtype=jnp.int32)
    cellp = jnp.concatenate([cells, jnp.full((n_pad - n,), nc, jnp.int32)])
    projp = jnp.concatenate(
        [projs, jnp.full((n_pad - n,), _BIG, jnp.float32)]
    )
    _, _, ids = jax.lax.sort((cellp, projp, ids), num_keys=2, is_stable=False)
    return ids.reshape(-1, leaf)


def _reverse_sample(
    key: jax.Array, graph_ids: jax.Array, n: int, r_slots: int,
    new_in: jax.Array | None = None, invert: bool = False,
) -> jax.Array:
    """[n, r] reverse-neighbour sample: scatter each edge (u→v) into a
    hashed slot of v's reverse list (collisions overwrite — cheap reservoir;
    GPU reference uses an xorshift reservoir, nndescent_gpu.rs:289).

    ``new_in`` filters the scattered edges: NEW ones only (default), or
    with ``invert=True`` OLD edges from rows holding ≥1 new edge (the
    rev_old channel). Filtering happens per block so no [n, kk]-sized
    ``where`` copy ever materialises. Edges are scattered in fixed 2M-row
    blocks with per-block keys — the [n·kk] src/dst/slot arrays of a
    single whole-graph scatter are a ~3 GB transient at 10M×24 that OOMs
    next to the vector table."""
    kk = graph_ids.shape[1]
    rev = jnp.full((n + 1, r_slots), n, jnp.int32)
    BLK = 1 << 21
    for i, b0 in enumerate(range(0, n, BLK)):
        blk = min(BLK, n - b0)
        g = jax.lax.slice_in_dim(graph_ids, b0, b0 + blk)
        if new_in is not None:
            nb = jax.lax.slice_in_dim(new_in, b0, b0 + blk)
            if invert:
                g = jnp.where((~nb) & jnp.any(nb, axis=1)[:, None], g, n)
            else:
                g = jnp.where(nb, g, n)
        src = jnp.broadcast_to(
            b0 + jnp.arange(blk, dtype=jnp.int32)[:, None], g.shape
        ).reshape(-1)
        dst = g.reshape(-1)
        slot = jax.random.randint(
            jax.random.fold_in(key, i), (blk * kk,), 0, r_slots
        )
        rev = rev.at[jnp.minimum(dst, n), slot].set(src, mode="drop")
    return rev[:n]


@functools.partial(
    jax.jit,
    static_argnames=("kk", "metric", "tile", "fof_sample", "r_slots",
                     "r_old", "c_active", "n_rows"),
)
def nnd_round(
    key: jax.Array,
    vectors: jax.Array,      # [n+1, d]
    sqnorms: jax.Array,      # [n+1]
    graph_ids: jax.Array,    # [n, kk]
    graph_dists: jax.Array,  # [n, kk]
    kk: int,
    metric: Dist,
    tile: int = 256,
    fof_sample: int = 0,     # 0 → all kk² neighbours-of-neighbours
    r_slots: int = NND_R_NEW,
    r_old: int = NND_R_OLD,
    new_in: jax.Array | None = None,  # [n, kk] bool — edges added last round
    c_active: int | None = None,      # compacted candidate width with flags
    n_rows: int | None = None,        # rows per call (None = all n)
    row_start: jax.Array | None = None,  # first row (traced; with n_rows)
    rev: jax.Array | None = None,     # precomputed [n, r_slots] rev sample
    rev2: jax.Array | None = None,    # precomputed [n, r_old] old-rev sample
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """One NN-descent expansion round.

    Candidate generation is *both-ways* (reference local joins propose each
    pair to both endpoints over the union adjacency, nndescent.rs:849-917):
    the join at node v pairs up ``B(v) = N(v) ∪ R(v)``, so in gather form
    node u's candidate pool is ``B(B(u))``. Three channels realise it:

      * ``N(blocks)`` — forward lists of the expanded blocks (N ∪ R);
      * ``R(blocks)`` — *sibling* lists: the reverse samples of the
        expanded blocks. Two nodes pointing at the same neighbour are each
        other's best proposals in a converging kNN graph (the reference's
        in-list pair joins); without this channel those pairs are only
        reachable when an edge happens to point back. Rev slots are drawn
        from NEW edges, so every sibling pair has a new member — always
        relevant under the incremental filter.
      * ``R_old(u)`` — ``r_old`` reverse slots sampled from OLD edges
        whose source row gained new edges. Reference new×old joins update
        BOTH endpoints; the old endpoint c of a pair (u, c) joined at v
        (v→u new, v→c old) cannot see u through new-edge reverse samples —
        this channel delivers v to c with relevance = v's new mask.

    Without the reverse channels, improvements discovered elsewhere can
    only reach u through its own forward expansion and rounds stall
    (update rate 0.60 after 10 rounds at 1M; the two-sided channels move
    forced-1M convergence from the 0.96 class toward the reference's
    0.999 class).

    With ``new_in`` flags, implements the reference's incremental new/old
    candidate scheme (nndescent.rs:706-801 — edges are marked old once their
    pairs have been tried): the candidate c (reached u→v→c) is relevant only
    if edge (u,v) or edge (v,c) is new, and each row's fof set is
    *compacted* to the ``c_active`` relevant candidates before any vector
    gather — late rounds touch a fraction of the early-round candidates.
    Reverse hops are always relevant: ``rev`` is sampled from edges that
    were new last round, so (v→u) new ⇒ the pair is untried.

    Returns (ids, dists, n_updates, new_flags); feed ``new_flags`` back as
    ``new_in`` next round. ``n_updates`` counts edges in the new row that
    were not in the old row (set difference, not positional: one insertion
    shifts every later rank and would otherwise count as kk updates).

    ``n_rows``/``row_start`` process only rows [row_start, row_start+n_rows)
    against the full graph snapshot, returning chunk-shaped outputs —
    see :func:`nnd_round_chunked` for why rounds are split into bounded
    dispatches at large n.
    """
    # HBM discipline: at 10M×kk24 every whole-graph-sized copy is ~1 GB
    # next to the 5.1 GB vector table, and sentinel-row concats of
    # graph/flags plus a second reverse buffer measurably OOM round 1
    # (round-5 10M campaign). So: block gathers CLAMP to n−1 and mask by
    # block validity instead of reading a sentinel row (no graph/flag
    # copies), and the reverse table exists once ([n, r], no padded twin).
    n = graph_ids.shape[0]
    k_rev, k_fof = jax.random.split(key)
    if rev is None:
        # chunked rounds precompute rev/rev2 ONCE per round and pass them
        # in (same keys + same sampler ⇒ bit-identical): re-sampling the
        # whole reverse table inside every chunk dispatch is both the
        # dominant scatter cost (306 chunks × n·kk edges at 10M) and a
        # per-chunk transient spike
        rev = _reverse_sample(k_rev, graph_ids, n, r_slots, new_in=new_in)
    if new_in is not None:
        # block-level "has any new out-edge" — cheap relevance bound for
        # old hop-1 edges whose target rows gained edges elsewhere
        row_any_new = jnp.concatenate(
            [jnp.any(new_in, axis=1), jnp.zeros((1,), bool)]
        )
        if rev2 is None:
            # OLD edges from rows that gained new edges — the delivery
            # path for the old endpoint of new×old joins (channel 3)
            rev2 = _reverse_sample(
                jax.random.fold_in(k_rev, 1), graph_ids, n, r_old,
                new_in=new_in, invert=True,
            )

    rows = n_rows if n_rows is not None else n
    rows_pad = -(-rows // tile) * tile
    r0 = row_start if row_start is not None else jnp.int32(0)
    base_w = kk + r_slots + (r_old if new_in is not None else 0)

    def block(u):
        u_safe = jnp.minimum(u, n - 1)
        fwd = graph_ids[u_safe]                      # [t, kk]
        rv = rev[u_safe]                             # [t, r]
        if new_in is not None:
            rv2 = rev2[u_safe]                       # [t, r_old]
            base = jnp.concatenate([fwd, rv, rv2], axis=-1)
        else:
            base = jnp.concatenate([fwd, rv], axis=-1)
        expanded = None
        if new_in is not None:
            # BLOCK-level sampling (the reference's join granularity,
            # nndescent.rs:706-801: a local join consumes a sampled
            # neighbour's whole list, and only SAMPLED new edges flip to
            # old). Two earlier schemes both failed at 1M: candidate-level
            # index-order compaction starved the reverse blocks (stall at
            # 0.78), and candidate-level uniform sampling scattered the
            # budget into 2-3 candidates per block while flagging every
            # edge old — permanently discarding the unexplored 90% of each
            # new edge's expansion (recall fell to 0.64). Sampling whole
            # blocks keeps the join semantics, and newness persists until
            # a block is actually expanded, so no information is lost.
            s_blk = max(1, min((c_active if c_active else 4 * kk) // kk,
                               base_w))
            new1 = new_in[u_safe]                    # [t, kk]
            # priority: untried pairs (new fwd edge, or rev hop — sampled
            # from new edges so (v→u) is new) rank above old edges with
            # fresh targets; exhausted blocks rank nowhere
            any_tgt = row_any_new[jnp.minimum(fwd, n)]
            pri_fwd = jnp.where(
                fwd < n,
                jnp.where(new1, 2.0, jnp.where(any_tgt, 1.0, 0.0)),
                0.0,
            )
            pri_rev = jnp.where(rv < n, 2.0, 0.0)
            pri_rev2 = jnp.where(rv2 < n, 2.0, 0.0)
            pri = jnp.concatenate([pri_fwd, pri_rev, pri_rev2], axis=-1)
            kb = jax.random.fold_in(k_fof, u[0])
            noise = jax.random.uniform(kb, pri.shape)
            score = jnp.where(pri > 0, pri + noise, 0.0)
            _, bidx = jax.lax.top_k(score, s_blk)    # [t, s_blk]
            sel_pri = jnp.take_along_axis(pri, bidx, axis=-1)
            sel_base = jnp.take_along_axis(base, bidx, axis=-1)
            # clamped gathers (see HBM note): invalid blocks (sel_pri == 0,
            # includes every sel_base ≥ n) read row n−1's junk and are
            # masked to the sentinel below
            sel_c = jnp.minimum(sel_base, n - 1)
            fof_f = graph_ids[sel_c]                 # [t, s_blk, kk]
            # within an OLD selected block only fresh targets are untried;
            # rev_old blocks (sel_new1 = False) deliver EXACTLY the new
            # out-edges of the block row
            sel_new1 = jnp.take_along_axis(
                jnp.concatenate(
                    [new1, jnp.ones((tile, r_slots), bool),
                     jnp.zeros((tile, r_old), bool)], axis=-1
                ),
                bidx, axis=-1,
            )
            rel = sel_new1[:, :, None] | new_in[sel_c]
            rel = rel & (sel_pri > 0)[:, :, None]
            fof_f = jnp.where(rel, fof_f, n)
            # sibling lists: reverse samples of the selected blocks — every
            # entry is a NEW edge's source, so every sibling pair is untried
            fof_s = jnp.where(
                (sel_pri > 0)[:, :, None], rev[sel_c], n
            )                                        # [t, s_blk, r]
            fof = jnp.concatenate([fof_f, fof_s], axis=-1).reshape(
                tile, s_blk * (kk + r_slots)
            )
            # expanded fwd slots: their (u,v) pair joins happened — flip old
            expanded = jnp.any(
                (bidx[:, :, None] == jnp.arange(kk, dtype=bidx.dtype)[
                    None, None, :])
                & (sel_pri > 0)[:, :, None],
                axis=1,
            )                                        # [t, kk]
        else:
            # clamped block gathers + validity mask (see HBM note): blocks
            # that are sentinel edges (value n) read row n−1's junk and
            # are masked to the sentinel before scoring
            bsc = jnp.minimum(base, n - 1)
            fof3 = jnp.concatenate([graph_ids[bsc], rev[bsc]], axis=-1)
            fof3 = jnp.where((base < n)[:, :, None], fof3, n)
            fof = fof3.reshape(tile, base_w * (kk + r_slots))
            if fof_sample and fof_sample < fof.shape[1]:
                cols = jax.random.randint(
                    k_fof, (fof_sample,), 0, fof.shape[1]
                )
                fof = fof[:, cols]
        # reverse hops are direct candidates too (edge v→u means v scored
        # u once, but u's row never saw v)
        hops = [fof, rv] if new_in is None else [fof, rv, rv2]
        cand = jnp.concatenate(hops, axis=-1)        # [t, C]
        safe_c = jnp.minimum(cand, n)
        cv = vectors[safe_c]
        d = _tile_dists(
            vectors[u_safe], cv, sqnorms[u_safe], sqnorms[safe_c], metric
        )
        d = jnp.where((cand >= n) | (cand == u[:, None]), _INF, d)
        # pre-select top-2kk candidates BEFORE the dedup merge: the dedup
        # over the full C width dominates round time; top-k first shrinks
        # the dedup to 3·kk. 2·kk (not kk) because the sibling/reverse
        # channels reach the same candidate along several paths — at kk a
        # near-converged row's pre-select fills with duplicate copies of
        # the few nearest candidates and the merge pool starves
        ncd, ci = jax.lax.top_k(-d, min(2 * kk, d.shape[1]))
        cand_top = jnp.take_along_axis(cand, ci, axis=-1)
        cur_ids, cur_d = graph_ids[u_safe], graph_dists[u_safe]
        new_ids, new_d = _merge_rows(cur_ids, cur_d, cand_top, -ncd, kk)
        # an edge is "new" iff it was not in the row before this round
        eq = new_ids[:, :, None] == cur_ids[:, None, :]
        fresh = ~jnp.any(eq, axis=-1)
        flags = fresh
        if expanded is not None:
            # surviving edges that were new and NOT expanded this round
            # carry their newness forward — their pair joins are still owed
            carried = jnp.any(
                eq & (new_in[u_safe] & ~expanded)[:, None, :], axis=-1
            )
            flags = fresh | carried
        upd = jnp.sum(
            fresh & (new_ids < n) & (u[:, None] < n), axis=-1
        ).astype(jnp.int32)
        return new_ids, new_d, upd, flags

    us = r0 + jnp.arange(rows_pad).reshape(-1, tile)
    ids, dists, upd, fresh = jax.lax.map(block, us)
    out_rows = min(rows, n)
    ids = ids.reshape(rows_pad, kk)[:out_rows]
    dists = dists.reshape(rows_pad, kk)[:out_rows]
    fresh = fresh.reshape(rows_pad, kk)[:out_rows]
    return ids, dists, jnp.sum(upd), fresh


@functools.partial(jax.jit, donate_argnums=(0,))
def _upd_rows(buf, chunk, r0):
    """Donated in-place row update — without donation every chunk's
    dynamic_update_slice allocates a second full-graph buffer next to the
    live one (a 1.3 GB spike per array at 10M×32 that puts the
    Gauss-Seidel rounds back over the HBM ceiling)."""
    return jax.lax.dynamic_update_slice_in_dim(buf, chunk, r0, 0)


@functools.partial(jax.jit, static_argnames=("r_slots", "invert"))
def _sample_revs(key, graph_ids, new_in, *, r_slots, invert=False):
    """Jitted once-per-round reverse sampling for the chunked rounds."""
    n = graph_ids.shape[0]
    return _reverse_sample(
        key, graph_ids, n, r_slots, new_in=new_in, invert=invert
    )


def nnd_round_chunked(
    key: jax.Array,
    vectors: jax.Array,
    sqnorms: jax.Array,
    graph_ids: jax.Array,
    graph_dists: jax.Array,
    kk: int,
    metric: Dist,
    *,
    tile: int,
    c_active: int,
    new_in: jax.Array,
    row_chunk: int = 131_072,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """One NN-descent round as several bounded dispatches over row ranges.

    A full-width round over 1M rows as ONE program is a multi-minute XLA
    dispatch. Chunking rows keeps each dispatch short and is semantically
    identical below 8M rows: every chunk expands candidates from the
    round-start graph snapshot (exactly what the single-dispatch map
    reads) and merges only into its own rows; the reverse tables are
    sampled ONCE per round and passed into every chunk (same keys + same
    sampler as nnd_round's internal path ⇒ bit-identical results).

    At n ≥ 8M the round runs IN-PLACE (Gauss-Seidel): each chunk's rows
    overwrite the live graph, so later chunks expand against a mix of
    round-start and fresh rows. Async updates are standard NN-descent
    (the reference's parallel joins see mixed state the same way,
    nndescent.rs:849-917) and converge at least as fast; the point here
    is memory — a Jacobi round holds TWO full graphs (old + accumulating
    new: 2×~2 GB at 10M×24) next to the 5.1 GB vector table, which OOMs
    the chip. ``n_updates`` sums over chunks either way."""
    n = graph_ids.shape[0]
    if n <= row_chunk:
        return nnd_round(
            key, vectors, sqnorms, graph_ids, graph_dists, kk, metric,
            tile=tile, new_in=new_in, c_active=c_active,
        )
    k_rev, _ = jax.random.split(key)
    rev = _sample_revs(k_rev, graph_ids, new_in, r_slots=NND_R_NEW)
    rev2 = _sample_revs(
        jax.random.fold_in(k_rev, 1), graph_ids, new_in,
        r_slots=NND_R_OLD, invert=True,
    )
    inplace = n >= NND_INPLACE_MIN_N
    ids_b, d_b, f_b = graph_ids, graph_dists, new_in
    out_ids = []
    out_d = []
    out_f = []
    upd_total = jnp.int32(0)
    for r0 in range(0, n, row_chunk):
        ci, cd, cu, cf = nnd_round(
            key, vectors, sqnorms, ids_b, d_b, kk, metric,
            tile=tile, new_in=f_b, c_active=c_active,
            n_rows=row_chunk, row_start=jnp.int32(r0),
            rev=rev, rev2=rev2,
        )
        take = min(row_chunk, n - r0)
        upd_total = upd_total + cu
        if inplace:
            r0j = jnp.int32(r0)
            ids_b = _upd_rows(ids_b, ci[:take], r0j)
            d_b = _upd_rows(d_b, cd[:take], r0j)
            f_b = _upd_rows(f_b, cf[:take], r0j)
        else:
            out_ids.append(ci[:take])
            out_d.append(cd[:take])
            out_f.append(cf[:take])
    if inplace:
        return ids_b, d_b, upd_total, f_b
    return (
        jnp.concatenate(out_ids),
        jnp.concatenate(out_d),
        upd_total,
        jnp.concatenate(out_f),
    )


# ---------------------------------------------------------------------------
# CAGRA graph construction (prune + reverse)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("out_deg", "metric", "tile"))
def cagra_prune(
    vectors: jax.Array,      # [n+1, d]
    sqnorms: jax.Array,      # [n+1]
    graph_ids: jax.Array,    # [n, kk] asc by dist
    graph_dists: jax.Array,  # [n, kk]
    out_deg: int,
    metric: Dist,
    tile: int = 256,
) -> jax.Array:
    """Rank-based detour pruning (reference cagra_rank_prune_shared,
    nndescent_gpu.rs:827): drop edge (u→v) when some closer neighbour w of u
    satisfies d(w, v) < d(u, v); keep the first ``out_deg`` survivors (by
    rank), backfilling with the best pruned edges."""
    n, kk = graph_ids.shape
    n_pad = -(-n // tile) * tile

    def block(u):
        u_safe = jnp.minimum(u, n - 1)
        nbrs = graph_ids[u_safe]                   # [t, kk]
        nd = graph_dists[u_safe]                   # [t, kk]
        safe = jnp.minimum(nbrs, n)
        nv = vectors[safe]                         # [t, kk, d]
        nsq = sqnorms[safe]
        from ..utils.dist import mantissa_split

        nh, nl = mantissa_split(nv, 2)  # f32-grade pairs (see _tile_dists)
        e = functools.partial(
            jnp.einsum, "tkd,tmd->tkm", preferred_element_type=jnp.float32
        )
        dots = e(nh, nh) + e(nh, nl) + e(nl, nh)
        if metric == Dist.COSINE:
            pair = 1.0 - dots
        else:
            pair = jnp.maximum(
                nsq[:, :, None] + nsq[:, None, :] - 2.0 * dots, 0.0
            )
        # detourable(v): ∃ w with rank < rank(v) and d(w, v) < d(u, v)
        rank_lt = (
            jnp.arange(kk)[None, :, None] < jnp.arange(kk)[None, None, :]
        )  # [1, w, v]
        closer = pair < nd[:, None, :]
        invalid_w = (nbrs >= n)[:, :, None]
        detour = jnp.any(rank_lt & closer & ~invalid_w, axis=1)  # [t, v]
        detour = detour | (nbrs >= n)
        # keep survivors in rank order, then best pruned
        keep_key = jnp.where(detour, 1.0, 0.0) * 1e6 + jnp.arange(kk)[None, :]
        order = jnp.argsort(keep_key, axis=-1)
        return jnp.take_along_axis(nbrs, order[:, :out_deg], axis=-1)

    us = jnp.arange(n_pad).reshape(-1, tile)
    out = jax.lax.map(block, us)
    return out.reshape(n_pad, out_deg)[:n]


def diversify_graph(
    key: jax.Array,
    vectors: jax.Array,      # [n+1, d] (sentinel row n)
    sqnorms: jax.Array,      # [n+1]
    graph_ids: jax.Array,    # [n, kk] asc by dist
    graph_dists: jax.Array,  # [n, kk]
    prune_prob: float,
    metric: Dist,
    tile: int = 256,
) -> tuple[jax.Array, jax.Array]:
    """Probabilistic occlusion pruning of a kNN graph (reference
    diversify_graph, nndescent.rs:954-1010): scanning each node's
    neighbours in ascending distance, candidate v is dropped with
    probability ``prune_prob`` when some already-KEPT closer neighbour w
    sits nearer to v than the node does (d(w, v) < d(u, v)); kept edges
    stay in rank order, pruned slots become (sentinel, +inf) at the tail.

    Unlike :func:`cagra_prune` (rank-based test against ALL closer
    neighbours, fixed out-degree with backfill) this matches the
    reference's kept-set semantics — pruning one edge can save a later
    one — so the sequential kept-set scan runs as a ``fori_loop`` over
    the (small) kk columns while nodes stay fully batched."""
    n, kk = graph_ids.shape
    n_pad = -(-n // tile) * tile
    eps = float(np.finfo(np.float32).eps)

    def block(args):
        u, kb = args
        u_safe = jnp.minimum(u, n - 1)
        nbrs = graph_ids[u_safe]                   # [t, kk]
        nd = graph_dists[u_safe]                   # [t, kk]
        safe = jnp.minimum(nbrs, n)
        nv = vectors[safe]                         # [t, kk, d]
        nsq = sqnorms[safe]
        from ..utils.dist import mantissa_split

        nh, nl = mantissa_split(nv, 2)
        e = functools.partial(
            jnp.einsum, "tkd,tmd->tkm", preferred_element_type=jnp.float32
        )
        dots = e(nh, nh) + e(nh, nl) + e(nl, nh)
        if metric == Dist.COSINE:
            pair = 1.0 - dots
        else:
            pair = jnp.maximum(
                nsq[:, :, None] + nsq[:, None, :] - 2.0 * dots, 0.0
            )
        valid = nbrs < n
        rand = jax.random.uniform(kb, pair.shape)
        # occludes[t, w, v]: kept w would prune candidate v this draw
        occludes = (
            (pair < nd[:, None, :])
            & (nd[:, :, None] > eps)
            & (rand < prune_prob)
        )

        kept0 = jnp.zeros(nbrs.shape, bool).at[:, 0].set(valid[:, 0])

        def step(i, kept):
            hit = jnp.any(kept & occludes[:, :, i], axis=1)
            return kept.at[:, i].set(valid[:, i] & ~hit)

        kept = jax.lax.fori_loop(1, kk, step, kept0)

        # compact kept edges to the front, rank order preserved
        keep_key = jnp.where(kept, 0.0, 1e6) + jnp.arange(kk)[None, :]
        order = jnp.argsort(keep_key, axis=-1)
        kept_s = jnp.take_along_axis(kept, order, axis=-1)
        ids_s = jnp.where(
            kept_s, jnp.take_along_axis(nbrs, order, axis=-1), n
        )
        d_s = jnp.where(
            kept_s, jnp.take_along_axis(nd, order, axis=-1), jnp.inf
        )
        return ids_s.astype(jnp.int32), d_s

    us = jnp.arange(n_pad).reshape(-1, tile)
    keys = jax.random.split(key, us.shape[0])
    ids, dists = jax.lax.map(block, (us, keys))
    return (
        ids.reshape(n_pad, kk)[:n],
        dists.reshape(n_pad, kk)[:n],
    )


def add_reverse_edges(
    key: jax.Array, graph: jax.Array, n: int, extra: int
) -> jax.Array:
    """Append ``extra`` sampled reverse edges per node (reference
    cagra_build_reverse + merge, nndescent_gpu.rs:934-1056). Output
    [n, deg+extra]; duplicate/self entries left in (the beam dedups)."""
    rev = _reverse_sample(key, graph, n, extra)
    return jnp.concatenate([graph, rev], axis=-1)


# ---------------------------------------------------------------------------
# batched beam search
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("k", "beam", "iters", "expand", "metric",
                     "return_trail"),
)
def beam_search(
    q: jax.Array,           # [bq, d]
    vectors: jax.Array,     # [n+1, d] (sentinel row n)
    sqnorms: jax.Array,     # [n+1]
    graph: jax.Array,       # [n+1, deg] int32 (sentinel row n)
    entries: jax.Array,     # [bq, e0] entry node ids
    k: int,
    beam: int,
    iters: int,
    metric: Dist,
    expand: int = 2,
    vectors_hl: tuple[jax.Array, jax.Array] | None = None,
    packed_nbrs: jax.Array | None = None,
    return_trail: bool = False,
) -> tuple[jax.Array, jax.Array] | tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Fixed-iteration batched greedy beam search (reference
    cagra_beam_search, cagra_gpu_search.rs:382-817 — per-query candidate
    queue + visited hash becomes a [bq, beam] sorted beam + expanded bits).

    ``return_trail=True`` additionally returns the *expanded-node trail*
    ``(trail_d, trail_ids)`` of shape ``[bq, iters·expand]`` — every node
    the walk actually expanded, with its distance (sentinel n / +inf for
    exhausted slots). This is the batched analogue of DiskANN's visited
    set ``V`` (reference vamana.rs greedy_search returns it for the
    build's robust-prune pool, vamana.rs:427-559).

    ``vectors_hl`` — optional (hi, lo) bf16 mantissa-split copies of
    ``vectors``. Candidate-row gathers are the measured floor of an
    iteration (~70%) and run 3× faster from bf16 tables than f32 (HBM
    bandwidth-bound); two bf16 gathers + three mixed matmul terms
    (qh·xh + qh·xl + ql·xh, query split computed once, no gather) recover
    f32-grade scores at ~2/3 the gather cost.

    ``packed_nbrs`` — optional :func:`pack_neighbor_table` output. The
    per-iteration neighbour scores then come from ``expand`` contiguous
    multi-KB rows per query instead of ``expand·deg`` 64–128 B random
    reads (the measured iteration floor); entry scoring keeps the table
    path.

    Returns (dists [bq, k], ids [bq, k]) ascending; unreached slots have
    id = n and dist = inf.
    """
    bq = q.shape[0]
    n = vectors.shape[0] - 1
    deg = graph.shape[1]
    d_dim = q.shape[1]
    q_sq = sq_norms(q)
    if vectors_hl is not None or packed_nbrs is not None:
        from ..utils.dist import mantissa_split

        q_hi, q_lo = mantissa_split(q, 2)
    if vectors_hl is not None:
        x_hi, x_lo = vectors_hl

    def packed_dists(sel_ids, nbrs):
        bf = jnp.bfloat16
        rows = packed_nbrs[jnp.minimum(sel_ids, n)]  # [bq, e, deg·(2d+2)]
        rows = rows.reshape(bq, -1, 2 * d_dim + 2)   # [bq, e·deg, 2d+2]
        xh = rows[..., :d_dim].astype(bf)
        xl = rows[..., d_dim : 2 * d_dim].astype(bf)
        e = functools.partial(
            jnp.einsum, "qd,qcd->qc", preferred_element_type=jnp.float32
        )
        qh = q_hi.astype(bf)
        ql = q_lo.astype(bf)
        # all four terms: the lo·lo term costs no extra gather here (both
        # parts ride the packed row) and kills the systematic +2|x_lo|²
        # bias that 3-term scoring puts on near-zero distances (self-query
        # distances sat at ~2⁻⁸ without it)
        dots = e(qh, xh) + e(qh, xl) + e(ql, xh) + e(ql, xl)
        if metric == Dist.COSINE:
            d = 1.0 - dots
        else:
            nsq = rows[..., 2 * d_dim].astype(jnp.float32) + rows[
                ..., 2 * d_dim + 1
            ].astype(jnp.float32)
            d = jnp.maximum(q_sq[:, None] + nsq - 2.0 * dots, 0.0)
        return jnp.where(nbrs >= n, _INF, d)

    def cand_dists(cand):
        safe = jnp.minimum(cand, n)
        if vectors_hl is not None:
            ch = x_hi[safe]
            cl = x_lo[safe]
            e = functools.partial(
                jnp.einsum, "qd,qcd->qc",
                preferred_element_type=jnp.float32,
            )
            # all four terms: lo·lo costs no extra gather (both parts are
            # already fetched) and removes the +2|x_lo|² bias 3-term
            # scoring puts on near-zero distances (self-query ~4e-3 off
            # on 16-d clustered data without it)
            dots = e(q_hi, ch) + e(q_hi, cl) + e(q_lo, ch) + e(q_lo, cl)
        elif packed_nbrs is not None:
            # packed mode only reaches here for the (one-shot, few-entry)
            # beam init — score it at the packed path's f32 grade via an
            # on-the-fly split so init distances don't carry single-pass
            # bf16 error (~‖q‖‖x‖·2⁻⁹) into the final top-k
            from ..utils.dist import mantissa_split

            ch, cl = mantissa_split(vectors[safe], 2)
            e = functools.partial(
                jnp.einsum, "qd,qcd->qc",
                preferred_element_type=jnp.float32,
            )
            dots = e(q_hi, ch) + e(q_hi, cl) + e(q_lo, ch) + e(q_lo, cl)
        else:
            cv = vectors[safe]
            dots = jnp.einsum(
                "qd,qcd->qc",
                q.astype(jnp.bfloat16),
                cv.astype(jnp.bfloat16),
                preferred_element_type=jnp.float32,
            )
        if metric == Dist.COSINE:
            d = 1.0 - dots
        else:
            d = jnp.maximum(q_sq[:, None] + sqnorms[safe] - 2.0 * dots, 0.0)
        return jnp.where(cand >= n, _INF, d)

    # The beam is kept SORTED ascending at width P = pow2(beam); lanes
    # ≥ beam hold (inf, n, expanded) so the kept set is exactly the best
    # `beam` seen — identical semantics to the old top_k merge, but both
    # per-iteration selections become gather-free compare networks:
    #   select  = first `expand` unexpanded lanes of a sorted beam (cumsum)
    #   merge   = bitonic sort of C candidates + log2 bitonic merge
    # (lax.top_k + payload gathers were ~75% of iteration time.)
    #
    # P is the BEAM's pow2, not max(beam, C): candidates sort at their own
    # width CP and are then sliced to their best P lanes before the merge —
    # lossless, because only `beam` ≤ P entries ever survive a merge, and
    # the best P of the sorted candidates supersets any candidate that
    # could make the kept set. At the hnsw default (beam 100, C 192) the
    # old max() rule ran every beam-side network at 256 lanes for a
    # 128-lane beam — double-width sorts/merges/selects for lanes that
    # were inf by construction.
    C = expand * deg
    P = _next_pow2(beam)
    CP = _next_pow2(C)

    def trim(dd, ids_, exp_):
        # lanes ≥ beam are parked at inf so they never displace real
        # entries; they are already sorted to the tail
        lane = jnp.arange(P)[None, :] >= beam
        return (
            jnp.where(lane, _INF, dd),
            jnp.where(lane, n, ids_),
            exp_ | lane,
        )

    # init beam from entries
    e0 = entries.shape[1]
    init_ids = jnp.concatenate(
        [entries.astype(jnp.int32), jnp.full((bq, P - e0), n, jnp.int32)],
        axis=-1,
    )
    init_d = jnp.where(
        jnp.arange(P)[None, :] < e0, cand_dists(init_ids), _INF
    )
    init_d = _row_dedup_inf(init_ids, init_d)
    init_d, init_ids = bitonic_sort(init_d, init_ids)
    init_exp = init_ids >= n  # sentinels count as expanded
    init_d, init_ids, init_exp = trim(init_d, init_ids, init_exp)

    def body_core(state):
        ids, d, exp = state
        # pick the `expand` best unexpanded beam entries: the beam is
        # sorted, so these are the first `expand` lanes with exp == False
        unexp = ~exp
        rank = jnp.cumsum(unexp.astype(jnp.int32), axis=-1) - 1
        onehot = (
            rank[:, None, :] == jnp.arange(expand)[None, :, None]
        ) & unexp[:, None, :]                                  # [bq, e, P]
        found = jnp.any(onehot, axis=-1)
        sel_pos = jnp.sum(
            onehot * jnp.arange(P, dtype=jnp.int32)[None, None, :], axis=-1
        )
        sel_ids = jnp.take_along_axis(
            ids, jnp.where(found, sel_pos, 0), axis=-1
        )
        sel_ids = jnp.where(found, sel_ids, n)  # exhausted beam → sentinel
        sel_d = jnp.where(
            found,
            jnp.take_along_axis(d, jnp.where(found, sel_pos, 0), axis=-1),
            _INF,
        )
        exp = exp.at[
            jnp.arange(bq)[:, None], jnp.where(found, sel_pos, P)
        ].set(True, mode="drop")

        nbrs = graph[jnp.minimum(sel_ids, n)].reshape(bq, C)
        # dedup: against beam and within candidates
        if packed_nbrs is not None:
            nd = packed_dists(sel_ids, nbrs)
        else:
            nd = cand_dists(nbrs)
        in_beam = jnp.any(
            nbrs[:, :, None] == ids[:, None, :], axis=-1
        )
        nd = jnp.where(in_beam, _INF, nd)
        nd = _row_dedup_inf(nbrs, nd)

        nd = _pad_row(nd, CP, _INF)
        nbrs = _pad_row(nbrs, CP, jnp.int32(n))
        nd, nbrs = bitonic_sort(nd, nbrs)
        if CP > P:
            # best P of the sorted candidates — lossless (see P/CP note)
            nd, nbrs = nd[:, :P], nbrs[:, :P]
        elif CP < P:
            nd = _pad_row(nd, P, _INF)
            nbrs = _pad_row(nbrs, P, jnp.int32(n))
        md, mids, mexp = bitonic_merge_sorted(
            d, nd, [ids, exp], [nbrs, jnp.zeros_like(nbrs, bool)]
        )
        new_d, new_ids, new_exp = md[:, :P], mids[:, :P], mexp[:, :P]
        new_exp = new_exp | (new_ids >= n) | jnp.isinf(new_d)
        new_d, new_ids, new_exp = trim(new_d, new_ids, new_exp)
        return (new_ids, new_d, new_exp), sel_ids, sel_d

    if return_trail:
        def body_scan(state, _):
            new_state, sel_ids, sel_d = body_core(state)
            return new_state, (sel_ids, sel_d)

        (ids, d, _), (t_ids, t_d) = jax.lax.scan(
            body_scan, (init_ids, init_d, init_exp), None, length=iters
        )
        # [iters, bq, expand] → [bq, iters·expand]
        trail_ids = jnp.moveaxis(t_ids, 0, 1).reshape(bq, iters * expand)
        trail_d = jnp.moveaxis(t_d, 0, 1).reshape(bq, iters * expand)
    else:
        # while_loop with an all-expanded early exit: once every beam lane
        # is expanded the body is a no-op (nothing left to select), but a
        # fori_loop still pays full gather+sort cost for the remaining
        # iterations — at recall-saturating iteration counts the whole
        # batch converges well before the cap (identical final state, so
        # recall is bit-identical to the fori_loop's)
        def cond(carry):
            it, (ids_, d_, exp_) = carry
            return (it < iters) & jnp.any(~exp_)

        def body(carry):
            it, state = carry
            return it + 1, body_core(state)[0]

        _, (ids, d, _) = jax.lax.while_loop(
            cond, body, (jnp.int32(0), (init_ids, init_d, init_exp))
        )
    # beam is sorted ascending — final top-k is a slice
    if k <= P:
        out = d[:, :k], ids[:, :k]
    else:
        top_d, pos = jax.lax.top_k(-d, k)
        out = -top_d, jnp.take_along_axis(ids, pos, axis=-1)
    if vectors_hl is None and packed_nbrs is None:
        # Both f32-grade scoring paths are gated off (the ≥ 3–4 GiB table
        # regime, e.g. 10M×128d past the ANNSEARCH_HL_BYTES /
        # ANNSEARCH_NBR_PACK_BYTES budgets): the walk scored candidates in
        # single-pass bf16 (~‖q‖‖x‖·2⁻⁹ dot error), which mis-selects and
        # mis-orders near-tie neighbours in the FINAL top-k even when the
        # trajectory itself is fine. Re-score a 2k-wide pool of the final
        # sorted beam ELEMENTWISE in f32 (VPU — exact at any table size,
        # ~2k·d flops/query, one tiny gather) and re-select k at f32 grade.
        pool = min(P, max(k, 2 * k))
        if k <= P:
            pd, pi = d[:, :pool], ids[:, :pool]
        else:
            pd, pi = out
            pool = k
        rows = vectors[jnp.minimum(pi, n)]
        if metric == Dist.COSINE:
            rd = 1.0 - jnp.sum(q[:, None, :] * rows, axis=-1)
        else:
            rd = jnp.sum(jnp.square(q[:, None, :] - rows), axis=-1)
        rd = jnp.where(pi >= n, _INF, rd)
        nt, npos = jax.lax.top_k(-rd, k)
        out = -nt, jnp.take_along_axis(pi, npos, axis=-1)
    if return_trail:
        return out[0], out[1], trail_d, trail_ids
    return out
