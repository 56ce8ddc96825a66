"""Exact reranking of gathered candidates.

Two-stage search support (reference: exhaustive_binary.rs:374-424 /
ivf_binary.rs exact-rerank tier): a cheap scan proposes ``k·rerank_factor``
candidates, their full-precision vectors are gathered from a vector store,
and one batched distance einsum re-scores them exactly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..utils.dist import Dist, sq_norms

__all__ = ["rerank_exact", "rerank_exact_split", "rerank_from_store"]

_INF = jnp.float32(jnp.inf)


def _dedup_select(
    ids: jax.Array, d: jax.Array, k: int
) -> tuple[jax.Array, jax.Array]:
    """Top-k of (d, ids) with duplicate ids inf'd out (multi-tree /
    multi-probe unions overlap; without this top-k could return the same
    id twice). ONE argsort: dedup marks run in id-sorted order and top-k
    runs directly on the sorted arrays — selection is order-free, so the
    inverse permutation (a second argsort over the full candidate width,
    ~¼ of tree-query time) is never materialised."""
    # two-key sort: (id asc, dist asc) — the head of each equal-id run is
    # the BEST copy, so inf'ing the rest never shadows a real candidate
    # with a clamped-padding copy of the same id (the old argsort-by-id
    # scheme kept whichever copy sorted first)
    s_ids, s_d = jax.lax.sort((ids, d), dimension=-1, num_keys=2)
    dup = jnp.concatenate(
        [
            jnp.zeros(s_ids.shape[:-1] + (1,), bool),
            s_ids[..., 1:] == s_ids[..., :-1],
        ],
        axis=-1,
    )
    s_d = jnp.where(dup, _INF, s_d)
    nd, pos = jax.lax.top_k(-s_d, min(k, s_d.shape[-1]))
    return -nd, jnp.take_along_axis(s_ids, pos, axis=-1)


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def rerank_exact(
    q: jax.Array,          # [nq, d] (normalised if cosine)
    cand_vecs: jax.Array,  # [nq, kc, d] gathered full-precision candidates
    cand_ids: jax.Array,   # [nq, kc] int32
    valid: jax.Array,      # [nq, kc] bool
    k: int,
    metric: Dist,
) -> tuple[jax.Array, jax.Array]:
    """Exact distances to candidates, top-k ascending → (dists, ids)."""
    # HIGHEST: "exact rerank" must actually be exact — DEFAULT may lower f32
    # einsums to a reduced-precision pass (TF32 on a GPU), whose dot error
    # scrambles fine orderings (RaBitQ recall then falls as rerank_factor
    # grows)
    dots = jnp.einsum(
        "qd,qcd->qc", q, cand_vecs, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    if metric == Dist.COSINE:
        vn = jnp.sqrt(jnp.maximum(jnp.sum(cand_vecs * cand_vecs, -1), 1e-30))
        d = 1.0 - dots / vn
    else:
        d = jnp.maximum(
            sq_norms(q)[:, None] + jnp.sum(cand_vecs * cand_vecs, -1) - 2.0 * dots,
            0.0,
        )
    d = jnp.where(valid, d, _INF)
    return _dedup_select(cand_ids, d, k)


def rerank_exact_split(
    q: jax.Array,            # [nq, d] f32 (normalised if cosine)
    vec_hl: tuple,           # (hi, lo) bf16 tables [n+1, d] (mantissa split)
    sqnorms: jax.Array,      # [n+1] f32 ‖row‖² (0 for the sentinel row)
    cand_ids: jax.Array,     # [nq, kc] int32 (sentinel-safe, < n+1)
    valid: jax.Array,        # [nq, kc] bool
    k: int,
    metric: Dist,
) -> tuple[jax.Array, jax.Array]:
    """f32-grade rerank that gathers bf16 hi/lo split tables instead of f32
    rows — the candidate gather is the bound at tree/graph rerank volumes,
    and gathering precomputed ``sqnorms`` replaces the full ‖cand‖²
    reduction over the gathered tensor. Dot error ~2⁻²² rel (three bf16
    cross terms, `utils/dist.mantissa_split`)."""
    from ..utils.dist import mantissa_split

    vh, vl = vec_hl
    nh = vh[cand_ids]
    nl = vl[cand_ids]
    qh, ql = mantissa_split(q, 2)
    e = functools.partial(
        jnp.einsum, "qd,qcd->qc", preferred_element_type=jnp.float32
    )
    dots = e(qh, nh) + e(qh, nl) + e(ql, nh)
    csq = sqnorms[cand_ids]
    if metric == Dist.COSINE:
        d = 1.0 - dots
    else:
        d = jnp.maximum(sq_norms(q)[:, None] + csq - 2.0 * dots, 0.0)
    d = jnp.where(valid, d, _INF)
    return _dedup_select(cand_ids, d, k)


@functools.partial(jax.jit, static_argnames=("k", "metric", "qb"))
def rerank_from_store(
    q: jax.Array,        # [nq, d] (normalised if cosine)
    cand_d: jax.Array,   # [nq, kc] scan distances (inf = invalid slot)
    cand_i: jax.Array,   # [nq, kc] int32 row positions into ``store``
    store: jax.Array,    # [n(+pad), d] f32 device-resident vectors
    k: int,
    metric: Dist,
    qb: int = 512,
) -> tuple[jax.Array, jax.Array]:
    """Device-resident exact rerank: gather candidate rows from ``store``
    and re-score, blocked over queries inside ONE compiled program.

    The host-orchestrated equivalent (read back [nq, kc] candidates, then
    re-dispatch gather+rerank per block) pays a multi-MB link round-trip plus
    ~2 dispatches per block (reference rerank tier:
    exhaustive_binary.rs:374-424 runs in-process and never pays this). Returns
    (dists [nq,k], ids [nq,k]).
    """
    nq, kc = cand_i.shape
    qb = min(qb, max(nq, 8))
    pad = (-nq) % qb
    if pad:
        q = jnp.concatenate([q, jnp.zeros((pad, q.shape[1]), q.dtype)])
        cand_d = jnp.concatenate(
            [cand_d, jnp.full((pad, kc), _INF, cand_d.dtype)]
        )
        cand_i = jnp.concatenate(
            [cand_i, jnp.zeros((pad, kc), cand_i.dtype)]
        )

    def blk(args):
        qq, dd, ii = args
        iic = jnp.clip(ii, 0, store.shape[0] - 1)
        vecs = store[iic]  # [qb, kc, d] stays in HBM — never crosses the link
        return rerank_exact(qq, vecs, iic, jnp.isfinite(dd), k, metric)

    d, i = jax.lax.map(
        blk,
        (
            q.reshape(-1, qb, q.shape[1]),
            cand_d.reshape(-1, qb, kc),
            cand_i.reshape(-1, qb, kc),
        ),
    )
    return d.reshape(-1, k)[:nq], i.reshape(-1, k)[:nq]
