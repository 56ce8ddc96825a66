"""Quantisers: bf16 codec, scalar (SQ8), product (PQ), optimised product (OPQ).

JAX rebuild of the reference's quantiser layer
(``src/quantised/quantisers.rs``). Same semantics, tensor-core-shaped internals:

  * bf16 — native tensor-core dtype; the codec is a cast (reference bit-shifts
    bf16↔f32 in-register, quantisers.rs:31-91).
  * SQ8 — per-dim symmetric scale ``max|x|/128`` → int8
    (quantisers.rs:103-192). Distances are computed *in quantised integer
    space* (reference ``VectorDistanceSq8``, utils/dist.rs:4228-4324), which
    is an int8×int8→int32 matmul.
  * PQ — ``m`` sub-spaces × 256 centroids (quantisers.rs:199-460); training
    via D²-seeded Lloyd (full batch ≤10k rows, else mini-batch — reference
    quantised/k_means.rs); encode via per-subspace GEMM argmin.
  * OPQ — alternating rotation/codebook optimisation: 3 rounds of
    {rotate → train PQ → reconstruct → Procrustes SVD} on a ≤50k sample,
    then a final full train (quantisers.rs:476-846).

Query-side PQ scans do NOT use LUT gathers (scattered memory reads): see
``ops/quantised.py`` for the decode-by-one-hot-matmul design that is
mathematically identical to ADC but rides the tensor cores.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ...utils.dist import Dist, sq_norms
from ..kmeans import train_centroids_minibatch, _dsq_seed_init, _lloyd

__all__ = [
    "bf16_encode",
    "bf16_decode",
    "ScalarQuantiser",
    "ProductQuantiser",
    "OptimisedProductQuantiser",
    "N_CLUSTERS_PQ",
]

#: sub-codebook size (fits u8 codes; reference N_CLUSTERS_PQ, quantisers.rs:199)
N_CLUSTERS_PQ = 256

#: full-batch Lloyd cutoff for PQ codebooks (reference quantised/k_means.rs)
PQ_FULL_LLOYD_MAX_N = 10_000

#: OPQ: alternating iterations and training-sample cap (quantisers.rs:202, 476)
OPQ_ITER = 3
OPQ_SAMPLE_CAP = 50_000


def bf16_encode(x: jax.Array) -> jax.Array:
    return x.astype(jnp.bfloat16)


def bf16_decode(x: jax.Array) -> jax.Array:
    return x.astype(jnp.float32)


# ---------------------------------------------------------------------------
# SQ8
# ---------------------------------------------------------------------------


class ScalarQuantiser:
    """Per-dimension symmetric int8 quantiser.

    ``scales[d] = max|x[:, d]| / 128`` (1.0 where a dim is all-zero);
    encode rounds-half-away-from-zero and clamps to [-128, 127] — matching
    the reference's encode (quantisers.rs:152-163).
    """

    def __init__(self, scales: jax.Array):
        self.scales = scales  # [d] f32

    @classmethod
    def train(cls, x: jax.Array) -> "ScalarQuantiser":
        maxabs = jnp.max(jnp.abs(x), axis=0)
        scales = jnp.where(maxabs > 0, maxabs / 128.0, 1.0)
        return cls(scales)

    def encode(self, x: jax.Array) -> jax.Array:
        scaled = x / self.scales
        rounded = jnp.trunc(scaled + 0.5 * jnp.sign(scaled))
        return jnp.clip(rounded, -128, 127).astype(jnp.int8)

    def decode(self, codes: jax.Array) -> jax.Array:
        return codes.astype(jnp.float32) * self.scales

    def memory_usage_bytes(self) -> int:
        return int(self.scales.size) * 4


# ---------------------------------------------------------------------------
# PQ
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("k", "iters"))
def _train_scalar_codebooks(v: jax.Array, k: int, iters: int = 25) -> jax.Array:
    """Batched 1-d k-means over every subspace at once (the ds = dim/m == 1
    case, e.g. m = dim), all m subspaces in ONE device program.

    Sort-once formulation: rows are sorted up front, so each Lloyd iteration
    only needs the bin-boundary *positions* — a chunked compare-count
    against the midpoints — and per-bin sums fall out of prefix-sum
    differences. No scatters and no per-element binary search (the vmapped
    searchsorted + segment_sum loop failed at benchmark scale, and
    scatters are far off the vector units' fast path anyway).

    v: [m, n] -> codebooks [m, k, 1] (sorted ascending per row).
    """
    m, n = v.shape
    CH = min(2048, 1 << (max(n, 1) - 1).bit_length())
    pad = (-n) % CH
    vs = jnp.sort(v, axis=1)                             # [m, n]
    vs_p = (
        jnp.concatenate([vs, jnp.full((m, pad), 3e38, v.dtype)], axis=1)
        if pad else vs
    )
    cums = jnp.concatenate(
        [jnp.zeros((m, 1), jnp.float32), jnp.cumsum(vs, axis=1)], axis=1
    )                                                    # [m, n+1]
    # quantile init straight off the sorted rows
    qidx = jnp.clip(
        (jnp.linspace(0.5 / k, 1.0 - 0.5 / k, k) * (n - 1)).astype(jnp.int32),
        0, n - 1,
    )
    c = vs[:, qidx]                                      # [m, k]
    chunks = vs_p.reshape(m, -1, CH).transpose(1, 0, 2)  # [nch, m, CH]

    def body(_, c):
        bounds = (c[:, 1:] + c[:, :-1]) * 0.5            # [m, k-1]

        def count(carry, vc):                            # vc [m, CH]
            return carry + jnp.sum(
                vc[:, :, None] < bounds[:, None, :], axis=1,
                dtype=jnp.int32,
            ), None

        pos0, _ = jax.lax.scan(
            count, jnp.zeros((m, k - 1), jnp.int32), chunks
        )
        pos = jnp.concatenate(
            [jnp.zeros((m, 1), jnp.int32), pos0,
             jnp.full((m, 1), n, jnp.int32)], axis=1
        )                                                # [m, k+1]
        cnt = (pos[:, 1:] - pos[:, :-1]).astype(jnp.float32)
        csel = jnp.take_along_axis(cums, pos, axis=1)
        sums = csel[:, 1:] - csel[:, :-1]
        c_new = jnp.where(cnt > 0, sums / jnp.maximum(cnt, 1.0), c)
        # re-sort so the midpoint assignment stays valid
        return jnp.sort(c_new, axis=1)

    c = jax.lax.fori_loop(0, iters, body, c)
    return c[:, :, None]


@functools.partial(jax.jit, static_argnames=("k", "max_iters"))
def _train_subspace_codebooks_batched(
    xs: jax.Array, k: int, seed: int, max_iters: int = 25
) -> jax.Array:
    """Train ALL m sub-codebooks in ONE device program.

    ``xs: [m, n, ds] → codebooks [m, k, ds]`` — a vmap over the subspace
    axis of the same D²-seed + (full Lloyd for n ≤ 10k, else Sculley
    mini-batch) recipe the reference runs per subspace
    (quantised/k_means.rs:14-334). The per-subspace dispatch loop this
    replaces serialized m host→device round-trips; one program lets XLA
    overlap the m independent Lloyd chains.
    """
    m, n, _ = xs.shape
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.key(seed), jnp.arange(m, dtype=jnp.uint32)
    )
    init = jax.vmap(lambda kk, xv: _dsq_seed_init(kk, xv, k))(keys, xs)
    if n <= PQ_FULL_LLOYD_MAX_N:
        c = jax.vmap(
            lambda xv, iv: _lloyd(
                xv, iv, k, max_iters, 1e-5, spherical=False, chunk=8192
            )[0]
        )(xs, init)
    else:
        seeds = seed + jnp.arange(m, dtype=jnp.int32)
        c = jax.vmap(
            lambda xv, iv, s: train_centroids_minibatch(
                xv, iv, k, iters=max_iters, batch=10_240, seed=s
            )
        )(xs, init, seeds)
    return c


@functools.partial(jax.jit, static_argnames=("chunk",))
def _encode_pq(
    x: jax.Array, codebooks: jax.Array, chunk: int = 16384
) -> jax.Array:
    """Per-subspace GEMM argmin encode (reference encode_batch GEMM
    ``−2XCᵀ+‖c‖²`` argmin, quantisers.rs:404-459).

    x: [n, d], codebooks: [m, 256, ds] → codes [n, m] uint8.
    """
    n, d = x.shape
    m = codebooks.shape[0]
    ds = d // m
    pad = (-n) % chunk
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad, d), x.dtype)])
    xs = x.reshape(-1, chunk, m, ds)
    c_sq = jnp.sum(codebooks**2, axis=-1)  # [m, 256]

    def block(xb):  # [chunk, m, ds]
        # dots[j]: [chunk, 256] for each subspace via batched matmul
        dots = jnp.einsum(
            "cjd,jkd->cjk", xb, codebooks, preferred_element_type=jnp.float32
        )
        dist = c_sq[None, :, :] - 2.0 * dots  # ‖x‖² constant per argmin
        return jnp.argmin(dist, axis=-1).astype(jnp.uint8)

    codes = jax.lax.map(block, xs)
    return codes.reshape(-1, m)[:n]


class ProductQuantiser:
    """Product quantiser: ``m`` sub-spaces × 256 centroids.

    Asserts dim % m == 0 and dim ≥ 32 (reference quantisers.rs:258-263).
    """

    def __init__(self, codebooks: jax.Array, m: int, dim: int):
        self.codebooks = codebooks  # [m, 256, dim//m] f32
        self.m = m
        self.dim = dim

    @classmethod
    def train(
        cls, x: jax.Array, m: int, seed: int = 42, max_iters: int = 25
    ) -> "ProductQuantiser":
        n, d = x.shape
        if d % m != 0:
            raise ValueError(f"dim {d} not divisible by m={m}")
        if d < 32:
            raise ValueError("PQ requires dim >= 32")
        ds = d // m
        if ds == 1:
            # train the scalar codebooks on a ≤256k row sample — same policy
            # as the coarse k-means (train_sample_size); ample for 256
            # scalar centroids, and the full-n searchsorted/segment-sum loop
            # at 1M rows overwhelms the worker
            xs_in = jnp.asarray(x)
            cap = 262_144
            if n > cap:
                step = n // cap
                xs_in = xs_in[:: step][:cap]
            books = _train_scalar_codebooks(
                xs_in.T, min(N_CLUSTERS_PQ, n), iters=max_iters
            )
            if books.shape[1] < N_CLUSTERS_PQ:
                pad = jnp.full(
                    (m, N_CLUSTERS_PQ - books.shape[1], 1), 1e30, jnp.float32
                )
                books = jnp.concatenate([books, pad], axis=1)
            return cls(books, m, d)
        xs = jnp.asarray(x).reshape(n, m, ds).transpose(1, 0, 2)  # [m, n, ds]
        k = min(N_CLUSTERS_PQ, n)
        books = _train_subspace_codebooks_batched(xs, k, seed, max_iters)
        if k < N_CLUSTERS_PQ:
            # pad unused rows far away so they are never argmin-selected
            pad = jnp.full((m, N_CLUSTERS_PQ - k, ds), 1e30, jnp.float32)
            books = jnp.concatenate([books, pad], axis=1)
        return cls(books, m, d)

    def encode(self, x: jax.Array) -> jax.Array:
        return _encode_pq(x, self.codebooks)

    def decode(self, codes: jax.Array) -> jax.Array:
        """Gather decode — fine off the hot path (tests, reconstruction)."""
        m, ds = self.m, self.dim // self.m
        if ds == 1:
            return self.codebooks[:, :, 0][
                jnp.arange(m)[None, :], codes.astype(jnp.int32)
            ]
        parts = [
            jnp.take(self.codebooks[j], codes[:, j].astype(jnp.int32), axis=0)
            for j in range(m)
        ]
        return jnp.concatenate(parts, axis=-1)

    def code_sqnorms(self, codes: jax.Array) -> jax.Array:
        """‖decode(code)‖² per row — sub-space sqnorm LUT gathers, once at
        encode time."""
        sn = jnp.sum(self.codebooks**2, axis=-1)  # [m, 256]
        total = jnp.zeros((codes.shape[0],), jnp.float32)
        for j in range(self.m):
            total = total + jnp.take(sn[j], codes[:, j].astype(jnp.int32))
        return total

    def memory_usage_bytes(self) -> int:
        return int(self.codebooks.size) * 4


# ---------------------------------------------------------------------------
# OPQ
# ---------------------------------------------------------------------------


class OptimisedProductQuantiser:
    """OPQ: learned orthogonal rotation + PQ.

    Alternating optimisation (reference quantisers.rs:476-846): for
    ``OPQ_ITER`` rounds on a ≤50k sample — rotate data, train PQ, encode +
    reconstruct, solve the Procrustes problem ``min_R ‖XR − Y‖`` via SVD of
    ``XᵀY`` — then train the final codebooks on the fully rotated data.
    """

    def __init__(self, pq: ProductQuantiser, rotation: jax.Array):
        self.pq = pq
        self.rotation = rotation  # [d, d]
        self.m = pq.m
        self.dim = pq.dim

    @classmethod
    def train(
        cls, x: jax.Array, m: int, seed: int = 42, max_iters: int = 25
    ) -> "OptimisedProductQuantiser":
        n, d = x.shape
        key = jax.random.key(seed)
        if n > OPQ_SAMPLE_CAP:
            idx = jax.random.choice(key, n, (OPQ_SAMPLE_CAP,), replace=False)
            xs = x[idx]
        else:
            xs = x

        rot = jnp.eye(d, dtype=jnp.float32)
        for it in range(OPQ_ITER):
            xr = xs @ rot
            pq = ProductQuantiser.train(xr, m, seed=seed + 1000 * it, max_iters=10)
            y = pq.decode(pq.encode(xr))
            # Procrustes: max tr(Rᵀ XᵀY) → R = U Vᵀ of XᵀY
            u, _, vh = jnp.linalg.svd(xs.T @ y, full_matrices=False)
            rot = u @ vh

        pq = ProductQuantiser.train(x @ rot, m, seed=seed, max_iters=max_iters)
        return cls(pq, rot)

    def rotate(self, x: jax.Array) -> jax.Array:
        return x @ self.rotation

    def encode(self, x: jax.Array) -> jax.Array:
        return self.pq.encode(self.rotate(x))

    def decode(self, codes: jax.Array) -> jax.Array:
        """Decode to the *original* (un-rotated) space."""
        return self.pq.decode(codes) @ self.rotation.T

    def memory_usage_bytes(self) -> int:
        return self.pq.memory_usage_bytes() + int(self.rotation.size) * 4
