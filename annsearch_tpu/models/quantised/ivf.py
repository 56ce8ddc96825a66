"""IVF quantised indexes: bf16 / SQ8 / PQ (residual) / OPQ (residual+rotation).

JAX rebuild of the reference's quantised IVF family
(``src/quantised/ivf_bf16.rs`` / ``ivf_sq8.rs`` / ``ivf_pq.rs`` /
``ivf_opq.rs``): float-centroid routing, cluster-contiguous compressed
storage, cell scans in the quantised domain. Routing/segments/scan plumbing
lives in :class:`annsearch_tpu.models.ivf_base.IvfBase`; these classes only
define how cells are encoded and how queries enter the scoring space.

Residual encoding for PQ/OPQ matches the reference (ivf_pq.rs:195-274):
codebooks are trained on ``vec − centroid``; OPQ additionally learns an
orthogonal rotation on the residuals (ivf_opq.rs) — at query time everything
is evaluated in the rotated space, which is distance-preserving.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ...utils.dist import Dist, sq_norms
from ..ivf_base import IvfBase, route_to_cells
from .quantisers import (
    OptimisedProductQuantiser,
    ProductQuantiser,
    ScalarQuantiser,
)

__all__ = [
    "IvfIndexBf16",
    "IvfSq8Index",
    "IvfPqIndex",
    "IvfOpqIndex",
    "route_to_cells",
]


class IvfIndexBf16(IvfBase):
    """IVF routing (f32 centroids) + bf16 cells (reference ivf_bf16.rs)."""

    mode = "bf16"

    def _encode_storage(self, x_sorted, seed):
        s16 = x_sorted.astype(jnp.bfloat16)
        self._pad_storage(s16, sq_norms(s16.astype(jnp.float32)))

    def _decoded_sorted(self) -> np.ndarray:
        return np.asarray(self.storage[: self.n].astype(jnp.float32))

    def _post_load_hook(self):
        super()._post_load_hook()
        self.storage = self.storage.astype(jnp.bfloat16)


class IvfSq8Index(IvfBase):
    """IVF routing + global-SQ8 int8 cells, integer-space distances
    (reference ivf_sq8.rs: cosine pre-normalises data+centroids :159-197,
    quantised i32 norms :241-248)."""

    mode = "sq8"
    _state_arrays = IvfBase._state_arrays + ("scales",)

    def _encode_storage(self, x_sorted, seed):
        self.quantiser = ScalarQuantiser.train(x_sorted)
        self.scales = self.quantiser.scales
        codes = self.quantiser.encode(x_sorted)
        c32 = codes.astype(jnp.int32)
        self._pad_storage(codes, jnp.sum(c32 * c32, axis=-1))

    def _encode_queries(self, q):
        return self.quantiser.encode(q)

    def _decoded_sorted(self) -> np.ndarray:
        return np.asarray(self.quantiser.decode(self.storage[: self.n]))

    def _post_load_hook(self):
        super()._post_load_hook()
        self.quantiser = ScalarQuantiser(self.scales)


class IvfPqIndex(IvfBase):
    """IVF + residual PQ (reference ivf_pq.rs:23-531): codebooks trained on
    ``vec − centroid``, ADC-equivalent residual scoring per probed cell.

    ``ds = dim/m == 1`` (scalar sub-codebooks) takes the **int8 fast-scan**
    path: the decoded residuals are requantised per-dim to int8 at build
    (error ≤ absmax/254 — far below the PQ error) and the scan becomes a
    pure int8→bf16 matmul with zero decode work. Same bytes per vector as
    the u8 codes; the matmul analogue of FAISS's PQ fast-scan relayout."""

    mode = "pq_residual"
    _state_arrays = IvfBase._state_arrays + ("codebooks", "dec_scales")
    _state_scalars = IvfBase._state_scalars + ("m",)

    def __init__(self, mat, metric="euclidean", nlist=None, m: int = 16, **kw):
        super().__init__(mat, metric, nlist=nlist, m=m, **kw)

    #: rows per encode chunk — bounds the f32 transients (residuals /
    #: decoded reconstructions) to ~256 MB at d=128, so a 10M-row build
    #: never holds a full [n, d] f32 residual tensor next to the database
    ENCODE_CHUNK = 1 << 19

    #: receive (x, order) instead of a materialised x_sorted — sorted rows
    #: are gathered per encode chunk (ivf_base.IvfBase.__init__)
    _encode_lazy = True

    @staticmethod
    def _row_chunk(x_ord, s, e):
        x, order = x_ord
        return x[order[s:e]]

    def _train_sample_residuals(self, x_ord, owner, cap: int = 1 << 18):
        """Residuals of ≤``cap`` stride-sampled sorted rows (never the
        full [n, d] f32 tensor — quantiser training subsamples anyway)."""
        x, order = x_ord
        n = order.shape[0]
        idx = jnp.arange(0, n, max(1, -(-n // cap)))
        return x[order[idx]] - self.centroids[owner[idx]]

    def _encode_chunked(self, x_ord, owner, encode_fn):
        """Run residual → ``encode_fn`` over bounded row chunks and
        concatenate (codes/int8 plus per-chunk sqnorms)."""
        n = x_ord[1].shape[0]
        outs, sns = [], []
        for s in range(0, n, self.ENCODE_CHUNK):
            e = min(n, s + self.ENCODE_CHUNK)
            res = self._row_chunk(x_ord, s, e) - self.centroids[owner[s:e]]
            out, sn = encode_fn(res, owner[s:e])
            outs.append(out)
            sns.append(sn)
        if len(outs) == 1:
            return outs[0], sns[0]
        return jnp.concatenate(outs), jnp.concatenate(sns)

    def _encode_storage(self, x_ord, seed, m: int = 16):
        self.m = m
        self.dec_scales = None
        owner = self._owner_clusters()
        self.quantiser = ProductQuantiser.train(
            self._train_sample_residuals(x_ord, owner), m, seed=seed
        )
        self.codebooks = self.quantiser.codebooks
        if self.dim == m:
            # scales from the codebooks themselves (decoded values ARE
            # codebook entries, so per-dim |max| over entries bounds them)
            absmax = jnp.maximum(
                jnp.max(jnp.abs(self.codebooks[:, :, 0]), axis=1), 1e-12
            )
            self.dec_scales = (absmax / 127.0).astype(jnp.float32)
            self.mode = "i8dec_residual"

            def enc(res, own):
                dec = self.quantiser.decode(self.quantiser.encode(res))
                dec8 = jnp.clip(
                    jnp.round(dec / self.dec_scales[None, :]), -127, 127
                ).astype(jnp.int8)
                rec = dec8.astype(jnp.float32) * self.dec_scales[None, :]
                return dec8, self._recon_sqnorms_of(rec, own)

        else:

            def enc(res, own):
                codes = self.quantiser.encode(res)
                return codes, self._recon_sqnorms_of(
                    self.quantiser.decode(codes), own
                )

        self._pad_storage(*self._encode_chunked(x_ord, owner, enc))

    def _recon_sqnorms(self, codes, owner):
        return self._recon_sqnorms_of(self.quantiser.decode(codes), owner)

    def _recon_sqnorms_of(self, dec_res, owner):
        """euclidean: ‖dec_res‖² (the residual-distance identity term);
        cosine: ‖centroid + dec_res‖² (to renormalise the reconstruction)."""
        if self.metric == Dist.COSINE:
            return sq_norms(dec_res + self.centroids[owner])
        return sq_norms(dec_res)

    def _codebooks(self):
        # the scan's codebooks slot carries the [d] scales in fast-scan mode
        if self.mode == "i8dec_residual":
            return self.dec_scales
        return self.codebooks

    def _decoded_sorted(self) -> np.ndarray:
        owner = np.asarray(self._owner_clusters())
        if self.mode == "i8dec_residual":
            dec = np.asarray(self.storage[: self.n], np.float32) * np.asarray(
                self.dec_scales
            )
        else:
            dec = np.asarray(self.quantiser.decode(self.storage[: self.n]))
        return dec + np.asarray(self.centroids)[owner]

    def _post_load_hook(self):
        super()._post_load_hook()
        self.m = int(self.m)
        self.quantiser = ProductQuantiser(self.codebooks, self.m, self.dim)
        if self.dec_scales is not None:
            self.mode = "i8dec_residual"
            self.storage = self.storage.astype(jnp.int8)




class IvfOpqIndex(IvfPqIndex):
    """IVF + residual OPQ (reference ivf_opq.rs): an orthogonal rotation is
    learned on the residuals; cells store PQ codes of rotated residuals and
    queries/centroids are rotated at scan time (distance-preserving)."""

    mode = "pq_residual"
    _state_arrays = IvfPqIndex._state_arrays + ("rotation",)

    def _encode_storage(self, x_ord, seed, m: int = 16):
        self.m = m
        self.dec_scales = None
        owner = self._owner_clusters()
        opq = OptimisedProductQuantiser.train(
            self._train_sample_residuals(x_ord, owner), m, seed=seed
        )
        self.opq = opq
        self.rotation = opq.rotation
        self.codebooks = opq.pq.codebooks
        self.quantiser = opq.pq
        if self.dim == m:
            # int8 fast-scan cache of the rotated-space reconstructions
            # (scoring already happens in the rotated space)
            absmax = jnp.maximum(
                jnp.max(jnp.abs(self.codebooks[:, :, 0]), axis=1), 1e-12
            )
            self.dec_scales = (absmax / 127.0).astype(jnp.float32)
            self.mode = "i8dec_residual"

            def enc(res, own):
                dec = opq.pq.decode(opq.encode(res))
                dec8 = jnp.clip(
                    jnp.round(dec / self.dec_scales[None, :]), -127, 127
                ).astype(jnp.int8)
                rec = dec8.astype(jnp.float32) * self.dec_scales[None, :]
                if self.metric == Dist.COSINE:
                    sn = sq_norms(rec + self.centroids[own] @ self.rotation)
                else:
                    sn = sq_norms(rec)
                return dec8, sn

        else:

            def enc(res, own):
                codes = opq.encode(res)
                if self.metric == Dist.COSINE:
                    # norms in rotated space equal norms in original space
                    sn = sq_norms(
                        opq.pq.decode(codes)
                        + self.centroids[own] @ self.rotation
                    )
                else:
                    sn = opq.pq.code_sqnorms(codes)
                return codes, sn

        self._pad_storage(*self._encode_chunked(x_ord, owner, enc))

    def _encode_queries(self, q):
        # routing stays in the original space (IvfBase routes before this);
        # scoring happens in the rotated space
        return q @ self.rotation

    def _scan_seg_centroids(self):
        return self.seg_centroids @ self.rotation

    def _decoded_sorted(self) -> np.ndarray:
        owner = np.asarray(self._owner_clusters())
        if self.mode == "i8dec_residual":
            # storage holds rotated-space int8 reconstructions
            rec = np.asarray(self.storage[: self.n], np.float32) * np.asarray(
                self.dec_scales
            )
            dec = rec @ np.asarray(self.rotation).T
        else:
            dec = np.asarray(self.opq.decode(self.storage[: self.n]))
        return dec + np.asarray(self.centroids)[owner]

    def _post_load_hook(self):
        super()._post_load_hook()
        self.opq = OptimisedProductQuantiser(self.quantiser, self.rotation)
