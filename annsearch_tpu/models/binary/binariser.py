"""Binarisers: SimHash, PCA-hash, and sign-based vector→bits encoders.

JAX rebuild of the reference ``Binariser``
(``src/binary/binariser.rs:20-460``), three init modes:

  * ``simhash`` — orthogonalised Gaussian hyperplane projections
    (reference Gram-Schmidt :84-143; here QR on device, block-wise when
    n_bits > dim so every block is orthonormal);
  * ``pca``     — thin-SVD loadings of a ≤100k mean-centred sample, with
    random-projection padding for excess bits (:182-242);
  * ``sign``    — bit per dimension, ``x > 0`` (n_bits = dim, :311-324).

Bits are packed into uint32 words (``ops/binary.pack_bits``). The projection
matrix also serves the asymmetric query path (float query projected into
hyperplane space vs ±1 codes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ...ops.binary import pack_bits

__all__ = ["Binariser", "BINARISATION_MODES"]

BINARISATION_MODES = ("simhash", "pca", "sign")
PCA_SAMPLE_CAP = 100_000


def _orthogonal_projections(key, dim: int, n_bits: int) -> jax.Array:
    """[dim, n_bits] projection matrix; each dim-sized block of columns is
    orthonormal (QR of Gaussian blocks)."""
    cols = []
    remaining = n_bits
    while remaining > 0:
        key, kb = jax.random.split(key)
        g = jax.random.normal(kb, (dim, min(dim, remaining)), jnp.float32)
        qm, _ = jnp.linalg.qr(g)
        cols.append(qm[:, : min(dim, remaining)])
        remaining -= min(dim, remaining)
    return jnp.concatenate(cols, axis=1)


class Binariser:
    """Vector → packed-bit encoder."""

    def __init__(
        self,
        projections: jax.Array | None,  # [dim, n_bits] or None for sign mode
        mean: jax.Array | None,
        n_bits: int,
        mode: str,
    ):
        self.projections = projections
        self.mean = mean
        self.n_bits = n_bits
        self.mode = mode
        self.n_words = (n_bits + 31) // 32

    @classmethod
    def train(
        cls,
        x: jax.Array,
        n_bits: int | None = None,
        mode: str = "simhash",
        seed: int = 42,
    ) -> "Binariser":
        mode = mode.lower()
        if mode not in BINARISATION_MODES:
            raise ValueError(f"unknown binarisation mode {mode!r}")
        n, dim = x.shape

        if mode == "sign":
            return cls(None, None, dim, "sign")

        if n_bits is None:
            n_bits = dim
        key = jax.random.key(seed)

        if mode == "simhash":
            proj = _orthogonal_projections(key, dim, n_bits)
            return cls(proj, None, n_bits, "simhash")

        # pca: loadings of a mean-centred sample, random-pad excess bits
        if n > PCA_SAMPLE_CAP:
            key, ks = jax.random.split(key)
            idx = jax.random.choice(ks, n, (PCA_SAMPLE_CAP,), replace=False)
            xs = x[idx]
        else:
            xs = x
        mean = jnp.mean(xs, axis=0)
        _, _, vh = jnp.linalg.svd(xs - mean, full_matrices=False)
        v = vh.T[:, : min(dim, n_bits)]  # [dim, min(dim, n_bits)]
        if n_bits > v.shape[1]:
            key, kp = jax.random.split(key)
            extra = _orthogonal_projections(kp, dim, n_bits - v.shape[1])
            v = jnp.concatenate([v, extra], axis=1)
        return cls(v, mean, n_bits, "pca")

    # -- encoding ---------------------------------------------------------

    def project(self, x: jax.Array) -> jax.Array:
        """Float projections (the asymmetric-query space)."""
        if self.mode == "sign":
            return x
        xc = x - self.mean if self.mean is not None else x
        return xc @ self.projections

    def encode(self, x: jax.Array) -> jax.Array:
        """[n, dim] → packed uint32 [n, n_words]."""
        return pack_bits(self.project(x) > 0)

    def memory_usage_bytes(self) -> int:
        total = 0
        if self.projections is not None:
            total += int(self.projections.size) * 4
        if self.mean is not None:
            total += int(self.mean.size) * 4
        return total

    # -- persistence helpers ---------------------------------------------

    def state(self) -> dict:
        out = {"n_bits": np.int64(self.n_bits), "mode": self.mode}
        if self.projections is not None:
            out["projections"] = np.asarray(self.projections)
        if self.mean is not None:
            out["mean"] = np.asarray(self.mean)
        return out

    @classmethod
    def from_state(cls, n_bits, mode, projections=None, mean=None):
        return cls(
            jnp.asarray(projections) if projections is not None else None,
            jnp.asarray(mean) if mean is not None else None,
            int(n_bits),
            str(mode),
        )
