"""IVF (inverted-file) index.

JAX rebuild of the reference's ``IvfIndex`` (``src/cpu/ivf.rs``) and
its GPU variant (``src/gpu/ivf_gpu.rs``): k-means coarse quantiser, vectors
reordered cluster-contiguously (``optimise_memory_layout``, ivf.rs:407-444),
query = route to top-nprobe centroids then scan those cells.

All irregular machinery lives in the shared :class:`IvfBase`
(``models/ivf_base.py``): bounded-size cell segments instead of CSR, one
routing matmul instead of per-query ``select_nth_unstable``, and the
cluster-major scan engine (each cell read once per batch, dense
[queries × cell] tensor-core matmuls) instead of per-query scans.

Defaults match the reference: ``nlist = √n``, ``nprobe = √nlist``
(ivf.rs:261), k-means trained on ≤ min(256·nlist, 250k) rows (ivf.rs:158).
"""

from __future__ import annotations

from .ivf_base import IvfBase, route_to_cells

__all__ = ["IvfIndex", "route_to_cells"]


class IvfIndex(IvfBase):
    """Inverted-file index over f32 storage."""

    mode = "f32"
