"""On-device probe-list construction for the fused IVF scan.

The host-built task lists (``ops/ivf_scan.build_probe_lists_from_pairs``)
force a mid-query synchronisation: route on device → read probes back →
invert on host → upload padded lists. This module performs the same
inversion with jnp ops on device — the whole query (route → invert → fused
scan) becomes one async dispatch chain.

Static-shape strategy (XLA needs fixed shapes): ``maxq`` is derived from
the *mean* occupancy (nq·nprobe / nseg) and clusters with more queries are
chunked across several scan rows, so the row-count bound
``R = total/maxq + nseg`` is static. Sentinel tasks (segment-expansion
slots beyond a cluster's actual segment count) route to segment id
``nseg`` whose row count is zero — the fused kernel skips those rows.

Compare the reference's CPU task-list step (ivf_gpu.rs:600-635), which runs
on host because its GPU kernel consumes ragged lists; here static shapes
buy a fully device-resident pipeline.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = [
    "device_probe_shapes",
    "expand_probes_device",
    "build_probe_lists_device",
]


def _next_pow2(v: int) -> int:
    return 1 << (max(v, 1) - 1).bit_length()


def device_probe_shapes(
    nq: int, nprobe: int, nseg: int, s_max: int
) -> tuple[int, int]:
    """Static ``(maxq, R)`` for the device-built lists.

    Total kernel work scales with ``R·maxq`` slots (= tasks + padding): padding
    ≈ ``nseg·maxq`` (each active segment holds ≤1 partial chunk row), so a
    *small* maxq minimises waste; the floor keeps per-row matmuls
    tensor-core-shaped. ``R`` is a multiple of 64, not a power of two — these
    shapes derive from static (nq, nprobe, nseg), so recompiles are already
    bounded."""
    total = nq * nprobe * s_max
    mean = max(1, (nq * nprobe) // max(nseg, 1))
    maxq = min(_next_pow2(-(-mean // 2)), 1024, _next_pow2(nq))
    maxq = max(maxq, 32)
    rows = -(-total // maxq) + nseg + 2
    R = -(-rows // 64) * 64
    return maxq, R


@functools.partial(jax.jit, static_argnames=("s_max", "nseg"))
def expand_probes_device(
    probes: jax.Array,       # [nq, nprobe] int cluster ids
    cluster_ptr: jax.Array,  # [nlist+1] int32 segment CSR
    s_max: int,              # max segments per cluster (static, from layout)
    nseg: int,
) -> jax.Array:
    """Cluster probes → segment probes ``[nq, nprobe·s_max]``; expansion
    slots past a cluster's segment count hold the sentinel ``nseg``."""
    c = probes.astype(jnp.int32)
    first = cluster_ptr.astype(jnp.int32)[c]             # [nq, np]
    count = cluster_ptr.astype(jnp.int32)[c + 1] - first
    j = jnp.arange(s_max, dtype=jnp.int32)[None, None, :]
    seg = jnp.where(j < count[:, :, None], first[:, :, None] + j, nseg)
    return seg.reshape(probes.shape[0], -1)


@functools.partial(jax.jit, static_argnames=("nseg", "maxq", "R"))
def build_probe_lists_device(
    seg_probes: jax.Array,   # [nq, T] int32 segment ids (sentinel = nseg)
    nseg: int,
    maxq: int,
    R: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Invert ``[nq, T]`` segment probes into per-row query lists on device.

    Returns ``(cluster_ids [R], lists [R, maxq], gather_map [nq, T])`` with
    the same semantics as the host builder: ``lists`` padded with ``nq``,
    ``cluster_ids`` padded with ``nseg``, and ``gather_map[q, t]`` the flat
    scan lane ``row·maxq + col`` of pair ``(q, t)``.
    """
    nq, T = seg_probes.shape
    n_pairs = nq * T
    flat_c = seg_probes.reshape(-1)
    flat_q = jnp.repeat(jnp.arange(nq, dtype=jnp.int32), T)

    order = jnp.argsort(flat_c, stable=True)
    cs = flat_c[order]
    qs = flat_q[order]
    counts = jnp.bincount(flat_c, length=nseg + 1).astype(jnp.int32)
    starts = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1].astype(jnp.int32)]
    )
    rank = jnp.arange(n_pairs, dtype=jnp.int32) - starts[cs]
    nchunks = -(-counts // maxq)                         # ceil per segment
    row_base = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(nchunks)[:-1].astype(jnp.int32)]
    )
    rows = jnp.minimum(row_base[cs] + rank // maxq, R - 1)
    cols = rank % maxq

    lists = jnp.full((R, maxq), nq, jnp.int32).at[rows, cols].set(qs)
    cluster_ids = jnp.full((R,), nseg, jnp.int32).at[rows].set(cs)
    # lanes back in original pair order → [nq, T] gather map
    lanes = rows * maxq + cols
    gather_map = (
        jnp.zeros((n_pairs,), jnp.int32).at[order].set(lanes).reshape(nq, T)
    )
    return cluster_ids, lists, gather_map
