"""Synthetic benchmark data generators.

Reimplements the reference's four synthetic suites with the same
distributions and parameters (``examples/commons/mod.rs:88-687``) — all recall
targets in BASELINE.md are defined against these:

  * ``gaussian``      — Gaussian clusters, centres U(-7.5, 7.5), std U(0.5, 2.5),
                        variable cluster sizes (weight U(0.5, 2.5) / 1.25).
  * ``correlated``    — well-separated clusters with subspace structure +
                        linear-combination correlated dimension groups.
  * ``lowrank``       — intrinsic-dim manifold embedded by a random orthonormal
                        rotation + small isotropic noise.
  * ``quantisation``  — power-law eigen-spectrum, norm-stratified shared-direction
                        clusters, random global rotation (stresses quantisers).

Queries are noisy subsamples (``subsample_with_noise``, σ=0.05,
commons/mod.rs:701-733). Host-side numpy: data generation is input plumbing,
not an accelerator hot path.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "generate_clustered_data",
    "generate_clustered_data_device",
    "generate_clustered_data_high_dim",
    "generate_low_rank_rotated_data",
    "generate_quantisation_stress",
    "generate_data",
    "subsample_with_noise",
    "subsample_with_noise_device",
    "DEFAULT_COR_STRENGTH",
]

#: reference default (commons/mod.rs:31) — recall targets on the
#: "correlated" suite are defined at this strength; 0.8 makes target dims
#: near-copies of their source and measurably tanks binary-code recall
DEFAULT_COR_STRENGTH = 0.5


def _variable_cluster_assignments(
    rng: np.random.Generator, n_samples: int, n_clusters: int
) -> np.ndarray:
    """Variable cluster sizes: weight U(0.5,2.5), n·w/(k·1.25) per cluster,
    remainder uniform, shuffled (commons/mod.rs:160-176)."""
    parts = []
    for c in range(n_clusters):
        w = rng.uniform(0.5, 2.5)
        n_in = int(n_samples * w / (n_clusters * 1.25))
        parts.append(np.full(n_in, c, dtype=np.int64))
    a = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    if a.size < n_samples:
        a = np.concatenate(
            [a, rng.integers(0, n_clusters, n_samples - a.size)]
        )
    rng.shuffle(a)
    return a[:n_samples]


def generate_clustered_data(
    n_samples: int, dim: int, n_clusters: int, seed: int = 42
) -> tuple[np.ndarray, np.ndarray]:
    """GaussianNoise suite (commons/mod.rs:136-189)."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-7.5, 7.5, (n_clusters, dim))
    stds = rng.uniform(0.5, 2.5, n_clusters)
    labels = _variable_cluster_assignments(rng, n_samples, n_clusters)
    noise = rng.standard_normal((n_samples, dim))
    data = centres[labels] + noise * stds[labels][:, None]
    return data.astype(np.float32), labels


def generate_clustered_data_device(
    n_samples: int, dim: int, n_clusters: int, seed: int = 42,
    sentinel: bool = False,
):
    """GaussianNoise suite generated ON DEVICE (same distribution family as
    :func:`generate_clustered_data`: centres U(-7.5, 7.5), stds U(0.5, 2.5),
    cluster sizes ∝ U(0.5, 2.5) weights).

    For benchmark-scale datasets the host→device upload dominates on slow
    links (a 1M×128d matrix is 512 MB); generating on device costs one tiny
    program instead. Returns ``(data [n, d] f32 device array, labels)``.

    ``sentinel=True`` returns ``[n+1, d]`` with a ZERO last row (rows
    0..n-1 identical to the unpadded call): graph indexes keep a zero
    sentinel row for safe gathers, and appending one to an existing
    device array costs a full second copy — 2×5.1 GB transient at
    10M×128d, which OOMs the chip. Generating the padded layout inside
    the jit costs nothing (pass ``has_sentinel=True`` to the index).
    """
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
    def _gen(key, n, d, k, pad):
        kc, ks, kw, kl, kn = jax.random.split(key, 5)
        centres = jax.random.uniform(kc, (k, d), minval=-7.5, maxval=7.5)
        stds = jax.random.uniform(ks, (k,), minval=0.5, maxval=2.5)
        w = jax.random.uniform(kw, (k,), minval=0.5, maxval=2.5)
        labels = jax.random.categorical(kl, jnp.log(w), shape=(n,))
        noise = jax.random.normal(kn, (n, d))
        data = centres[labels] + noise * stds[labels][:, None]
        data = data.astype(jnp.float32)
        if pad:
            # inside the jit this fuses into the output buffer — no
            # second full-size copy materialises
            data = jnp.concatenate([data, jnp.zeros((1, d), jnp.float32)])
        return data, labels.astype(jnp.int32)

    return _gen(jax.random.key(seed), n_samples, dim, n_clusters, sentinel)


def subsample_with_noise_device(
    data, n_samples: int, seed: int = 42, n_rows: int | None = None
):
    """Device-side noisy query subsample (σ=0.05, seed offset +1000 —
    mirrors :func:`subsample_with_noise`). ``n_rows`` restricts the draw
    to the first rows (draws are identical to slicing ``data[:n_rows]``
    first, WITHOUT the eager-slice copy — pass it for sentinel-padded
    tables)."""
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnums=(2, 3))
    def _sub(key, x, m, nr):
        ki, kn = jax.random.split(key)
        idx = jax.random.choice(ki, nr, (m,), replace=False)
        return x[idx] + jax.random.normal(kn, (m, x.shape[1])) * 0.05

    nr = data.shape[0] if n_rows is None else n_rows
    m = min(n_samples, nr)
    return _sub(jax.random.key(seed + 1000), data, m, nr)


def _separated_centres(
    rng: np.random.Generator,
    n_clusters: int,
    dim: int,
    scale: float,
    min_sep: float,
) -> np.ndarray:
    """Rejection-sample centres with pairwise separation ≥ min_sep."""
    centres: list[np.ndarray] = []
    while len(centres) < n_clusters:
        cand = rng.uniform(-scale, scale, dim)
        if all(np.sum((cand - c) ** 2) >= min_sep**2 for c in centres):
            centres.append(cand)
    return np.stack(centres)


def generate_clustered_data_high_dim(
    n_samples: int,
    dim: int,
    n_clusters: int,
    correlation_strength: float = DEFAULT_COR_STRENGTH,
    seed: int = 42,
) -> tuple[np.ndarray, np.ndarray]:
    """Correlated suite (commons/mod.rs:208-331)."""
    rng = np.random.default_rng(seed)
    scale = np.sqrt(dim) * 2.0
    centres = _separated_centres(rng, n_clusters, dim, scale, scale * 0.8)

    active_per_cluster = max(dim // 2, 3)
    active = np.stack(
        [rng.permutation(dim)[:active_per_cluster] for _ in range(n_clusters)]
    )
    stds = rng.uniform(0.3, 1.0, n_clusters) * scale / 10.0
    labels = _variable_cluster_assignments(rng, n_samples, n_clusters)

    noise_scale = np.full((n_clusters, dim), 0.1)
    for c in range(n_clusters):
        noise_scale[c, active[c]] = 1.0
    noise_scale *= stds[:, None]

    data = centres[labels] + rng.standard_normal((n_samples, dim)) * noise_scale[labels]

    # correlated dimension groups: target = source·coeff·ρ + original·(1−ρ)
    n_groups = dim // 8
    dims_per_group = 4
    nw = 1.0 - correlation_strength
    for g in range(n_groups):
        src = g * 8
        if src >= dim:
            break
        coeffs = rng.uniform(-2.0, 2.0, dims_per_group)
        for off in range(1, dims_per_group + 1):
            tgt = src + off
            if tgt >= dim:
                break
            data[:, tgt] = (
                data[:, src] * coeffs[off - 1] * correlation_strength
                + data[:, tgt] * nw
            )
    return data.astype(np.float32), labels


def _orthonormal_rows(rng: np.random.Generator, rows: int, cols: int) -> np.ndarray:
    """Random matrix with orthonormal structure (QR on a Gaussian)."""
    g = rng.standard_normal((max(rows, cols), min(rows, cols)))
    q, _ = np.linalg.qr(g)
    q = q[: max(rows, cols), : min(rows, cols)]
    return q.T if rows < cols else q  # shape [rows, cols]


def generate_low_rank_rotated_data(
    n_samples: int,
    embedding_dim: int,
    intrinsic_dim: int,
    n_clusters: int,
    seed: int = 42,
) -> tuple[np.ndarray, np.ndarray]:
    """LowRank suite (commons/mod.rs:349-477)."""
    assert intrinsic_dim <= embedding_dim
    rng = np.random.default_rng(seed)
    sep = np.sqrt(intrinsic_dim) * 3.0
    centres = _separated_centres(rng, n_clusters, intrinsic_dim, sep, sep * 0.5)

    labels = np.concatenate(
        [np.full(n_samples // n_clusters, c, np.int64) for c in range(n_clusters)]
    )
    if labels.size < n_samples:
        labels = np.concatenate(
            [labels, rng.integers(0, n_clusters, n_samples - labels.size)]
        )
    rng.shuffle(labels)
    labels = labels[:n_samples]

    low = centres[labels] + rng.standard_normal((n_samples, intrinsic_dim)) * 0.3
    rotation = _orthonormal_rows(rng, intrinsic_dim, embedding_dim)
    high = low @ rotation
    high += rng.standard_normal((n_samples, embedding_dim)) * 0.01
    return high.astype(np.float32), labels


def generate_quantisation_stress(
    n_samples: int,
    dim: int,
    n_clusters: int,
    spectral_decay: float = 1.5,
    seed: int = 42,
) -> tuple[np.ndarray, np.ndarray]:
    """QuantisationStress suite (commons/mod.rs:547-632)."""
    rng = np.random.default_rng(seed)
    eig = 1.0 / np.power(np.arange(1, dim + 1, dtype=np.float64), spectral_decay)
    sqrt_eig = np.sqrt(eig)

    n_directions = -(-n_clusters // 2)
    radii = np.array([2.0, 8.0, 20.0])
    dirs = rng.standard_normal((n_directions, dim))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    centres = np.stack(
        [
            dirs[c % n_directions] * radii[c % 3] * sqrt_eig
            for c in range(n_clusters)
        ]
    )
    labels = _variable_cluster_assignments(rng, n_samples, n_clusters)

    radius = np.maximum(np.linalg.norm(centres, axis=1), 1.0)
    base_std = radius * 0.06
    std = base_std[labels][:, None] * sqrt_eig[None, :]
    data = centres[labels] + rng.standard_normal((n_samples, dim)) * std

    q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    return (data @ q).astype(np.float32), labels


def generate_data(
    data: str,
    n_samples: int,
    dim: int,
    n_clusters: int,
    seed: int = 42,
    intrinsic_dim: int = 16,
    spectral_decay: float = 1.5,
    correlation_strength: float = DEFAULT_COR_STRENGTH,
) -> tuple[np.ndarray, np.ndarray]:
    """Dispatch by suite name (commons/mod.rs ``generate_data``)."""
    name = data.lower()
    if name == "correlated":
        return generate_clustered_data_high_dim(
            n_samples, dim, n_clusters, correlation_strength, seed
        )
    if name == "lowrank":
        return generate_low_rank_rotated_data(
            n_samples, dim, intrinsic_dim, n_clusters, seed
        )
    if name in ("quantisation", "quantization"):
        return generate_quantisation_stress(
            n_samples, dim, n_clusters, spectral_decay, seed
        )
    return generate_clustered_data(n_samples, dim, n_clusters, seed)


def subsample_with_noise(
    data: np.ndarray, n_samples: int, seed: int = 42
) -> np.ndarray:
    """Noisy query subsample: σ=0.05 Gaussian noise, seed offset +1000
    (commons/mod.rs:701-733)."""
    rng = np.random.default_rng(seed + 1000)
    n = min(n_samples, data.shape[0])
    idx = rng.permutation(data.shape[0])[:n]
    out = data[idx] + rng.standard_normal((n, data.shape[1])) * 0.05
    return out.astype(np.float32)
