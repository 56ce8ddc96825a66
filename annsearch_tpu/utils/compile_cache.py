"""Where JAX keeps its persistent compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it at import and this
module sets nothing. Otherwise the cache lives at a fixed ``<repo>/.jax_cache``
(listed in ``.gitignore``): the path is part of what a later process looks
up, so it never derives from a temporary name, a pid or the time.
"""

from __future__ import annotations

import os

import jax

__all__ = ["use_compile_cache"]

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def use_compile_cache() -> str:
    """Enable the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
