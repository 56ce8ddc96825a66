"""Timing spans + optional device profiling.

The reference's observability is ``std::time::Instant`` spans printed under
``verbose`` flags (SURVEY §5 — e.g. hnsw.rs:620/690, nndescent_gpu timers).
This module provides the same lightweight span timers plus an optional
``jax.profiler`` trace context for real on-chip analysis.

Time device work to ``jax.block_until_ready`` (JAX dispatch is
asynchronous, so a span around an unforced call measures only the enqueue).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np

__all__ = ["Timer", "span", "device_trace", "force"]


class Timer:
    """Accumulating named spans: ``with timer.span("assign"): ...``."""

    def __init__(self, verbose: bool = False):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.verbose = verbose

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            if self.verbose:
                print(f"  [{name}] {dt * 1000:.1f} ms")

    def report(self) -> str:
        lines = [
            f"{name:<30} {self.totals[name] * 1000:>10.1f} ms "
            f"({self.counts[name]}x)"
            for name in sorted(self.totals, key=self.totals.get, reverse=True)
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def span(name: str, verbose: bool = True):
    """One-off span printed when verbose."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if verbose:
            print(f"[{name}] {(time.perf_counter() - t0) * 1000:.1f} ms")


@contextlib.contextmanager
def device_trace(logdir: str):
    """jax.profiler trace context (view with tensorboard / xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def force(x) -> float:
    """Wait for ``x`` on the device and return its first element as a host
    scalar (0.0 when empty)."""
    arr = np.asarray(x)
    return float(arr.reshape(-1)[0]) if arr.size else 0.0
