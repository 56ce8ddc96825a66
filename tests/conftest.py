"""Test configuration: run everything on a virtual 8-device CPU mesh.

Mirrors the reference's strategy of testing GPU kernel logic on a CPU
runtime (``cubecl::cpu::CpuRuntime``, e.g. ivf_gpu.rs:853-947): all kernels
and sharded paths are exercised on CPU devices (the Pallas kernel through
its interpreter); the GPU runs ``chip_smoke.py`` and the benchmarks.
"""

import os

# Tests always run on the virtual 8-device CPU mesh, whatever accelerator
# the environment offers. XLA_FLAGS is read at first backend init, so the
# env var sets the device count.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Tests exercise the NATIVE query algorithms: without this, every
# small-workload recall test would silently route through the small-regime
# exact fallback (models/base.BRUTE_QUERY_FLOP_BUDGET) and assert nothing
# about the structure under test. test_exact_fallback.py covers the
# fallback path explicitly.
os.environ["ANNSEARCH_NO_EXACT_FALLBACK"] = "1"

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from annsearch_tpu.utils.compile_cache import use_compile_cache  # noqa: E402

# Persistent compilation cache: the suite is dominated by XLA compiles.
use_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


@pytest.fixture
def fused_kernel(monkeypatch):
    """Route fused-eligible scans to the cell-scan kernel as on a GPU, with
    the kernel run by the Pallas interpreter. The library itself takes the
    kernel only on a GPU and never interprets it (test_ivf_scan_pallas pins
    that rule); this fixture lets the public query paths reach the kernel
    on the CPU test mesh."""
    from annsearch_tpu.ops import ivf_scan_pallas as isp

    cell_scan = isp._cell_scan

    def interpreted(*args, **kw):
        return cell_scan(*args, **{**kw, "interpret": True})

    monkeypatch.setattr(isp, "_on_gpu", lambda: True)
    monkeypatch.setattr(isp, "_cell_scan", interpreted)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def small_points():
    """5-point 3-D fixture in the spirit of the reference's index tests
    (cpu/exhaustive.rs:281-543)."""
    return np.array(
        [
            [1.0, 0.0, 0.0],
            [0.0, 1.0, 0.0],
            [0.0, 0.0, 1.0],
            [1.0, 1.0, 0.0],
            [2.0, 0.0, 0.0],
        ],
        dtype=np.float32,
    )
