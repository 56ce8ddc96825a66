"""Headline benchmark: IVF-PQ query throughput on one GPU.

Headline metric = the BASELINE.json north star: IVF-PQ query throughput on
1M×128d (100 Gaussian clusters) at recall@10 ≥ 0.95. Operating point:
nlist=1024, m=128 (128 B/vector = 4× compression), nprobe chosen as the
cheapest that clears 0.95 recall; throughput timed over 30k queries with
approximate per-cell selection.

``vs_baseline`` compares against the reference's closest published IVF-PQ
number (docs/benchmarks_quantised.md 50k×128d table: 1,585 ms / 15k queries
= 9,464 QPS at recall 0.875 on a 20× smaller database).

Prints the card's name and power limit (``nvidia-smi``), then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", ...extras}. Exits non-zero
without a GPU, and on any failure.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import jax

import annsearch_tpu as ann
from annsearch_tpu.utils.compile_cache import use_compile_cache
from annsearch_tpu.utils.metrics import calculate_recall

BASELINE_IVFPQ_QPS = 15_000 / 1.585  # reference CPU IVF-PQ batch rate


def headline_ivfpq():
    N, D, NC, NQ, K = 1_000_000, 128, 100, 30_000, 10
    NQ_GT = 2_000
    from annsearch_tpu.utils.data import (
        generate_clustered_data_device,
        subsample_with_noise_device,
    )

    x, _ = generate_clustered_data_device(N, D, NC, seed=42)
    q = subsample_with_noise_device(x, NQ, seed=42)
    ti, _ = ann.build_exhaustive_index(x).query(q[:NQ_GT], K)

    # build twice, report the warm time: the first build pays one-off jit
    # compiles (a production host keeps its compile cache)
    build_s = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        index = ann.build_ivf_pq_index(x, nlist=1024, m=128, seed=42)
        jax.block_until_ready(index.storage)
        build_s = min(build_s, time.perf_counter() - t0)

    # q_split defaults to bf16 query scoring for i8dec modes (IvfBase.query
    # auto-resolve): at this operating point recall is quantisation-limited
    cleared = []
    for nprobe in (6, 8, 10, 12, 16, 24, 32, 48, 64):
        ai, _ = index.query(q[:NQ_GT], K, nprobe=nprobe, approx=True)
        rec = calculate_recall(ti, ai, K)
        if rec >= 0.95:
            cleared.append((nprobe, rec))
            if len(cleared) >= 3:  # cost grows with nprobe; 3 is enough
                break
    if not cleared:
        raise RuntimeError("recall@10 never reached 0.95 up to nprobe 64")

    # time EVERY clearing point and report the fastest: QPS is not strictly
    # monotone in nprobe (task-list padding shapes); 5 reps, best-of
    best_qps, nprobe, rec = 0.0, *cleared[0]
    for np_c, rec_c in cleared:
        index.query(q, K, nprobe=np_c, approx=True)  # warm batch
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            index.query(q, K, nprobe=np_c, approx=True)
            times.append(time.perf_counter() - t0)
        qps_c = NQ / min(times)
        if qps_c > best_qps:
            best_qps, nprobe, rec = qps_c, np_c, rec_c

    dev = jax.devices()[0]
    return {
        "metric": "ivfpq_qps_1M_128d_recall_ge_0.95",
        "value": round(best_qps, 1),
        "unit": "queries/s",
        "vs_baseline": round(best_qps / BASELINE_IVFPQ_QPS, 2),
        "recall_at_10": round(float(rec), 4),
        "nprobe": nprobe,
        "build_seconds": round(build_s, 3),
        "compression": "128B/vec (4x)",
        "device_kind": dev.device_kind,
        "baseline_note": "reference CPU IVF-PQ 9464 QPS @ recall 0.875 on 50k×128d",
    }


def main() -> int:
    if jax.devices()[0].platform != "gpu":
        print("bench.py: no GPU", file=sys.stderr)
        return 1
    use_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    out = headline_ivfpq()
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
