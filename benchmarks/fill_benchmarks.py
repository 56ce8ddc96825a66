"""Generate docs/benchmarks_gpu.md from live runs.

Equivalent of the reference's ``examples/fill_benchmarks.sh`` (re-runs the
gridsearch suite and splices result tables into ``docs/benchmarks_*.md``).
Run on a GPU:

  python -m benchmarks.fill_benchmarks [--quick]

Default workload matches the reference's benchmark docs: GaussianNoise
150k×32d, 25 clusters, 15k noisy queries, k=15 (commons/mod.rs:17-27).
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys

sys.path.insert(0, ".")

import subprocess

import jax

from annsearch_tpu.utils.compile_cache import use_compile_cache
from benchmarks.gridsearch import main as gridsearch_main

use_compile_cache()

CONFIGS = [
    # (index kind, extra argv) — graph families run FIRST: their build
    # rows are the ones past rounds left stale, so a cut-off regen must
    # refresh them before anything else (the table keeps this order)
    ("exhaustive", []),
    ("exhaustive-gpu", []),
    ("hnsw", []),
    ("vamana", []),
    ("nndescent", []),
    ("ivf", ["--nlist-sweep", "387", "--nprobe-sweep", "8", "19"]),
    # GPU-path analogue (fused single-dispatch scan) — compare with the
    # reference's IVF-GPU rows (benchmarks_gpu.md:53: nl273 np16 332 ms)
    ("ivf-gpu", ["--nlist-sweep", "273", "--nprobe-sweep", "16", "32"]),
    ("kmknn", ["--nlist-sweep", "387"]),
    ("annoy", []),
    ("kdtree", []),
    ("balltree", []),
    ("lsh", []),
    ("exhaustive-bf16", []),
    ("exhaustive-sq8", []),
    ("exhaustive-pq", ["--m-sweep", "8", "16"]),
    ("ivf-bf16", ["--nlist-sweep", "387", "--nprobe-sweep", "8", "19"]),
    ("ivf-sq8", ["--nlist-sweep", "387", "--nprobe-sweep", "19"]),
    ("ivf-pq", ["--nlist-sweep", "387", "--m-sweep", "8", "32",
                "--nprobe-sweep", "19"]),
    ("ivf-opq", ["--nlist-sweep", "387", "--m-sweep", "8",
                 "--nprobe-sweep", "19"]),
]

# The reference never benchmarks the binary family on the 32d default
# workload — its binary suite runs 50k×256d+ (fill_benchmarks.sh:192-216:
# correlated / lowrank / quantisation generators). Mirror the 256d rows.
BINARY_BASE = [
    "--n-samples", "50000", "--dim", "256", "--k", "15",
    "--build-reps", "2",
]
BINARY_CONFIGS = [
    # (index kind, data generator, extra argv)
    ("binary", "correlated", []),
    ("rabitq", "correlated", []),
    ("ivf-binary", "correlated",
     ["--nlist-sweep", "158", "223", "--nprobe-sweep", "12", "25"]),
    ("ivf-rabitq", "correlated",
     ["--nlist-sweep", "158", "223", "--nprobe-sweep", "12", "25"]),
    ("binary", "quantisation", ["--n-clusters", "50"]),
    ("rabitq", "quantisation", ["--n-clusters", "50"]),
]

# The reference's scale rows (fill_benchmarks.sh:156-165 — IVF + GPU
# exhaustive on 250k/500k×64d lowrank; BASELINE.md: IVF CPU nl500 np22
# query 639 ms @ 1.0, GPU exhaustive 2,701 ms at 500k). The reference
# queries a CONSTANT 15k at every scale (DEFAULT_N_QUERY,
# examples/commons/mod.rs:19) — NOT n/10; match it so the rows compare.
SCALE_CONFIGS = [
    ("exhaustive", "250000", ["--n-queries", "15000"]),
    ("ivf", "250000",
     ["--n-queries", "15000",
      "--nlist-sweep", "500", "--nprobe-sweep", "11", "22"]),
    # fused single-dispatch path (the production query path; the plain
    # `ivf` rows above time the recall-1.0 exact tier)
    ("ivf-gpu", "250000",
     ["--n-queries", "15000",
      "--nlist-sweep", "500", "--nprobe-sweep", "11", "22"]),
    ("exhaustive", "500000", ["--n-queries", "15000"]),
    ("ivf", "500000",
     ["--n-queries", "15000",
      "--nlist-sweep", "500", "--nprobe-sweep", "11", "22"]),
    # certified exact tier: triangle-inequality probe certificate —
    # provably exact top-k (recall 1.0 by construction, not clustering
    # luck); compare the reference CPU's 639 ms @ 1.0 row
    ("ivf", "500000",
     ["--n-queries", "15000", "--certify",
      "--nlist-sweep", "500", "--nprobe-sweep", "22"]),
    ("ivf-gpu", "500000",
     ["--n-queries", "15000",
      "--nlist-sweep", "500", "--nprobe-sweep", "11", "22"]),
]

QUICK = [
    ("exhaustive", []),
    ("ivf", ["--nlist-sweep", "387", "--nprobe-sweep", "19"]),
    ("ivf-bf16", ["--nlist-sweep", "387", "--nprobe-sweep", "19"]),
    ("ivf-pq", ["--nlist-sweep", "387", "--m-sweep", "8", "--nprobe-sweep", "19"]),
    ("nndescent", []),
]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument(
        "--sections", default="main,native,binary,scale",
        help="comma list of table sections to regenerate — ALSO the run "
        "order (the file keeps its canonical section order regardless); "
        "skipped sections are carried over verbatim from the old file",
    )
    p.add_argument("--n-samples", type=int, default=150_000)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--k", type=int, default=15)
    args = p.parse_args(argv)

    base = [
        "--n-samples", str(args.n_samples), "--dim", str(args.dim),
        "--n-clusters", "25", "--k", str(args.k),
        "--build-reps", "2",
    ]
    order = [x for x in args.sections.split(",") if x]
    if args.quick:
        order = ["main"]

    # preserve appendix sections this script does not generate (the
    # kNN-graph / 10M / quantised-1M sections maintained by the
    # bench_knn_graph / bench_ivfpq_scale / bench_quantised_1m /
    # bench_cagra_10m scripts) across full regens
    appendix = ""
    old = ""
    try:
        with open("docs/benchmarks_gpu.md") as f:
            old = f.read()
        for marker in (
            "## Full kNN-graph generation",
            "## 10M×128d on ONE chip",
            "## Quantised IVF at 1M×256d",
        ):
            pos = old.find(marker)
            if pos >= 0:
                appendix = "\n" + old[pos:].rstrip() + "\n"
                old = old[:pos]
                break
    except FileNotFoundError:
        pass

    def old_span(start_marker, end_markers):
        m0 = old.find(start_marker)
        if m0 < 0:
            return ""
        m1 = len(old)
        for em in end_markers:
            p_ = old.find(em, m0 + 1)
            if 0 <= p_ < m1:
                m1 = p_
        return old[m0:m1].rstrip()

    MAIN_HEAD = (
        "| Method | Build (ms) | Query (ms) | Recall@k | Dist ratio "
        "| Size MB |\n|---|---|---|---|---|---|"
    )
    NATIVE_PARA = (
        "At this workload size every index that keeps full-precision "
        "rows answers queries through the small-regime exact tensor-core scan "
        "(recall 1.0 by construction — see "
        "`models/base.BRUTE_QUERY_FLOP_BUDGET`). The rows below force "
        "the native query algorithms (`ANNSEARCH_NO_EXACT_FALLBACK=1`) "
        "to show structure quality:\n\n"
        "| Method (native path) | Build (ms) | Query (ms) | Recall@k "
        "| Dist ratio | Size MB |\n|---|---|---|---|---|---|"
    )
    BINARY_HEAD = (
        "## Binary quantisation suite (50k×256d, k=15 — the reference's "
        "`benchmarks_binary.md` workload)\n\n"
        "Size MB here includes the device-resident f32 rerank store "
        "(51.2 MB at this workload) that the exact-rerank tier scores "
        "against; the reference keeps the same vectors in an on-disk "
        "mmap store it does NOT count in its Size column "
        "(vec_store.rs; exhaustive_binary.rs:575-579 counts codes + "
        "binariser only). Codes+binariser alone are ~1.9 MB at 256 "
        "bits — parity with the reference's 1.78 MB.\n\n"
        "| Method | Data | Build (ms) | Query (ms) | Recall@k | "
        "Dist ratio | Size MB |\n|---|---|---|---|---|---|---|"
    )
    SCALE_HEAD = (
        "## Scale suite (lowrank 64d, k=15 — the reference's "
        "`benchmarks_gpu.md` 250k/500k workloads)\n\n"
        "| Method | n | Build (ms) | Query (ms) | Recall@k | "
        "Dist ratio | Size MB |\n|---|---|---|---|---|---|---|"
    )

    # canonical blocks, seeded from the old file: any cutoff leaves a
    # coherent document (fresh sections where a regen completed, the
    # previous run's content elsewhere)
    blocks = {
        "main": old_span(
            "| Method |", ("At this workload size", "\n## ")
        ) or MAIN_HEAD,
        "native": old_span("At this workload size", ("\n## ",)),
        "binary": old_span("## Binary quantisation suite", ("\n## Scale",)),
        "scale": old_span("## Scale suite", ("\n## ",)),
    }

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    header = (
        "# GPU benchmarks\n\n"
        f"Generated {datetime.datetime.now():%Y-%m-%d %H:%M} on "
        f"{jax.devices()[0].device_kind} ({card}; timings include host "
        "work). Workload: GaussianNoise "
        f"{args.n_samples}×{args.dim}d, 25 clusters, "
        f"{args.n_samples // 10} noisy queries, k={args.k} — the reference's "
        "default benchmark workload (commons/mod.rs:17-27)."
    )
    os.makedirs("docs", exist_ok=True)

    def write():
        parts = [header, blocks["main"]]
        for name in ("native", "binary", "scale"):
            if blocks[name]:
                parts.append(blocks[name])
        with open("docs/benchmarks_gpu.md", "w") as f:
            f.write("\n\n".join(parts) + "\n" + appendix)

    def sweep(tag, kind, argv_, rows, block_name, fmt):
        print(f"=== {tag}{kind} ===", flush=True)
        try:
            results = gridsearch_main(argv_)
        except Exception as e:
            print(f"{tag}{kind} FAILED: {e}", flush=True)
            return
        for r in results:
            rows.append(fmt(r))
        blocks[block_name] = "\n".join(rows)
        write()  # incremental — a cutoff keeps everything finished so far

    def row6(r):
        name, build_ms, query_ms, rec, mdr, size_mb = r
        return (
            f"| {name} | {build_ms:,.0f} | {query_ms:,.0f} | "
            f"{rec:.4f} | {mdr:.4f} | {size_mb:.2f} |"
        )

    def run_main():
        rows = [MAIN_HEAD]
        for kind, extra in (QUICK if args.quick else CONFIGS):
            sweep("", kind, ["--index", kind] + base + extra, rows,
                  "main", row6)

    def run_native():
        rows = [NATIVE_PARA]
        os.environ["ANNSEARCH_NO_EXACT_FALLBACK"] = "1"
        try:
            for kind, extra in [
                ("kmknn", ["--nlist-sweep", "387"]),
                ("annoy", []),
                ("hnsw", []),
                ("vamana", []),
                ("nndescent", []),
                ("lsh", []),
            ]:
                sweep("native ", kind, ["--index", kind] + base + extra,
                      rows, "native", row6)
        finally:
            del os.environ["ANNSEARCH_NO_EXACT_FALLBACK"]

    def run_binary():
        rows = [BINARY_HEAD]
        os.environ["ANNSEARCH_NO_EXACT_FALLBACK"] = "1"
        try:
            for kind, data, extra in BINARY_CONFIGS:
                def fmt(r, data=data):
                    name, b, q, rec, mdr, mb = r
                    return (
                        f"| {name} | {data} | {b:,.0f} | {q:,.0f} | "
                        f"{rec:.4f} | {mdr:.4f} | {mb:.2f} |"
                    )
                sweep("binary-suite ", f"{kind} ({data})",
                      ["--index", kind, "--data", data] + BINARY_BASE + extra,
                      rows, "binary", fmt)
        finally:
            del os.environ["ANNSEARCH_NO_EXACT_FALLBACK"]

    def run_scale():
        rows = [SCALE_HEAD]
        for kind, n, extra in SCALE_CONFIGS:
            def fmt(r, n=n):
                name, b, q, rec, mdr, mb = r
                return (
                    f"| {name} | {n} | {b:,.0f} | {q:,.0f} | "
                    f"{rec:.4f} | {mdr:.4f} | {mb:.2f} |"
                )
            sweep("scale ", f"{kind} ({n})",
                  ["--index", kind, "--data", "lowrank",
                   "--n-samples", n, "--dim", "64", "--k", "15",
                   "--intrinsic-dim", "16", "--build-reps", "2"] + extra,
                  rows, "scale", fmt)

    runners = {"main": run_main, "native": run_native,
               "binary": run_binary, "scale": run_scale}
    write()
    for name in order:
        if name in runners:
            runners[name]()
    print("wrote docs/benchmarks_gpu.md", flush=True)


if __name__ == "__main__":
    main()
