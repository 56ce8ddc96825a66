"""Start the system on an NVIDIA GPU and check that its main path is right.

    python chip_smoke.py              # one GPU: phases 1-3
    python chip_smoke.py --four-gpus  # four GPUs: the sharded path only

One GPU, one process (a JAX process reserves most of the card's memory):

1. Exhaustive ground truth on the headline data (1M×128d GaussianNoise,
   100 clusters, seed 42): ``ann.build_exhaustive_index`` at HIGHEST
   precision, checked for 64 queries against a float64 NumPy brute force.
2. Headline main path: ``ann.build_ivf_pq_index(x, nlist=1024, m=128)``
   (int8 fast-scan, mode ``i8dec_residual``), queried with 30k queries
   through ``index.query(q, 10, nprobe=np, approx=True)`` over the nprobe
   sweep; recall@10 must reach 0.95 at some nprobe <= 64. QPS of the fused
   kernel and of the XLA scan (``ANNSEARCH_NO_PALLAS=1``) at that nprobe;
   the exact tier through ``ann.query_ivf_pq_index``.
3. Kernel parity at the headline widths (and at one f32 and one sq8 IVF of
   the same data): ``fused_ivf_scan`` against the XLA scan on the same task
   lists — recall within 0.005 of each other, and every returned distance
   within a stated bound of the same row's distance recomputed in float64.

``--four-gpus`` runs ``ShardedIvfPqIndex`` and ``ShardedExhaustive`` on a
1-D mesh of four cards at the headline configuration, against the
single-card ``IvfPqIndex`` and the exhaustive ground truth.

Every line before the last is tagged with the card's name and power limit
(``nvidia-smi``). The last line is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU the script exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

N, D, NC, NQ, K = 1_000_000, 128, 100, 30_000, 10
NQ_GT = 2_000
NLIST, M = 1024, 128
SWEEP = (6, 8, 10, 12, 16, 24, 32, 48, 64)
RECALL_FLOOR = 0.95


class PhaseFailed(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0].strip()


TAG = ""


def say(msg: str) -> None:
    print(f"[{TAG}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def recall(gt: np.ndarray, ids: np.ndarray) -> float:
    from annsearch_tpu.utils.metrics import calculate_recall

    return float(calculate_recall(gt, ids, K))


def headline_data():
    from annsearch_tpu.utils.data import (
        generate_clustered_data_device,
        subsample_with_noise_device,
    )

    x, _ = generate_clustered_data_device(N, D, NC, seed=42)
    q = subsample_with_noise_device(x, NQ, seed=42)
    return x, q


def ground_truth(x, q):
    """Exhaustive top-k of the first NQ_GT queries (f32, HIGHEST)."""
    import annsearch_tpu as ann

    t0 = time.perf_counter()
    exact = ann.build_exhaustive_index(x)
    gt_i, gt_d = exact.query(q[:NQ_GT], K)
    say(f"phase 1: exhaustive GT for {NQ_GT} queries in "
        f"{time.perf_counter() - t0:.3f} s (build + compile + query)")
    return exact, np.asarray(gt_i), np.asarray(gt_d)


def phase_exhaustive(x, q):
    exact, gt_i, gt_d = ground_truth(x, q)
    # float64 NumPy brute force for 64 queries
    xh = np.asarray(x, np.float64)
    qh = np.asarray(q[:64], np.float64)
    xn2 = (xh * xh).sum(1)
    qn2 = (qh * qh).sum(1)
    d64 = qn2[:, None] + xn2[None, :] - 2.0 * (qh @ xh.T)
    ref_i = np.argsort(d64, axis=1)[:, :K]
    kth = np.take_along_axis(d64, ref_i[:, -1:], axis=1)[:, 0]
    # tolerance (f32 identity ‖q‖²+‖x‖²−2q·x at HIGHEST): its rounding is
    # a few f32 ulps of the operands, bounded here by 1e-6·(‖q‖²+‖x‖²)
    got_i, got_d = gt_i[:64], gt_d[:64]
    tol = 1e-6 * (qn2[:, None] + xn2[got_i])
    derr = np.abs(got_d - np.take_along_axis(d64, got_i, axis=1))
    check(bool(np.all(derr <= tol)),
          f"GT distance error {derr.max():.3e} above its f32 bound")
    # ids equal except at ties: a differing id must sit within the
    # distance tolerance of the k-th float64 distance
    n_diff = 0
    for j in range(64):
        extra = set(got_i[j]) - set(ref_i[j])
        n_diff += len(extra)
        for r in extra:
            check(abs(d64[j, r] - kth[j]) <= tol[j].max(),
                  f"GT query {j}: id {r} is not a tie at rank {K}")
    say(f"phase 1: 64 queries vs float64 brute force: max |Δd| "
        f"{derr.max():.3e} (bound 1e-6·(‖q‖²+‖x‖²), max bound "
        f"{tol.max():.3e}); {n_diff} ids differ, all ties")
    del exact
    return gt_i


def timed_query(index, q, nprobe, reps=3):
    """Seconds per batch of ``q`` (warm batch first); ``index.query``
    returns host arrays, so each timing ends after the device finished."""
    index.query(q, K, nprobe=nprobe, approx=True)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        index.query(q, K, nprobe=nprobe, approx=True)
        times.append(time.perf_counter() - t0)
    return sorted(times)


def phase_headline(x, q, gt_i):
    import jax

    import annsearch_tpu as ann

    builds = []
    for _ in range(2):
        t0 = time.perf_counter()
        index = ann.build_ivf_pq_index(x, nlist=NLIST, m=M, seed=42)
        jax.block_until_ready(index.storage)
        builds.append(time.perf_counter() - t0)
    say(f"phase 2: IVF-PQ build (nlist={NLIST}, m={M}, mode={index.mode}): "
        f"{builds[0]:.3f} s cold (compile included), {builds[1]:.3f} s warm")
    check(index.mode == "i8dec_residual", f"mode {index.mode}")

    chosen = None
    for npr in SWEEP:
        ai, _ = index.query(q[:NQ_GT], K, nprobe=npr, approx=True)
        rec = recall(gt_i, ai)
        say(f"phase 2: nprobe={npr} recall@10={rec:.4f}")
        if rec >= RECALL_FLOOR:
            chosen = npr
            break
    check(chosen is not None, f"recall@10 never reached {RECALL_FLOOR}")
    say(f"phase 2: recall@10 >= {RECALL_FLOOR} first at nprobe={chosen}")

    t_fused = timed_query(index, q, chosen)
    say(f"phase 2: fused kernel, {NQ} queries at nprobe={chosen}: "
        f"{NQ / t_fused[0]:.1f} QPS best, {NQ / t_fused[1]:.1f} median "
        f"(s/batch {', '.join(f'{t:.4f}' for t in t_fused)})")
    os.environ["ANNSEARCH_NO_PALLAS"] = "1"
    try:
        t_xla = timed_query(index, q, chosen)
        ax, _ = index.query(q[:NQ_GT], K, nprobe=chosen, approx=True)
    finally:
        del os.environ["ANNSEARCH_NO_PALLAS"]
    say(f"phase 2: XLA scan (ANNSEARCH_NO_PALLAS=1), {NQ} queries at "
        f"nprobe={chosen}: {NQ / t_xla[0]:.1f} QPS best, "
        f"{NQ / t_xla[1]:.1f} median, recall@10={recall(gt_i, ax):.4f} "
        f"(s/batch {', '.join(f'{t:.4f}' for t in t_xla)})")

    ann.query_ivf_pq_index(q, index, K, nprobe=chosen)   # warm batch
    t0 = time.perf_counter()
    ei, _ = ann.query_ivf_pq_index(q, index, K, nprobe=chosen)
    t_exact = time.perf_counter() - t0
    rec_exact = recall(gt_i, ei[:NQ_GT])
    say(f"phase 2: exact tier (query_ivf_pq_index) at nprobe={chosen}: "
        f"recall@10={rec_exact:.4f}, {NQ / t_exact:.1f} QPS")
    return index, chosen


def _scan_pair(idx, qp, nprobe):
    """Fused kernel and exact XLA scan on the same device task lists, built
    the way the fused query path builds them. Returns two (positions, dists)
    pairs in sorted-storage coordinates."""
    import jax.numpy as jnp

    from annsearch_tpu.models.ivf_base import route_to_cells
    from annsearch_tpu.ops.ivf_scan import ivf_cluster_scan
    from annsearch_tpu.ops.ivf_scan_pallas import fused_ivf_scan
    from annsearch_tpu.ops.probe_device import (
        build_probe_lists_device,
        device_probe_shapes,
    )

    nq = qp.shape[0]
    nseg = int(idx.seg_offsets.shape[0])
    nprobe_seg = min(nseg, max(nprobe, -(-nprobe * nseg) // idx.nlist))
    maxq, R = device_probe_shapes(nq, nprobe_seg, nseg, 1)
    probes = route_to_cells(qp, idx.seg_centroids, nprobe_seg, idx.metric)
    cids, lists, gmap = build_probe_lists_device(
        probes.astype(jnp.int32), nseg, maxq, R
    )
    common = (
        idx._encode_queries(qp), cids, lists, gmap, idx.storage,
        idx.store_sqnorms, idx.seg_offsets, idx.seg_counts,
        idx._scan_seg_centroids(),
    )
    df, pf = fused_ivf_scan(
        *common, K, idx.metric, idx.mode, idx._codebooks(), 16,
        q_split=idx.mode not in ("i8dec", "i8dec_residual"),
    )
    dx, px = ivf_cluster_scan(
        *common, K, idx.metric, idx.seg_size, idx.mode,
        codebooks=idx._codebooks(),
    )
    say(f"phase 3: {idx.mode} task lists: R={R} maxq={maxq} "
        f"seg={idx.seg_size} nseg={nseg} nprobe_seg={nprobe_seg}")
    return (np.asarray(pf), np.asarray(df)), (np.asarray(px), np.asarray(dx))


def _recompute(idx, qp, pos):
    """float64 distance of each returned storage row in the index's scoring
    space, and the operand norms its rounding scales with."""
    seg_off = np.asarray(idx.seg_offsets)
    seg = np.searchsorted(seg_off, pos, side="right") - 1
    qs = np.asarray(idx._encode_queries(qp), np.float64)[:, None, :]
    rows = np.asarray(idx.storage)[pos].astype(np.float64)
    if idx.mode == "i8dec_residual":
        scales = np.asarray(idx._codebooks(), np.float64)
        cent = np.asarray(idx._scan_seg_centroids(), np.float64)[seg]
        qs = qs - cent                 # residual query
        rows = rows * scales           # decoded residual
    diff = qs - rows
    d = (diff * diff).sum(-1)
    return d, np.sqrt((qs * qs).sum(-1)), np.sqrt((rows * rows).sum(-1))


def phase_parity(x, q, gt_i, pq_index, nprobe):
    from annsearch_tpu.models.ivf import IvfIndex
    from annsearch_tpu.models.quantised.ivf import IvfSq8Index

    cases = [("i8dec_residual", pq_index)]
    for cls in (IvfIndex, IvfSq8Index):
        t0 = time.perf_counter()
        idx = cls(x, "euclidean", nlist=NLIST, seed=42)
        say(f"phase 3: built {cls.__name__} (mode {idx.mode}) in "
            f"{time.perf_counter() - t0:.3f} s")
        cases.append((idx.mode, idx))
    for mode, idx in cases:
        qp = idx._prep_queries(q)
        (pf, df), (px, dx) = _scan_pair(idx, qp, nprobe)
        oid = np.asarray(idx.original_ids)
        r_f = recall(gt_i, oid[np.clip(pf[:NQ_GT], 0, idx.n - 1)])
        r_x = recall(gt_i, oid[np.clip(px[:NQ_GT], 0, idx.n - 1)])
        check(abs(r_f - r_x) <= 0.005,
              f"{mode}: recall fused {r_f:.4f} vs XLA {r_x:.4f}")
        # bounds: sq8 scores exact integers (f32-exact below 2²⁴); f32
        # cells take f32 products on both paths (rounding ≤ 1e-5 of the
        # operands' squared norms); i8dec queries are rounded to bf16 in
        # the kernel and to TF32 in the XLA scan, a dot error ≤ 2⁻⁸·‖q‖‖x‖
        # each, so the bound is 2⁻⁷·‖q‖‖x‖ plus f32 rounding
        sub = slice(0, NQ_GT)
        for name, pos, dist in (("fused", pf, df), ("xla", px, dx)):
            ref, qn, xn = _recompute(idx, qp[sub], pos[sub])
            if mode == "sq8":
                tol = np.full_like(ref, 1e-3)
            elif mode == "f32":
                tol = 1e-5 * (qn**2 + xn**2)
            else:
                tol = 2.0**-7 * qn * xn + 1e-5 * (qn**2 + xn**2)
            err = np.abs(dist[sub] - ref)
            check(bool(np.all(err <= tol)),
                  f"{mode} {name}: distance error {err.max():.3e} over bound")
            say(f"phase 3: {mode} {name}: recall@10="
                f"{r_f if name == 'fused' else r_x:.4f}, max |Δd| "
                f"{err.max():.3e} (max bound {tol.max():.3e})")


def _span(sl: slice) -> str:
    return f"[{sl.start}:{sl.stop}]"


def phase_four_gpus(x, q):
    import jax

    from annsearch_tpu.models.quantised.ivf import IvfPqIndex
    from annsearch_tpu.parallel.ivf_sharded import ShardedIvfPqIndex
    from annsearch_tpu.parallel.mesh import make_mesh
    from annsearch_tpu.parallel.sharded import ShardedExhaustive

    _, gt_i, _ = ground_truth(x, q)
    qh = np.asarray(q[:NQ_GT])
    mesh = make_mesh(4)
    nprobe = 16

    single = IvfPqIndex(x, "euclidean", nlist=NLIST, m=M, seed=42)
    si, _ = single.query(qh, K, nprobe=nprobe)
    r_single = recall(gt_i, si)
    say(f"four: single-card IvfPqIndex nprobe={nprobe} recall@10="
        f"{r_single:.4f}")

    t0 = time.perf_counter()
    spq = ShardedIvfPqIndex(
        x, "euclidean", nlist=NLIST, m=M, seed=42, max_iters=30, mesh=mesh
    )
    jax.block_until_ready(spq.storage)
    say(f"four: ShardedIvfPqIndex build {time.perf_counter() - t0:.3f} s "
        f"(mode {spq.mode})")
    for sh in spq.storage.addressable_shards:
        say(f"four: IVF-PQ storage shard {_span(sh.index[0])} on "
            f"{sh.device}, shape {tuple(sh.data.shape)}")
    check(len({sh.device for sh in spq.storage.addressable_shards}) == 4,
          "IVF-PQ storage is not on four devices")
    spq.query(qh, K, nprobe=nprobe)
    t0 = time.perf_counter()
    pi, _ = spq.query(qh, K, nprobe=nprobe)
    t_pq = time.perf_counter() - t0
    r_pq = recall(gt_i, pi)
    say(f"four: ShardedIvfPqIndex nprobe={nprobe} recall@10={r_pq:.4f} "
        f"({NQ_GT / t_pq:.1f} QPS, {NQ_GT} queries)")
    # each shard clusters its own rows around the shared centroids, so the
    # cells differ from the single card's; recall must stay within 0.02
    check(abs(r_pq - r_single) <= 0.02,
          f"sharded IVF-PQ recall {r_pq:.4f} vs single {r_single:.4f}")

    sex = ShardedExhaustive(x, "euclidean", mesh=mesh)
    for sh in sex.vectors.addressable_shards:
        say(f"four: exhaustive rows {_span(sh.index[0])} on {sh.device}, "
            f"shape {tuple(sh.data.shape)}")
    check(len({sh.device for sh in sex.vectors.addressable_shards}) == 4,
          "exhaustive vectors are not on four devices")
    sex.query(qh, K)
    t0 = time.perf_counter()
    ei, _ = sex.query(qh, K)
    t_ex = time.perf_counter() - t0
    r_ex = recall(gt_i, ei)
    say(f"four: ShardedExhaustive recall@10={r_ex:.4f} vs single-card GT "
        f"({NQ_GT / t_ex:.1f} QPS)")
    # both exact; differences are ties broken by another summation order
    check(r_ex >= 0.999, f"sharded exhaustive recall {r_ex:.4f}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-gpus", action="store_true",
                        help="run only the sharded path on four GPUs")
    args = parser.parse_args()

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform})",
              file=sys.stderr)
        return 1
    want = 4 if args.four_gpus else 1
    if len(devs) < want:
        print(f"chip_smoke: needs {want} GPUs, JAX sees {len(devs)}",
              file=sys.stderr)
        return 1

    from annsearch_tpu.utils.compile_cache import use_compile_cache

    global TAG
    TAG = card_line()
    print(TAG, flush=True)
    say(f"jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}, "
        f"compile cache {use_compile_cache()}")
    t_all = time.perf_counter()
    try:
        x, q = headline_data()
        if args.four_gpus:
            phase_four_gpus(x, q)
        else:
            gt_i = phase_exhaustive(x, q)
            index, nprobe = phase_headline(x, q, gt_i)
            phase_parity(x, q, gt_i, index, nprobe)
    except PhaseFailed as e:
        say(f"FAILED: {e}")
        return 1
    say(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
