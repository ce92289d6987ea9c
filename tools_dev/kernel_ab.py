"""Scan vs segment SpMV on one GPU: end-to-end times and trace top ops.

Times the engine's two SpMV kernels (engine/executor.py KERNELS) end to
end on the same graph, in turns (scan, segment, segment, scan, ...):

  * PageRank, RMAT-22, 20 iterations (plus-times, a sum semiring);
  * BFS from root 0, RMAT-20, to convergence (min semiring).

Every timed run is checked against the golden model (chip_smoke.py's
checks). Then one run of each kernel is traced with jax.profiler and the
trace is reduced to: the device's busy share over the traced run, and per
trace line the ops that take the most device time.

Writes ``<out>/kernel_ab.json`` and prints one summary line per run.
Refuses to run without a GPU.

Usage: python tools_dev/kernel_ab.py [--pairs 3] [--out DIR]
           [--pr-scale 22] [--bfs-scale 20]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import statistics
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def summarize_trace(trace_dir, plane_prefix="/device:GPU", top=8):
    """Reduce one jax.profiler trace directory to device metrics.

    Busy share = union of the event intervals on the device planes'
    ``Stream`` lines (the kernels as they ran) over the span from the
    first to the last of them. Per line of each device plane: event
    count, summed duration and the ``top`` names by summed duration."""
    from jax.profiler import ProfileData
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if len(paths) != 1:
        raise ValueError(f"expected one .xplane.pb under {trace_dir}, "
                         f"found {len(paths)}")
    pd = ProfileData.from_file(paths[0])
    lines, intervals = {}, []
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            per_name = defaultdict(float)
            n = 0
            for ev in line.events:
                per_name[ev.name] += ev.duration_ns
                n += 1
                if line.name.startswith("Stream"):
                    intervals.append((ev.start_ns, ev.end_ns))
            if not n:
                continue
            ranked = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
            lines[f"{plane.name} | {line.name}"] = {
                "events": n, "total_ns": sum(per_name.values()),
                "top": [{"name": k, "ns": v} for k, v in ranked]}
    busy = span = 0.0
    if intervals:
        intervals.sort()
        span = intervals[-1][1] - intervals[0][0]
        cur_s, cur_e = intervals[0]
        for s, e in intervals[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
    return {"busy_ns": busy, "span_ns": span,
            "busy_share": busy / span if span else None, "lines": lines}


def _ab(name, runners, pairs, check):
    """Alternate the runners; return {kernel: [seconds...]}."""
    kernels = list(runners)
    times = {k: [] for k in kernels}
    for i in range(pairs):
        for k in (kernels if i % 2 == 0 else kernels[::-1]):
            dt, result = runners[k]()
            check(k, result)
            times[k].append(dt)
            print(f"[ab] {name} {k}: {dt:.6f}s", flush=True)
    return times


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--out", default=os.path.join(ROOT, ".bench_cache",
                                                 "kernel_ab"))
    p.add_argument("--pr-scale", type=int, default=22)
    p.add_argument("--bfs-scale", type=int, default=20)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    from graphtap.tools.compile_cache import setup_compile_cache
    from graphtap.tools.device_info import device_record, require_gpu
    setup_compile_cache()
    require_gpu()

    import chip_smoke as cs
    from graphtap import Graph, GraphConfig, Compression, make_mesh
    from graphtap.apps.bfs import BFSProgram, bfs_config
    from graphtap.apps.degree import DegreeProgram
    from graphtap.apps.pagerank import PageRankProgram
    from graphtap.config import EngineConfig, Ordering
    from graphtap.engine.executor import Executor, KERNELS
    from graphtap.tools.artifact_cache import cached_rmat

    os.makedirs(args.out, exist_ok=True)
    os.makedirs(cs.CACHE, exist_ok=True)
    mesh = make_mesh(jax.devices()[:1], shape=(1, 1))
    report = {"device": device_record(), "pairs": args.pairs, "apps": {}}

    # ---- PageRank: one graph, one executor pair per kernel
    iters = cs.PR_ITERS
    src, dst, _ = cached_rmat(args.pr_scale, 16, 1, cs.CACHE)
    n = 1 << args.pr_scale
    g = Graph.from_edges(src, dst, None, GraphConfig(
        num_vertices=n, directed=True, transpose=True,
        compression=Compression.TCSC), mesh=mesh)
    t_col, t_row = g.tiled(Ordering.COL), g.tiled(Ordering.ROW)
    want = cs.golden_pagerank(src.astype(np.int64), dst.astype(np.int64),
                              n + 1, iters, cs.CACHE, args.pr_scale)
    prs = {}
    for k in KERNELS:
        deg = Executor(g, DegreeProgram(value_dtype=jnp.float32),
                       EngineConfig(stationary=True, ordering=Ordering.COL),
                       tiles=t_col, kernel=k)
        deg.initialize()
        deg.execute(1)
        pr = Executor(g, PageRankProgram(value_dtype=jnp.float32),
                      EngineConfig(stationary=True, ordering=Ordering.ROW),
                      tiles=t_row, kernel=k)
        pr.initialize(other=deg)
        pr.execute(iters)                 # compile + warm-up
        prs[k] = (deg, pr)

    def pr_runner(k):
        def run():
            deg, pr = prs[k]
            pr.initialize(other=deg)
            jax.block_until_ready(pr.state)
            t = time.perf_counter()
            pr.execute(iters)
            return time.perf_counter() - t, pr
        return run

    def pr_check(k, pr):
        cs.check_ranks(f"pagerank[{k}]", pr.state_vector()["rank"], want)

    nnz = prs[KERNELS[0]][1].tiles.nnz_total
    times = _ab("pagerank", {k: pr_runner(k) for k in KERNELS},
                args.pairs, pr_check)
    report["apps"]["pagerank"] = {
        "scale": args.pr_scale, "iterations": iters, "edges": int(nnz),
        "seconds": times}

    # ---- BFS
    bsrc, bdst, _ = cached_rmat(args.bfs_scale, 16, 1, cs.CACHE)
    bn = 1 << args.bfs_scale
    bg = Graph.from_edges(bsrc, bdst, None, bfs_config(bn), mesh=mesh)
    b_tiles = bg.tiled(Ordering.ROW)
    bwant = cs.golden_bfs(bsrc.astype(np.int64), bdst.astype(np.int64),
                          bn + 1, cs.CACHE, args.bfs_scale)
    bfss = {}
    for k in KERNELS:
        ex = Executor(bg, BFSProgram(root=0),
                      EngineConfig(stationary=False,
                                   apply_depends_on_iter=True,
                                   ordering=Ordering.ROW),
                      tiles=b_tiles, kernel=k)
        ex.initialize()
        ex.execute(0)                     # compile + warm-up
        bfss[k] = ex

    def bfs_runner(k):
        def run():
            ex = bfss[k]
            ex.initialize()
            jax.block_until_ready(ex.state)
            t = time.perf_counter()
            ex.execute(0)
            return time.perf_counter() - t, ex
        return run

    def bfs_check(k, ex):
        cs.check_equal(f"bfs[{k}] hops", ex.state_vector()["hops"],
                       bwant["hops"])

    times = _ab("bfs", {k: bfs_runner(k) for k in KERNELS}, args.pairs,
                bfs_check)
    report["apps"]["bfs"] = {
        "scale": args.bfs_scale, "iterations": bfss[KERNELS[0]].iteration,
        "edges": int(bfss[KERNELS[0]].tiles.nnz_total), "seconds": times}

    # ---- one traced run of each kernel per app
    runners = {"pagerank": pr_runner, "bfs": bfs_runner}
    for app, make in runners.items():
        report["apps"][app]["trace"] = {}
        for k in KERNELS:
            tdir = os.path.join(cs.CACHE, "traces", f"{app}_{k}")
            shutil.rmtree(tdir, ignore_errors=True)
            run = make(k)
            with jax.profiler.trace(tdir):
                run()
            report["apps"][app]["trace"][k] = summarize_trace(tdir)

    for app, rec in report["apps"].items():
        med = {k: statistics.median(v) for k, v in rec["seconds"].items()}
        rec["median_seconds"] = med
        rec["median_gteps"] = {
            k: rec["edges"] * rec["iterations"] / v / 1e9
            for k, v in med.items()}
        print(f"[ab] {app} rmat{rec['scale']} medians: " + ", ".join(
            f"{k}={v:.6f}s ({rec['median_gteps'][k]:.4f} GTEPS)"
            for k, v in med.items()), flush=True)
        for k, tr in rec["trace"].items():
            top = []
            for lname, l in tr["lines"].items():
                if "Compute" in lname:
                    top = [f"{t['name']}={t['ns'] / 1e6:.3f}ms"
                           for t in l["top"][:5]]
            print(f"[ab] {app} {k} trace: busy share "
                  f"{tr['busy_share']}, top ops: {', '.join(top)}",
                  flush=True)
    out = os.path.join(args.out, "kernel_ab.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[ab] wrote {out}")


if __name__ == "__main__":
    main()
