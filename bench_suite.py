"""Benchmark suite: the north-star metrics beyond the single headline run
(BASELINE.md; reference: graphtap.slurm:43-72 app/scale matrix).

Covers:
  * BFS / SSSP / CC wall-clock to convergence on an RMAT graph
    (reference rows: bfs/sssp/cc in graphtap.slurm:50-72)
  * PageRank iterations/sec at a larger scale (north-star: RMAT-24)

Everything runs in this one process on one GPU (a second JAX process
would find the card's memory already reserved); it refuses to run
without a GPU. The mesh path across several cards is checked by
``chip_smoke.py --chips 4``.

Writes one JSON object per line to BENCH_SUITE.json (and stdout); every
line carries the device record (graphtap/tools/device_info.py).
Env knobs: SUITE_SCALE (default 18), SUITE_PR_SCALE (default 22),
SUITE_PR_ITERS (default 5).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SCALE = int(os.environ.get("SUITE_SCALE", "18"))
PR_SCALE = int(os.environ.get("SUITE_PR_SCALE", "22"))
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bench_cache")
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "BENCH_SUITE.json")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def emit(fh, rec):
    from graphtap.tools.device_info import device_record
    line = json.dumps({**rec, "device": device_record()})
    print(line, flush=True)
    fh.write(line + "\n")
    fh.flush()


_DONE = set()


def done(metric):
    return metric in _DONE


def _graph(scale, cfg_fn, weighted=False):
    import jax
    from graphtap import Graph, make_mesh
    from graphtap.tools.artifact_cache import cached_rmat
    src, dst, w = cached_rmat(scale, 16, 1, CACHE, weighted=weighted)
    mesh = make_mesh(jax.devices()[:1], shape=(1, 1))
    return Graph.from_edges(src, dst, w, cfg_fn(1 << scale), mesh=mesh)


def _row_tiles(g, scale, weighted):
    """Disk-cached ROW tiles for the nonstationary apps, so a re-run (or
    an A/B after a kernel change) skips the tile build."""
    from graphtap.config import Ordering
    from graphtap.tools import artifact_cache as ac
    tag = "w" if weighted else ""
    key = f"rmat{scale}_ef16_s1{tag}_row_1x1"
    tp = os.path.join(CACHE, f"tiles_{key}.npz")
    if os.path.exists(tp):
        tiles = ac.load_tileset(tp)
    else:
        tiles = g.tiled(Ordering.ROW)
        ac.save_tileset(tiles, tp)
    return tiles


def _golden_nonstationary(name):
    """Disk-memoized golden (checksum, reachable) for one app at SCALE
    (reference analog: the SLURM greps of the checksum lines,
    graphtap.slurm:101-104 — here checked against an independent NumPy
    model instead of a second run)."""
    import numpy as np
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import golden
    from graphtap.tools.artifact_cache import cached_rmat
    gp = os.path.join(CACHE, f"golden_{name}_rmat{SCALE}_ef16_s1.txt")
    if os.path.exists(gp):
        cs, reach = open(gp).read().split()
        return float(cs), int(reach)
    nv = (1 << SCALE) + 1
    if name == "sssp":
        s, d, w = cached_rmat(SCALE, 16, 1, CACHE, weighted=True)
        dist = golden.sssp(s.astype(np.int64), d.astype(np.int64),
                           w.astype(np.int64), nv, 0)
        m = dist != golden.INF
        cs, reach = float(dist[m].sum()), int(m.sum())
    else:
        s, d, _ = cached_rmat(SCALE, 16, 1, CACHE)
        if name == "bfs":
            _, hops = golden.bfs(s.astype(np.int64), d.astype(np.int64),
                                 nv, 0)
            m = hops != golden.INF
            cs, reach = float(hops[m].sum()), int(m.sum())
        else:
            lab = golden.cc(s.astype(np.int64), d.astype(np.int64), nv)
            cs, reach = float(lab.sum()), int(lab.size)
    with open(gp, "w") as f:
        f.write(f"{cs!r} {reach}")
    return cs, reach


def nonstationary_apps(fh):
    import jax
    from graphtap.apps.bfs import BFSProgram, bfs_config
    from graphtap.apps.cc import CCProgram, cc_config
    from graphtap.apps.sssp import SSSPProgram, sssp_config
    from graphtap.config import EngineConfig, Ordering
    from graphtap.engine.executor import Executor

    runs = [
        ("bfs", bfs_config, False, BFSProgram(root=0),
         dict(stationary=False, apply_depends_on_iter=True)),
        ("cc", cc_config, False, CCProgram(),
         dict(stationary=False, gather_depends_on_apply=True)),
        ("sssp", sssp_config, True, SSSPProgram(root=0),
         dict(stationary=False, gather_depends_on_apply=True)),
    ]
    for name, cfg_fn, weighted, prog, eflags in runs:
        if done(f"{name}_seconds_rmat{SCALE}"):
            log(f"[suite] {name}: already recorded, skipping")
            continue
        t0 = time.perf_counter()
        g = _graph(SCALE, cfg_fn, weighted=weighted)
        tiles = _row_tiles(g, SCALE, weighted)
        ex = Executor(g, prog,
                      EngineConfig(ordering=Ordering.ROW, **eflags),
                      tiles=tiles)
        ex.sync_uploads()
        upload_s = time.perf_counter() - t0
        log(f"[suite] {name}: " + ex.tiles.balance_report())
        ex.initialize()
        t_build = time.perf_counter() - t0
        # warmup/compile pass, then re-init and time (the reference times
        # over pre-built binaries with hot caches, graphtap.slurm:43-48)
        t_w = time.perf_counter()
        ex.execute(0)
        warmup_s = time.perf_counter() - t_w
        ex.initialize()
        jax.block_until_ready(ex.state)
        t1 = time.perf_counter()
        iters = ex.execute(0)          # to convergence
        dt = time.perf_counter() - t1
        cs, reach = ex.checksum()
        gcs, greach = _golden_nonstationary(name)
        # reachable count must match exactly; the value checksum gets a
        # tiny relative tolerance — at larger SUITE_SCALE the device f32
        # accumulation leaves the exactly-representable integer range
        # even on a correct run
        assert reach == greach and (
            cs == gcs or abs(cs - gcs) <= 1e-6 * max(abs(gcs), 1.0)), (
            f"{name}: checksum {cs}/{reach} != golden {gcs}/{greach}")
        log(f"[suite] {name}: checksum ok vs golden ({cs:.0f}/{reach})")
        nnz = ex.tiles.nnz_total
        emit(fh, {
            "metric": f"{name}_seconds_rmat{SCALE}", "value": dt,
            "unit": "s", "detail": {
                "iterations": iters, "edges": int(nnz),
                "gteps": nnz * iters / dt / 1e9,
                "checksum": cs, "reachable": reach, "kernel": ex.kernel,
                "build_seconds": t_build,
                "upload_seconds": upload_s,
                "warmup_seconds": warmup_s,
                "imbalance": ex.tiles.edge_balance()["imbalance"]}})


def pagerank_large(fh):
    """Large-scale PR through the bench.py driver, in this process (shared
    artifact caches + the f64 golden checksum gate + the degree-phase
    free()); the suite records the derived iters/s."""
    if done(f"pagerank_iters_per_sec_rmat{PR_SCALE}"):
        log("[suite] pagerank_large: already recorded, skipping")
        return
    import bench
    rec = bench.main(scale=PR_SCALE,
                     iters=int(os.environ.get("SUITE_PR_ITERS", "5")))
    d = rec["detail"]
    emit(fh, {
        "metric": f"pagerank_iters_per_sec_rmat{PR_SCALE}",
        "value": d["iters"] / d["seconds"], "unit": "iters/s",
        "detail": {**d, "gteps": rec["value"],
                   "vs_cpu_baseline": rec["vs_baseline"]}})


def main():
    from graphtap.tools.compile_cache import setup_compile_cache
    from graphtap.tools.device_info import require_gpu
    setup_compile_cache()
    require_gpu()
    os.makedirs(CACHE, exist_ok=True)
    # resumable: metrics already in BENCH_SUITE.json are kept and skipped
    if os.path.exists(OUT):
        for ln in open(OUT):
            if ln.strip():
                _DONE.add(json.loads(ln)["metric"])
    with open(OUT, "a") as fh:
        nonstationary_apps(fh)
        pagerank_large(fh)


if __name__ == "__main__":
    main()
