"""Smoke test and first measurement of graphtap's main path on a GPU.

Drives the normal entry points (``Graph.from_edges`` → ``Executor`` →
the apps' vertex programs) on seeded RMAT graphs (graphtap.ingest.rmat,
memoized under .bench_cache/ by ``artifact_cache.cached_rmat``) and checks
every result against the independent NumPy golden models of
tests/golden.py (memoized beside the graphs).

Phases on one card (``python chip_smoke.py``):
  (a) PageRank, RMAT-22 (edge factor 16, seed 1, f32): degree phase, then
      20 iterations — the two-phase pipeline of bench.py;
  (b) BFS from root 0, RMAT-20, through ``bfs_config``;
  (c) CC, RMAT-20, through ``cc_config``;
  (d) SSSP from root 0, RMAT-20 with weights 1..128, through
      ``sssp_config``.

``python chip_smoke.py --chips 4`` runs only the 2-D mesh path: PageRank
RMAT-22 and BFS RMAT-20 on a 2x2 mesh of four cards (all_gather on
``rows``, psum_scatter / all_to_all on ``cols``), each checked against the
goldens and against a one-card run of the same graph in this process.

Each phase prints its set-up seconds (ingest, graph, tiles, upload,
init, compile — the first run of the loop, compilation included), its
loop seconds and GTEPS, and device memory: ``bytes_in_use`` as the phase
starts and right after its timed loop (what the phase holds), and
``peak_bytes_in_use``, the process's running peak since it started (it
never falls, so it is not the phase's own). The card's name and power
limit come from nvidia-smi. The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``,
``count`` being the number of cards the phases ran on, and is printed
only when every phase passed. Without a GPU the script
exits non-zero before any phase runs. The phase functions themselves
take any mesh, so the tests run them on CPU devices at a small scale.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import golden  # noqa: E402  (tests/golden.py: the NumPy oracles)
from graphtap import Graph, GraphConfig, Compression, make_mesh  # noqa: E402
from graphtap.apps.bfs import BFSProgram, bfs_config  # noqa: E402
from graphtap.apps.cc import CCProgram, cc_config  # noqa: E402
from graphtap.apps.degree import DegreeProgram  # noqa: E402
from graphtap.apps.pagerank import PageRankProgram  # noqa: E402
from graphtap.apps.sssp import SSSPProgram, sssp_config  # noqa: E402
from graphtap.config import EngineConfig, Ordering  # noqa: E402
from graphtap.engine.executor import Executor  # noqa: E402
from graphtap.tools.artifact_cache import cached_rmat  # noqa: E402
from graphtap.tools.compile_cache import setup_compile_cache  # noqa: E402
from graphtap.tools.device_info import (NoGPUError, nvidia_smi,  # noqa: E402
                                        require_gpu)

CACHE = os.path.join(ROOT, ".bench_cache")
PR_SCALE = 22
NS_SCALE = 20
EDGE_FACTOR = 16
SEED = 1
PR_ITERS = 20

# PageRank runs in f32 against an f64 golden. Each iteration's y is a sum
# over a vertex's in-edges, and segment_sum's atomics (or the scan's tree)
# add in an order that changes from run to run; an RMAT hub has ~1e5
# in-edges, so one sum can be off by ~sqrt(1e5)*eps32 ~ 2e-5 relative and
# the error feeds the next iteration. rtol 1e-3 leaves a margin of ~50x
# over that; atol 1e-6 covers the 0.15 floor ranks, whose f32 spacing is
# ~1.5e-8. The checksum gate is bench.py's: 1e-4 relative.
PR_RTOL = 1e-3
PR_ATOL = 1e-6
PR_CHECKSUM_RTOL = 1e-4

# any matrix product would be at risk of TF32 on the GPU; the semiring
# SpMV has none, and the compiled loop is checked for one
_DOT = re.compile(r"\bdot\(|gemm|cublas", re.IGNORECASE)


class SmokeFailure(AssertionError):
    """A phase's result disagrees with its reference."""


def log(msg):
    print(msg, file=sys.stderr, flush=True)


# ------------------------------------------------------------------ goldens
def _memo(path, compute):
    """np.savez-memoized dict of arrays."""
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    out = compute()
    np.savez(path + ".tmp.npz", **out)
    os.replace(path + ".tmp.npz", path)
    return out


def golden_pagerank(src, dst, nv, iters, cache, scale):
    p = os.path.join(cache, f"golden_pr_rmat{scale}_ef{EDGE_FACTOR}"
                            f"_s{SEED}_i{iters}.npz")
    return _memo(p, lambda: {"rank": golden.pagerank(src, dst, nv,
                                                     iters)})["rank"]


def golden_bfs(src, dst, nv, cache, scale):
    def compute():
        parent, hops = golden.bfs(src, dst, nv, root=0)
        return {"parent": parent, "hops": hops}
    return _memo(os.path.join(cache, f"golden_bfs_rmat{scale}_ef"
                                     f"{EDGE_FACTOR}_s{SEED}_r0.npz"),
                 compute)


def golden_cc(src, dst, nv, cache, scale):
    p = os.path.join(cache, f"golden_cc_rmat{scale}_ef{EDGE_FACTOR}"
                            f"_s{SEED}.npz")
    return _memo(p, lambda: {"label": golden.cc(src, dst, nv)})["label"]


def golden_sssp(src, dst, w, nv, cache, scale):
    p = os.path.join(cache, f"golden_sssp_rmat{scale}_ef{EDGE_FACTOR}"
                            f"_s{SEED}_r0.npz")
    return _memo(p, lambda: {"distance": golden.sssp(
        src, dst, w, nv, root=0)})["distance"]


# ----------------------------------------------------------------- checks
def check_equal(name, got, want):
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    if got.shape != want.shape:
        raise SmokeFailure(f"{name}: shape {got.shape} != {want.shape}")
    bad = np.flatnonzero(got != want)
    if bad.size:
        i = bad[0]
        raise SmokeFailure(f"{name}: {bad.size} mismatches, first at "
                           f"vertex {i}: {got[i]} != {want[i]}")


def check_ranks(name, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise SmokeFailure(f"{name}: shape {got.shape} vs {want.shape} or "
                           "non-finite values")
    rel = abs(got.sum() - want.sum()) / abs(want.sum())
    if not rel < PR_CHECKSUM_RTOL:
        raise SmokeFailure(f"{name}: checksum {got.sum()} vs {want.sum()} "
                           f"(rel {rel:.3e})")
    err = np.abs(got - want)
    if not np.all(err <= PR_ATOL + PR_RTOL * np.abs(want)):
        i = int(np.argmax(err - PR_RTOL * np.abs(want)))
        raise SmokeFailure(f"{name}: vertex {i}: {got[i]} vs {want[i]}")
    return {"checksum_rel_err": float(rel),
            "max_rel_err": float(np.max(err / np.abs(want)))}


# ------------------------------------------------------------ measurement
def device_bytes(mesh, key):
    """Largest ``memory_stats()[key]`` over the mesh's devices (None where
    the backend keeps no statistics)."""
    vals = [(d.memory_stats() or {}).get(key) for d in mesh.devices.flat]
    vals = [v for v in vals if v is not None]
    return max(vals) if vals else None


def memory(mesh, start):
    """The phase's memory record: ``start`` (bytes in use as it began),
    bytes in use now, and the process's running peak."""
    return {"bytes_in_use_start": start,
            "bytes_in_use": device_bytes(mesh, "bytes_in_use"),
            "peak_bytes_in_use": device_bytes(mesh, "peak_bytes_in_use")}


def check_no_dot(jitted, *args):
    """Fail if the compiled executor loop holds a matrix product. Called
    after the loop's first run, so the compilation is already cached."""
    m = _DOT.search(jitted.lower(*args).compile().as_text())
    if m:
        raise SmokeFailure(f"compiled loop holds a matrix product "
                           f"({m.group(0)!r}); set precision=HIGHEST there")


class _Clock:
    """Set-up laps of one phase; also takes the device's bytes in use as
    the phase starts, once the buffers of earlier phases are collected."""

    def __init__(self, mesh):
        gc.collect()
        self.bytes_start = device_bytes(mesh, "bytes_in_use")
        self.t = time.perf_counter()
        self.setup = {}

    def lap(self, name):
        now = time.perf_counter()
        self.setup[name] = self.setup.get(name, 0.0) + now - self.t
        self.t = now


def _timed_converge(ex, clock):
    """Compile with a first run, then time one run to convergence."""
    ex.initialize()
    clock.lap("init")
    ex.execute(0)
    clock.lap("compile")                # the first run, compile included
    check_no_dot(ex._run_converge, ex.state, ex.changed, ex._tile_pytree)
    ex.initialize()
    jax.block_until_ready(ex.state)
    t = time.perf_counter()
    iters = ex.execute(0)
    return iters, time.perf_counter() - t


# ----------------------------------------------------------------- phases
def phase_pagerank(mesh, scale=PR_SCALE, iters=PR_ITERS, cache=CACHE,
                   kernel=None):
    """(a) degree phase, then ``iters`` PageRank iterations in f32."""
    clock = _Clock(mesh)
    src, dst, _ = cached_rmat(scale, EDGE_FACTOR, SEED, cache)
    clock.lap("ingest")
    n = 1 << scale
    cfg = GraphConfig(num_vertices=n, directed=True, transpose=True,
                      compression=Compression.TCSC)
    g = Graph.from_edges(src, dst, None, cfg, mesh=mesh)
    clock.lap("graph")
    tiles_col, tiles_row = g.tiled(Ordering.COL), g.tiled(Ordering.ROW)
    clock.lap("tiles")

    deg = Executor(g, DegreeProgram(value_dtype=jnp.float32),
                   EngineConfig(stationary=True, ordering=Ordering.COL),
                   tiles=tiles_col, kernel=kernel)
    deg.sync_uploads()
    clock.lap("upload")
    deg.initialize()
    deg.execute(1)
    deg.free()
    clock.lap("degree")

    pr = Executor(g, PageRankProgram(value_dtype=jnp.float32),
                  EngineConfig(stationary=True, ordering=Ordering.ROW),
                  tiles=tiles_row, kernel=kernel)
    pr.sync_uploads()
    clock.lap("upload")
    pr.initialize(other=deg)
    clock.lap("init")
    pr.execute(iters)
    clock.lap("compile")                # the first run, compile included
    check_no_dot(pr._run_fixed, pr.state, pr.changed, pr._tile_pytree, iters)
    pr.initialize(other=deg)
    jax.block_until_ready(pr.state)
    t = time.perf_counter()
    pr.execute(iters)
    jax.block_until_ready(pr.state)
    loop_s = time.perf_counter() - t
    mem = memory(mesh, clock.bytes_start)

    ranks = pr.state_vector()["rank"]
    want = golden_pagerank(src.astype(np.int64), dst.astype(np.int64),
                           n + 1, iters, cache, scale)
    errs = check_ranks("pagerank", ranks, want)
    nnz = pr.tiles.nnz_total
    return {"phase": "pagerank", "scale": scale, "kernel": pr.kernel,
            "mesh": list(mesh.devices.shape), "iterations": iters,
            "edges": int(nnz), "setup_s": clock.setup, "loop_s": loop_s,
            "gteps": nnz * iters / loop_s / 1e9, **mem, **errs}, ranks


def phase_bfs(mesh, scale=NS_SCALE, cache=CACHE, kernel=None):
    """(b) BFS from root 0 to convergence; hops and parents exact."""
    clock = _Clock(mesh)
    src, dst, _ = cached_rmat(scale, EDGE_FACTOR, SEED, cache)
    clock.lap("ingest")
    n = 1 << scale
    g = Graph.from_edges(src, dst, None, bfs_config(n), mesh=mesh)
    clock.lap("graph")
    tiles = g.tiled(Ordering.ROW)
    clock.lap("tiles")
    ex = Executor(g, BFSProgram(root=0),
                  EngineConfig(stationary=False, apply_depends_on_iter=True,
                               ordering=Ordering.ROW),
                  tiles=tiles, kernel=kernel)
    ex.sync_uploads()
    clock.lap("upload")
    iters, loop_s = _timed_converge(ex, clock)
    mem = memory(mesh, clock.bytes_start)

    sv = ex.state_vector()
    want = golden_bfs(src.astype(np.int64), dst.astype(np.int64), n + 1,
                      cache, scale)
    check_equal("bfs hops", sv["hops"], want["hops"])
    reached = want["hops"] != golden.INF
    check_equal("bfs parent", sv["parent"][reached], want["parent"][reached])
    nnz = ex.tiles.nnz_total
    return {"phase": "bfs", "scale": scale, "kernel": ex.kernel,
            "mesh": list(mesh.devices.shape), "iterations": iters,
            "edges": int(nnz), "reached": int(reached.sum()),
            "setup_s": clock.setup, "loop_s": loop_s,
            "gteps": nnz * iters / loop_s / 1e9, **mem}, sv


def phase_cc(mesh, scale=NS_SCALE, cache=CACHE, kernel=None):
    """(c) connected components by min-label propagation; labels exact."""
    clock = _Clock(mesh)
    src, dst, _ = cached_rmat(scale, EDGE_FACTOR, SEED, cache)
    clock.lap("ingest")
    n = 1 << scale
    g = Graph.from_edges(src, dst, None, cc_config(n), mesh=mesh)
    clock.lap("graph")
    tiles = g.tiled(Ordering.ROW)
    clock.lap("tiles")
    ex = Executor(g, CCProgram(),
                  EngineConfig(stationary=False, gather_depends_on_apply=True,
                               ordering=Ordering.ROW),
                  tiles=tiles, kernel=kernel)
    ex.sync_uploads()
    clock.lap("upload")
    iters, loop_s = _timed_converge(ex, clock)
    mem = memory(mesh, clock.bytes_start)

    want = golden_cc(src.astype(np.int64), dst.astype(np.int64), n + 1,
                     cache, scale)
    check_equal("cc labels", ex.state_vector()["label"], want)
    nnz = ex.tiles.nnz_total
    return {"phase": "cc", "scale": scale, "kernel": ex.kernel,
            "mesh": list(mesh.devices.shape), "iterations": iters,
            "edges": int(nnz), "components": int(np.unique(want).size),
            "setup_s": clock.setup, "loop_s": loop_s,
            "gteps": nnz * iters / loop_s / 1e9, **mem}


def phase_sssp(mesh, scale=NS_SCALE, cache=CACHE, kernel=None):
    """(d) SSSP from root 0 with weights 1..128; distances exact."""
    clock = _Clock(mesh)
    src, dst, w = cached_rmat(scale, EDGE_FACTOR, SEED, cache, weighted=True)
    clock.lap("ingest")
    n = 1 << scale
    g = Graph.from_edges(src, dst, w, sssp_config(n), mesh=mesh)
    clock.lap("graph")
    tiles = g.tiled(Ordering.ROW)
    clock.lap("tiles")
    ex = Executor(g, SSSPProgram(root=0),
                  EngineConfig(stationary=False, gather_depends_on_apply=True,
                               ordering=Ordering.ROW),
                  tiles=tiles, kernel=kernel)
    ex.sync_uploads()
    clock.lap("upload")
    iters, loop_s = _timed_converge(ex, clock)
    mem = memory(mesh, clock.bytes_start)

    want = golden_sssp(src.astype(np.int64), dst.astype(np.int64),
                       w.astype(np.int64), n + 1, cache, scale)
    check_equal("sssp distance", ex.state_vector()["distance"], want)
    nnz = ex.tiles.nnz_total
    return {"phase": "sssp", "scale": scale, "kernel": ex.kernel,
            "mesh": list(mesh.devices.shape), "iterations": iters,
            "edges": int(nnz), "reached": int((want != golden.INF).sum()),
            "setup_s": clock.setup, "loop_s": loop_s,
            "gteps": nnz * iters / loop_s / 1e9, **mem}


def phase_mesh(devices, pr_scale=PR_SCALE, bfs_scale=NS_SCALE,
               iters=PR_ITERS, cache=CACHE):
    """PageRank and BFS on a 2x2 mesh of ``devices[:4]``, each checked
    against the goldens (inside the phases) and against a one-device run
    of the same graph."""
    mesh4 = make_mesh(devices[:4], shape=(2, 2))
    mesh1 = make_mesh(devices[:1], shape=(1, 1))
    out = []
    pr4, ranks4 = phase_pagerank(mesh4, pr_scale, iters, cache)
    pr1, ranks1 = phase_pagerank(mesh1, pr_scale, iters, cache)
    # both are f32 sums in different orders: the golden tolerance applies
    pr4["vs_one_device"] = check_ranks("pagerank 2x2 vs 1x1", ranks4,
                                       ranks1)
    out += [pr4, pr1]
    bfs4, sv4 = phase_bfs(mesh4, bfs_scale, cache)
    bfs1, sv1 = phase_bfs(mesh1, bfs_scale, cache)
    for k in ("hops", "parent"):
        check_equal(f"bfs {k} 2x2 vs 1x1", sv4[k], sv1[k])
    if bfs4["iterations"] != bfs1["iterations"]:
        raise SmokeFailure(f"bfs iterations {bfs4['iterations']} on 2x2 vs "
                           f"{bfs1['iterations']} on 1x1")
    out += [bfs4, bfs1]
    return out


def _report(label, rec):
    s = rec["setup_s"]
    setup = " ".join(f"{k}={v:.2f}s" for k, v in s.items())
    mem = {k: "not available" if rec[k] is None else rec[k]
           for k in ("bytes_in_use_start", "bytes_in_use",
                     "peak_bytes_in_use")}
    print(f"[{label}] {rec['phase']} rmat{rec['scale']} mesh "
          f"{rec['mesh'][0]}x{rec['mesh'][1]} kernel={rec['kernel']}: "
          f"setup {setup} (total {sum(s.values()):.2f}s) | loop "
          f"{rec['loop_s']:.6f}s over {rec['iterations']} iterations, "
          f"{rec['gteps']:.4f} GTEPS | bytes_in_use at start "
          f"{mem['bytes_in_use_start']}, after the loop "
          f"{mem['bytes_in_use']} | process peak_bytes_in_use "
          f"{mem['peak_bytes_in_use']}", flush=True)
    print(json.dumps(rec), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chips", type=int, choices=(1, 4), default=1,
                   help="1: phases (a)-(d) on one card; 4: only the 2x2 "
                        "mesh path and its one-card comparison")
    args = p.parse_args(argv)

    setup_compile_cache()
    try:
        require_gpu()
    except NoGPUError as e:
        log(f"chip_smoke: {e}")
        return 2
    devs = jax.devices()
    if len(devs) < args.chips:
        log(f"chip_smoke: --chips {args.chips} needs {args.chips} GPUs, "
            f"JAX sees {len(devs)}")
        return 2
    for line in nvidia_smi():
        print(f"[device] {line}", flush=True)
    os.makedirs(CACHE, exist_ok=True)

    t0 = time.perf_counter()
    used = devs[:args.chips]
    if args.chips == 4:
        for rec in phase_mesh(used):
            _report("mesh", rec)
    else:
        mesh = make_mesh(used, shape=(1, 1))
        _report("a", phase_pagerank(mesh)[0])
        _report("b", phase_bfs(mesh)[0])
        _report("c", phase_cc(mesh))
        _report("d", phase_sssp(mesh))
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": used[0].platform, "kind": used[0].device_kind,
        "count": len(used)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
