"""Benchmark driver: PageRank GTEPS on RMAT-20, one GPU.

Prints ONE JSON line (stdout):
  {"metric": "pagerank_gteps_rmat20", "value": N, "unit": "GTEPS",
   "vs_baseline": N, "device": {...}, "detail": {...}}

The baseline is the reference's own TCSC SpMSpV kernel
(src/singlenode/tcsc_spmspv2.hpp) compiled with g++ -O2 and run on the CPU
of the host this project was first developed on (not on an accelerator),
over the identical RMAT-20 graph (generated with graphtap.ingest.rmat,
seed 1): 318,767,104 edge-ops in 1.059 s for the 20-iteration PageRank
loop = 0.3009 GTEPS (see BASELINE.md). GTEPS here is counted the same way:
(deduped) stored edges x iterations / loop seconds, excluding ingest and
compile — the reference likewise benchmarks over pre-built RMAT binaries
(graphtap.slurm:43-48), so the host-side tile builds are disk-cached in
.bench_cache/.

Refuses to run without a GPU. Env knobs: BENCH_SCALE, BENCH_ITERS.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# reference TCSC on the original development host's CPU (see docstring)
REF_CPU_GTEPS = 0.3009

SCALE = int(os.environ.get("BENCH_SCALE", "20"))
EDGE_FACTOR = 16
ITERS = int(os.environ.get("BENCH_ITERS", "20"))
SEED = 1
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bench_cache")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def get_tiles(graph, ordering, scale):
    """TileSet for one ordering, disk-memoized."""
    from graphtap.tools import artifact_cache as ac

    t0 = time.perf_counter()
    R, C = graph.mesh.devices.shape
    key = f"rmat{scale}_ef{EDGE_FACTOR}_s{SEED}_{ordering.value}_{R}x{C}"
    tp = os.path.join(CACHE, f"tiles_{key}.npz")
    if os.path.exists(tp):
        tiles = ac.load_tileset(tp)
    else:
        tiles = graph.tiled(ordering)
        ac.save_tileset(tiles, tp)
    log(f"[bench] tiles({ordering.value}) ready "
        f"(+{time.perf_counter() - t0:.0f}s)")
    return tiles


def main(scale=SCALE, iters=ITERS):
    """Run the benchmark, print its JSON line and return the record."""
    t0 = time.perf_counter()
    import numpy as np
    import jax
    import jax.numpy as jnp

    from graphtap.tools.compile_cache import setup_compile_cache
    from graphtap.tools.device_info import device_record, require_gpu
    setup_compile_cache()
    require_gpu()

    from graphtap import Graph, GraphConfig, Compression, make_mesh
    from graphtap.apps.pagerank import PageRankProgram
    from graphtap.apps.degree import DegreeProgram
    from graphtap.config import EngineConfig, Ordering
    from graphtap.engine.executor import Executor
    from graphtap.tools.artifact_cache import cached_rmat

    os.makedirs(CACHE, exist_ok=True)
    src, dst, _ = cached_rmat(scale, EDGE_FACTOR, SEED, CACHE)
    n = 1 << scale
    log(f"[bench] edges ready E={src.size} t={time.perf_counter()-t0:.0f}s")

    mesh = make_mesh(jax.devices()[:1], shape=(1, 1))
    cfg = GraphConfig(num_vertices=n, directed=True, transpose=True,
                      compression=Compression.TCSC)
    g = Graph.from_edges(src, dst, None, cfg, mesh=mesh)
    tiles_col = get_tiles(g, Ordering.COL, scale)
    tiles_row = get_tiles(g, Ordering.ROW, scale)
    log(f"[bench] tiles ready t={time.perf_counter()-t0:.0f}s")

    # degree phase = ONE SpMV outside the timed loop
    t_c = time.perf_counter()
    deg_ex = Executor(g, DegreeProgram(value_dtype=jnp.float32),
                      EngineConfig(stationary=True, ordering=Ordering.COL),
                      tiles=tiles_col)
    deg_ex.sync_uploads()
    upload_s = time.perf_counter() - t_c
    deg_ex.initialize()
    deg_ex.execute(1)
    # release the degree phase's tiles before the PR tiles upload
    # (reference: the free() between programs, vertex_program.hpp:47-54);
    # free() keeps the state vectors the PR initialize(other=...) needs
    deg_ex.free()
    log(f"[bench] degree phase done t={time.perf_counter()-t0:.0f}s")

    t_c = time.perf_counter()
    pr_ex = Executor(g, PageRankProgram(value_dtype=jnp.float32),
                     EngineConfig(stationary=True, ordering=Ordering.ROW),
                     tiles=tiles_row)
    pr_ex.sync_uploads()
    upload_s += time.perf_counter() - t_c
    pr_ex.initialize(other=deg_ex)
    nnz = pr_ex.tiles.nnz_total

    # warmup (compile) — run the full fixed-iteration loop once
    t_w = time.perf_counter()
    pr_ex.execute(iters)
    jax.block_until_ready(pr_ex.state)
    warmup_s = time.perf_counter() - t_w
    log(f"[bench] warmup done t={time.perf_counter()-t0:.0f}s")

    # timed: re-init and run again
    pr_ex.initialize(other=deg_ex)
    jax.block_until_ready(pr_ex.state)
    t1 = time.perf_counter()
    pr_ex.execute(iters)
    jax.block_until_ready(pr_ex.state)
    dt = time.perf_counter() - t1

    gteps = nnz * iters / dt / 1e9
    checksum, _ = pr_ex.checksum()

    # correctness oracle at benchmark scale (reference analog: the
    # cross-format Final-value check, csc_spmv.hpp:222-228): an
    # independent f64 NumPy golden model, disk-memoized; the f32 value
    # path is gated at 1e-4 relative on the checksum.
    gp = os.path.join(CACHE, f"golden_rmat{scale}_ef{EDGE_FACTOR}"
                             f"_s{SEED}_i{iters}.txt")
    if os.path.exists(gp):
        golden_sum = float(open(gp).read())
    else:
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tests"))
        import golden as golden_mod
        v = golden_mod.pagerank(src.astype(np.int64), dst.astype(np.int64),
                                n + 1, iters)
        golden_sum = float(v.sum())
        with open(gp, "w") as f:
            f.write(repr(golden_sum))
    rel = abs(checksum - golden_sum) / abs(golden_sum)
    if not rel < 1e-4:
        raise SystemExit(f"checksum {checksum} vs golden {golden_sum} "
                         f"(rel {rel:.2e})")
    log(f"[bench] checksum ok: {checksum:.2f} vs golden {golden_sum:.4f} "
        f"(rel {rel:.1e})")

    rec = {
        "metric": f"pagerank_gteps_rmat{scale}",
        "value": gteps,
        "unit": "GTEPS",
        "vs_baseline": gteps / REF_CPU_GTEPS,
        "device": device_record(),
        "detail": {
            "edges": int(nnz), "iters": iters, "seconds": dt,
            "checksum": checksum, "kernel": pr_ex.kernel,
            "warmup_seconds": warmup_s,
            "upload_seconds": upload_s,
        },
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
