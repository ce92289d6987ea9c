"""Nonstationary (BFS) profile on the device: scan vs segment SpMV.

Per-kernel best-of-3 BFS time to convergence on identical tiles, then a
per-phase superstep breakdown (scatter_gather / combine / apply, the
-DTIMING analog) and per-iteration times for the engine's default kernel
— where a frontier-sparse late iteration would show as a short combine.

Tiles are disk-cached in .bench_cache so re-runs skip the build.

Usage: python tools_dev/bfs_profile.py [scale]
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CACHE = os.path.join(ROOT, ".bench_cache")


def artifacts(scale):
    import jax
    from graphtap import Graph, make_mesh
    from graphtap.apps.bfs import bfs_config
    from graphtap.config import Ordering
    from graphtap.tools import artifact_cache as ac

    src, dst, _ = ac.cached_rmat(scale, 16, 1, CACHE)
    nv = (1 << scale) + 1
    mesh = make_mesh(jax.devices()[:1], shape=(1, 1))
    g = Graph.from_edges(src, dst, None, bfs_config(nv), mesh=mesh)
    key = f"rmat{scale}_ef16_s1_row_1x1"
    tp = os.path.join(CACHE, f"tiles_{key}.npz")
    if os.path.exists(tp):
        tiles = ac.load_tileset(tp)
    else:
        tiles = g.tiled(Ordering.ROW)
        ac.save_tileset(tiles, tp)
    return g, tiles


def main():
    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 18
    from graphtap.tools.compile_cache import setup_compile_cache
    setup_compile_cache()
    from graphtap.apps.bfs import BFSProgram
    from graphtap.config import EngineConfig, Ordering
    from graphtap.engine.executor import Executor, KERNELS, DEFAULT_KERNEL

    t0 = time.perf_counter()
    g, tiles = artifacts(scale)
    print(f"[prof] artifacts ready +{time.perf_counter()-t0:.0f}s",
          file=sys.stderr)

    def run(kernel):
        ex = Executor(g, BFSProgram(root=0),
                      EngineConfig(stationary=False,
                                   apply_depends_on_iter=True,
                                   ordering=Ordering.ROW),
                      tiles=tiles, kernel=kernel)
        ex.initialize()
        ex.execute(0)                      # warmup/compile
        best = float("inf")
        for _ in range(3):
            ex.initialize()
            t1 = time.perf_counter()
            iters = ex.execute(0)
            best = min(best, time.perf_counter() - t1)
        cs, reach = ex.checksum()
        print(f"[prof] {kernel}: {best:.4f}s / {iters} iters "
              f"cs={cs:.0f}/{reach}", file=sys.stderr)
        return ex, best, iters, cs

    runs = {k: run(k) for k in KERNELS}
    assert len({(r[2], r[3]) for r in runs.values()}) == 1, \
        "kernels disagree"
    print("[prof] best seconds: " + " / ".join(
        f"{k}={r[1]:.4f}" for k, r in runs.items()))

    # per-phase, per-iteration breakdown for the default kernel
    ex = runs[DEFAULT_KERNEL][0]
    ex.initialize()
    timer = ex.execute_profiled(0, printer=None)
    print(f"[prof] per-phase totals (s), kernel={DEFAULT_KERNEL}:")
    for name, xs in timer.samples.items():
        per = " ".join(f"{x*1e3:.1f}" for x in xs)
        print(f"  {name:15s} total={sum(xs):.4f}  per-iter(ms): {per}")


if __name__ == "__main__":
    main()
