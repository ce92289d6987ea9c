"""Sparse-exchange crossover measurement.

The engine's activity-filtered exchange (`executor._exchange_x/_y`,
reference: the sparse/dense vote at activity ratio <= 0.6,
vertex_program.hpp:767, :1378) ships compacted (index, value) pairs
instead of dense vectors when every sender's active count fits the
``sparse_exchange_capacity`` knob.  This bench sweeps the knob for BFS
on the virtual 8-device mesh and records where (whether) it wins, so
the knob's default has a measurement behind it instead of a guess.

Must run in its own process (sets JAX_PLATFORMS=cpu + 8 virtual
devices before importing jax).  Appends one row to BENCH_SUITE.json.

Usage: python tools_dev/sparse_exchange_bench.py [scale]
"""

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags +
                               " --xla_force_host_platform_device_count=8")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CACHE = os.path.join(ROOT, ".bench_cache")


def main():
    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    import jax
    jax.config.update("jax_platforms", "cpu")
    from graphtap import Graph, make_mesh
    from graphtap.apps.bfs import BFSProgram, bfs_config
    from graphtap.config import EngineConfig, Ordering
    from graphtap.engine.executor import Executor
    from graphtap.tools.artifact_cache import cached_rmat

    src, dst, _ = cached_rmat(scale, 16, 1, CACHE)
    mesh = make_mesh(jax.devices()[:8], shape=(2, 4))
    nv = (1 << scale) + 1
    g = Graph.from_edges(src, dst, None, bfs_config(nv), mesh=mesh)
    tiles = g.tiled(Ordering.ROW)

    rows, golden = [], None
    for K in (0, 256, 1024, 4096, 16384):
        ex = Executor(g, BFSProgram(root=0),
                      EngineConfig(stationary=False,
                                   apply_depends_on_iter=True,
                                   ordering=Ordering.ROW,
                                   sparse_exchange_capacity=K),
                      tiles=tiles, kernel="scan")
        ex.initialize()
        ex.execute(0)                 # warmup/compile
        best = float("inf")
        for _ in range(3):
            ex.initialize()
            t0 = time.perf_counter()
            iters = ex.execute(0)
            best = min(best, time.perf_counter() - t0)
        cs, reach = ex.checksum()
        if golden is None:
            golden = (cs, reach)
        assert (cs, reach) == golden, (K, cs, reach, golden)
        rows.append({"K": K, "seconds": round(best, 4), "iters": iters})
        print(f"[sparse-x] K={K}: {best:.4f}s / {iters} iters",
              file=sys.stderr)

    dense = rows[0]["seconds"]
    wins = [r for r in rows[1:] if r["seconds"] < dense]
    rec = {
        "metric": f"sparse_exchange_crossover_rmat{scale}",
        "value": round(min(r["seconds"] for r in rows[1:]) / dense, 3),
        "unit": "best sparse/dense time ratio (<1 = sparse wins)",
        "detail": {
            "rows": rows, "mesh": "2x4 virtual CPU",
            "app": "bfs to convergence, best of 3",
            "note": ("single-host collectives are memcpy, so this bounds "
                     "the protocol's overhead, not interconnect savings; "
                     "the knob stays default-off unless sparse wins here "
                     "or in a multi-card measurement" if not wins else
                     "sparse exchange wins on-host at these capacities")}}
    line = json.dumps(rec)
    print(line)
    with open(os.path.join(ROOT, "BENCH_SUITE.json"), "a") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
