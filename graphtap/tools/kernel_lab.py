"""Single-chip kernel lab: compare SpMV implementations on one graph.

The analog of the reference's ``src/singlenode/`` harness
(main.cpp: 6 format/kernel variants running the same PageRank and printing
memory / time / op count / checksum for cross-checking). Here the variants
are the engine's SpMV kernels and tile formats behind one API (numbers 3-6
belonged to removed kernels and are not reused):

  0  scan      — XLA segmented-scan TCSC
  1  segment   — jax.ops.segment_sum TCSC
  2  scan-csc  — segmented scan over plain CSC (no renumbering)
  7  scan-cf   — TCSC_CF phase execution (the reference ODCSC/LA3
                 regular/source-split idea, odcsc_spmspv.hpp:479-566 —
                 design-collapsed into the CF first/middle/last subsets)
  8  scan-dcsc — DCSC: compact nnz-col ids + x gathered through the JC
                 table (reference: dcsc_spmv.hpp:216-230)

Cross-checks (reference: csc_spmv.hpp:222-228 — op counts and checksums
must agree across formats): ``operations`` = stored nnz x iterations is
computed from each variant's OWN tileset, so a format that dropped or
duplicated edges breaks the equality; ``slots`` counts the padded edge slots
the variant streams (its work amplification), which is allowed to
differ — that's the design tradeoff being measured.

Usage: python -m graphtap.tools.kernel_lab <which 0|1|2|7|8> <file> <nvertices> <niters>
(mirrors ``bin/main <which> <file> <nvertices> <niters>``,
singlenode/main.cpp:26).
"""

from __future__ import annotations

import sys
import time

import numpy as np


VARIANTS = {0: ("scan", "tcsc"), 1: ("segment", "tcsc"),
            2: ("scan", "csc"), 7: ("scan", "tcsc_cf"),
            # 8: DCSC — compact col ids, x gathered through JC (the
            # reference lab's dcsc_spmv.hpp:216-230 shape)
            8: ("scan", "dcsc")}


def run_variant(which: int, path: str, nvertices: int, niters: int,
                value_dtype=None) -> dict:
    import jax
    import jax.numpy as jnp
    from graphtap import Graph, GraphConfig, Compression, make_mesh
    from graphtap.apps.degree import DegreeProgram
    from graphtap.apps.pagerank import PageRankProgram
    from graphtap.config import EngineConfig, Ordering
    from graphtap.engine.executor import Executor

    if value_dtype is None:
        value_dtype = jnp.float32
    kernel, comp = VARIANTS[which]
    compression = {"tcsc": Compression.TCSC, "csc": Compression.CSC,
                   "tcsc_cf": Compression.TCSC_CF,
                   "dcsc": Compression.DCSC}[comp]

    mesh = make_mesh(jax.devices()[:1], shape=(1, 1))
    cfg = GraphConfig(num_vertices=nvertices, directed=True, transpose=True,
                      compression=compression)
    g = Graph.load(path, cfg, mesh=mesh)

    deg_ex = Executor(g, DegreeProgram(value_dtype=value_dtype),
                      EngineConfig(stationary=True, ordering=Ordering.COL),
                      tiles=g.tiled(Ordering.COL,
                                    compression=Compression.TCSC
                                    if comp == "tcsc_cf" else None),
                      kernel=kernel)
    deg_ex.initialize()
    deg_ex.execute(1)

    pr_ex = Executor(g, PageRankProgram(value_dtype=value_dtype),
                     EngineConfig(stationary=True, ordering=Ordering.ROW),
                     kernel=kernel)
    pr_ex.initialize(other=deg_ex)
    pr_ex.execute(niters)  # warmup/compile
    pr_ex.initialize(other=deg_ex)
    t0 = time.perf_counter()
    pr_ex.execute(niters)
    dt = time.perf_counter() - t0

    nnz = pr_ex.tiles.nnz_total
    checksum, reachable = pr_ex.checksum()
    mem = sum(a.nbytes for a in
              (pr_ex.tiles.rows, pr_ex.tiles.cols, pr_ex.tiles.ja)
              if a is not None)
    slots = pr_ex.tiles.Ep * niters
    return {
        "variant": f"{kernel}/{comp}",
        "memory_gb": mem / 1e9,
        "seconds": dt,
        "operations": nnz * niters,
        "slots": slots,
        "pad_factor": slots / max(1, nnz * niters),
        "gteps": nnz * niters / dt / 1e9,
        "checksum": checksum,
        "reachable": reachable,
    }


def main(argv=None):
    argv = argv or sys.argv[1:]
    if len(argv) != 4 or int(argv[0]) not in VARIANTS:
        print(f"Usage: kernel_lab <which {sorted(VARIANTS)}> <file> "
              "<nvertices> <niters>")
        return 1
    which, path, nv, niters = int(argv[0]), argv[1], int(argv[2]), int(argv[3])
    r = run_variant(which, path, nv, niters)
    print(f"{r['variant']} kernel unit test stats:")
    print(f"Utilized Memory: {r['memory_gb']:.6g} GB")
    print(f"Elapsed time   : {r['seconds']:.6g} Sec")
    print(f"Num Operations : {r['operations']}")
    print(f"Slots Streamed : {r['slots']} (pad x{r['pad_factor']:.2f})")
    print(f"GTEPS          : {r['gteps']:.4f}")
    print(f"Final value    : {r['checksum']:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
