"""Worker for the REAL multi-process test (tests/test_multiprocess.py).

Each process: jax.distributed.initialize against a local coordinator,
1 CPU device per process, byte-range read of the edge-list file given on
the command line -> exchange_edges -> PageRank on the (1, P) mesh. Process 0 prints the checksum line the
parent asserts on (reference run mode: mpirun -np N bin/pr,
README.md:7-10; ingest exchange: matrix.hpp:692-810).
"""
import os
import sys

idx = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]
path = sys.argv[4]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=idx)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from graphtap import Graph, GraphConfig, Compression  # noqa: E402
from graphtap.apps.pagerank import run_pagerank  # noqa: E402
from graphtap.parallel.layout import make_mesh  # noqa: E402

assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == nproc

mesh = make_mesh(jax.devices(), shape=(1, nproc))
cfg = GraphConfig(num_vertices=1024, directed=True, transpose=True,
                  compression=Compression.TCSC)
g = Graph.load(path, cfg, mesh=mesh)

# every process holds exactly its devices' edges; the global count is
# conserved (graph.hpp:299-300)
from graphtap.parallel import multihost as mh  # noqa: E402
total = int(mh.global_sum(np.int64(g.nedges)))
ex = run_pagerank(g, num_iterations=20, value_dtype=jnp.float64)
cs, reach = ex.checksum()

# TCSC_CF (the pr.cpp flagship compression): exercises the cross-process
# OR inside classify_vertices — each host sees only its own edge share,
# so without the OR the source/sink classes would differ per host
cfg_cf = GraphConfig(num_vertices=1024, directed=True, transpose=True,
                     compression=Compression.TCSC_CF)
g_cf = Graph.load(path, cfg_cf, mesh=mesh)
ex_cf = run_pagerank(g_cf, num_iterations=20, value_dtype=jnp.float64)
cs_cf, reach_cf = ex_cf.checksum()

# the other SpMV kernel across 2 real processes, f32 (the distributed
# tile sweep, vertex_program.hpp:1058-1113)
ex_s = run_pagerank(g, num_iterations=20, value_dtype=jnp.float32,
                    kernel="segment")
cs_s, reach_s = ex_s.checksum()

if idx == 0:
    print(f"EDGES {total}")
    print(f"CHECKSUM {cs:.6f} {reach}")
    print(f"CHECKSUM_CF {cs_cf:.6f} {reach_cf}")
    print(f"CHECKSUM_SEGMENT {cs_s:.6f} {reach_s}", flush=True)
