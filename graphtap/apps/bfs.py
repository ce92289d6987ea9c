"""BFS: frontier-driven parent/hops via min-vid messages.

Reference: src/apps/bfs.h (messenger = vid, combiner = min, applicator
sets hops = iteration+1 and parent = y only for unvisited vertices —
requires apply_depends_on_iter) and bfs.cpp (nonstationary, undirected,
self-loops removed, parallel edges removed, _TCSC_, convergence-driven;
the changed bitmap C is the frontier).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp

from graphtap.config import Compression, EngineConfig, GraphConfig, Ordering
from graphtap.engine.executor import Executor
from graphtap.engine.program import VertexProgram
from graphtap.ingest.graph import Graph
from graphtap.kernels.semiring import min_select, INF_I32


class BFSProgram(VertexProgram):
    stationary = False
    apply_depends_on_iter = True
    value_dtype = jnp.int32

    def __init__(self, root: int = 0):
        self.semiring = min_select()
        self.root = root

    def init(self, vids, i_mask, other):
        is_root = vids == self.root
        state = {
            "vid": vids.astype(np.int32),
            "parent": np.where(is_root, self.root, 0).astype(np.int32),
            "hops": np.where(is_root, 0, INF_I32).astype(np.int32),
        }
        return state, is_root

    def messenger(self, state):
        return state["vid"]

    def applicator(self, state, y, iteration):
        unvisited = state["hops"] == INF_I32
        found = y != INF_I32
        newly = unvisited & found
        hops = jnp.where(newly, iteration.astype(jnp.int32) + 1, state["hops"])
        parent = jnp.where(newly, y, state["parent"])
        return {"vid": state["vid"], "parent": parent, "hops": hops}, newly

    def infinity(self):
        return INF_I32

    def get_state(self, state):
        return state["hops"]

    def format_state(self, row):
        h = "INF" if row["hops"] == INF_I32 else row["hops"]
        return f"Parent={row['parent']},Hops={h}"


def bfs_config(num_vertices: int) -> GraphConfig:
    """bfs.cpp:26-45 defaults."""
    return GraphConfig(num_vertices=num_vertices, directed=False,
                       transpose=False, self_loops=False, acyclic=False,
                       parallel_edges=False, compression=Compression.TCSC)


def run_bfs(graph: Graph, root: int = 0, kernel: Optional[str] = None) -> Executor:
    ex = Executor(graph, BFSProgram(root=root),
                  EngineConfig(stationary=False, apply_depends_on_iter=True,
                               ordering=Ordering.ROW),
                  kernel=kernel)
    ex.initialize()
    ex.execute(0)
    return ex


if __name__ == "__main__":
    from graphtap.ingest.graph import Graph
    from graphtap.apps._cli import app_main, timed

    def _run(path, nv, root):
        g = Graph.load(path, bfs_config(nv))
        return timed(run_bfs, g, root=root)

    app_main("bfs", _run, third_arg="root", default_third=0)
