"""SSSP: min-plus relaxation (the only weighted app).

Reference: src/apps/sssp.h (combiner y1 = min(y1, y2 + w); applicator
min-update; unweighted fallback y+1) and sssp.cpp (nonstationary, directed
with transpose flipped for pull along in-edges, self-loops and parallel
edges removed, _TCSC_, gather_depends_on_apply, convergence-driven,
built with -DHAS_WEIGHT).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp

from graphtap.config import Compression, EngineConfig, GraphConfig, Ordering
from graphtap.engine.executor import Executor
from graphtap.engine.program import VertexProgram
from graphtap.ingest.graph import Graph
from graphtap.kernels.semiring import min_plus, min_select, INF_I32


class SSSPProgram(VertexProgram):
    stationary = False
    gather_depends_on_apply = True
    value_dtype = jnp.int32

    def __init__(self, root: int = 0, weighted: bool = True):
        self.semiring = min_plus() if weighted else min_select()
        self.weighted = weighted
        self.root = root

    def init(self, vids, i_mask, other):
        is_root = vids == self.root
        state = {"distance": np.where(is_root, 0, INF_I32).astype(np.int32)}
        return state, is_root

    def messenger(self, state):
        return state["distance"]

    def applicator(self, state, y, iteration):
        if self.weighted:
            new = jnp.minimum(state["distance"], y)
        else:
            # unweighted fallback: hop count y+1 (reference: sssp.h:60-64)
            y1 = jnp.where(y >= INF_I32, INF_I32, y + 1)
            new = jnp.minimum(state["distance"], y1)
        return {"distance": new}, new != state["distance"]

    def infinity(self):
        return INF_I32

    def get_state(self, state):
        return state["distance"]

    def format_state(self, row):
        d = "INF" if row["distance"] == INF_I32 else row["distance"]
        return f"Distance={d}"


def sssp_config(num_vertices: int, weighted: bool = True) -> GraphConfig:
    """sssp.cpp:26-45 defaults. Directed pull: the engine requirement
    ``if(not stationary and directed) transpose = not transpose``
    (sssp.cpp:37-38) flips transpose to True."""
    return GraphConfig(num_vertices=num_vertices, directed=True,
                       transpose=True, self_loops=False, acyclic=False,
                       parallel_edges=False, has_weight=weighted,
                       compression=Compression.TCSC)


def run_sssp(graph: Graph, root: int = 0, weighted: bool = True, kernel: Optional[str] = None) -> Executor:
    ex = Executor(graph, SSSPProgram(root=root, weighted=weighted),
                  EngineConfig(stationary=False, gather_depends_on_apply=True,
                               ordering=Ordering.ROW),
                  kernel=kernel)
    ex.initialize()
    ex.execute(0)
    return ex


if __name__ == "__main__":
    from graphtap.ingest.graph import Graph
    from graphtap.apps._cli import app_main, timed

    def _run(path, nv, root):
        g = Graph.load(path, sssp_config(nv))
        return timed(run_sssp, g, root=root)

    app_main("sssp", _run, third_arg="root", default_third=0)
