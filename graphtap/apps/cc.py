"""Connected components via min-label propagation.

Reference: src/apps/cc.h (messenger = label, combiner = min, applicator
keeps the min, changed iff the label shrank, infinity = INT32_MAX) and
cc.cpp (nonstationary, undirected, parallel edges removed, _TCSC_,
gather_depends_on_apply, convergence-driven).
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


class CCProgram(VertexProgram):
    stationary = False
    gather_depends_on_apply = True
    value_dtype = jnp.int32

    def __init__(self):
        self.semiring = min_select()

    def init(self, vids, i_mask, other):
        state = {"label": vids.astype(np.int32)}
        return state, np.ones(vids.shape, dtype=bool)

    def messenger(self, state):
        return state["label"]

    def applicator(self, state, y, iteration):
        new = jnp.minimum(state["label"], y)
        return {"label": new}, new != state["label"]

    def infinity(self):
        return INF_I32

    def get_state(self, state):
        return state["label"]

    def format_state(self, row):
        return f"Label={row['label']}"


def cc_config(num_vertices: int) -> GraphConfig:
    """cc.cpp:25-43 defaults: undirected, keep self-loops, dedup parallel."""
    return GraphConfig(num_vertices=num_vertices, directed=False,
                       transpose=False, self_loops=True, acyclic=False,
                       parallel_edges=False, compression=Compression.TCSC)


def run_cc(graph: Graph, kernel: Optional[str] = None) -> Executor:
    ex = Executor(graph, CCProgram(),
                  EngineConfig(stationary=False, gather_depends_on_apply=True,
                               ordering=Ordering.ROW),
                  kernel=kernel)
    ex.initialize()
    ex.execute(0)
    return ex


if __name__ == "__main__":
    from graphtap.ingest.graph import Graph
    from graphtap.apps._cli import app_main, timed

    def _run(path, nv, _third):
        g = Graph.load(path, cc_config(nv))
        return timed(run_cc, g)

    app_main("cc", _run, third_arg="iters", default_third=0)
