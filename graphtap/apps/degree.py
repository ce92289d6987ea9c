"""Degree: one plus-times superstep with unit messages.

Reference: src/apps/deg.h (messenger=1, combiner=+, applicator stores y,
never 'changed') and deg.cpp (stationary, _TCSC_, _ROW_, 1 iteration).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp

from graphtap.config import EngineConfig, GraphConfig, Ordering
from graphtap.engine.executor import Executor
from graphtap.engine.program import VertexProgram, State
from graphtap.ingest.graph import Graph
from graphtap.kernels.semiring import plus_times


class DegreeProgram(VertexProgram):
    stationary = True

    def __init__(self, value_dtype=jnp.float32):
        self.semiring = plus_times()
        self.value_dtype = value_dtype

    def init(self, vids, i_mask, other):
        state = {"degree": np.zeros(vids.shape, dtype=np.dtype(self.value_dtype))}
        return state, np.ones(vids.shape, dtype=bool)

    def messenger(self, state):
        return jnp.ones_like(state["degree"])

    def applicator(self, state, y, iteration):
        return {"degree": y}, jnp.zeros(y.shape, dtype=bool)

    def get_state(self, state):
        return state["degree"]

    def format_state(self, row):
        return f"Degree={row['degree']}"


def run_degree(graph: Graph, value_dtype=jnp.float32,
               ordering: Ordering = Ordering.ROW, kernel: Optional[str] = None) -> Executor:
    """Out-degree of the stored matrix (deg.cpp: directed, untransposed,
    _ROW_ → y[src] = Σ 1 over out-edges)."""
    prog = DegreeProgram(value_dtype=value_dtype)
    ex = Executor(graph, prog, EngineConfig(stationary=True, ordering=ordering),
                  kernel=kernel)
    ex.initialize()
    ex.execute(1)
    return ex
