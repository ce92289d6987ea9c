"""PageRank: the flagship two-phase pipeline.

Reference: src/apps/pr.h (messenger = rank/degree, combiner = +,
applicator rank = α + (1-α)·y, changed iff |Δ| > tol; α = 0.15,
tol = 1e-5) and pr.cpp: ONE load of Aᵀ (transpose=true), degree phase with
_COL_ ordering (⇒ out-degree of A), then PR with _ROW_ on the same tiles,
state handoff via initialize(V) — the degree is copied only where the
I bit (in-edge mask) is set (vertex_program.hpp:476-483), so vertices
without in-edges keep degree 0 and emit nothing. pr1.cpp is the two-load
variant kept for comparison.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp

from graphtap.config import Compression, EngineConfig, GraphConfig, Ordering
from graphtap.engine.executor import Executor
from graphtap.engine.program import VertexProgram, State
from graphtap.ingest.graph import Graph
from graphtap.kernels.semiring import plus_times
from graphtap.apps.degree import DegreeProgram

ALPHA = 0.15   # reference: pr.h:13
TOL = 1e-5     # reference: pr.h:12


class PageRankProgram(VertexProgram):
    stationary = True

    def __init__(self, value_dtype=jnp.float32, alpha: float = ALPHA,
                 tol: float = TOL):
        self.semiring = plus_times()
        self.value_dtype = value_dtype
        self.alpha = alpha
        self.tol = tol

    def init(self, vids, i_mask, other):
        dt = np.dtype(self.value_dtype)
        degree = np.zeros(vids.shape, dtype=dt)
        if other is not None:
            # copy the degree only where the I bit is set (reference quirk,
            # vertex_program.hpp:476-483) — this is what makes the checksums
            # match the reference exactly.
            degree = np.where(i_mask, other["degree"].astype(dt), degree)
        state = {
            "rank": np.full(vids.shape, self.alpha, dtype=dt),
            "degree": degree,
        }
        return state, i_mask.copy()

    def messenger(self, state):
        d = state["degree"]
        return jnp.where(d > 0, state["rank"] / jnp.where(d > 0, d, 1), 0)

    def applicator(self, state, y, iteration):
        new_rank = self.alpha + (1 - self.alpha) * y
        changed = jnp.abs(new_rank - state["rank"]) > self.tol
        return {"rank": new_rank, "degree": state["degree"]}, changed

    def get_state(self, state):
        return state["rank"]

    def format_state(self, row):
        return f"Rank={row['rank']:.6f},Degree={row['degree']}"


def run_pagerank(graph: Graph, num_iterations: int = 0,
                 value_dtype=jnp.float32, kernel: Optional[str] = None) -> Executor:
    """The pr.cpp pipeline on an already-loaded (transposed) graph.

    ``graph`` must have been loaded with transpose=True (pr.cpp:31).
    num_iterations=0 runs to tol-convergence.
    """
    deg = DegreeProgram(value_dtype=value_dtype)
    deg_ex = Executor(graph, deg,
                      EngineConfig(stationary=True, ordering=Ordering.COL),
                      kernel=kernel)
    deg_ex.initialize()
    deg_ex.execute(1)

    pr = PageRankProgram(value_dtype=value_dtype)
    pr_ex = Executor(graph, pr,
                     EngineConfig(stationary=True, ordering=Ordering.ROW),
                     kernel=kernel)
    pr_ex.initialize(other=deg_ex)
    pr_ex.execute(num_iterations)
    return pr_ex


def run_pagerank_two_load(path: str, num_vertices: int,
                          num_iterations: int = 0,
                          value_dtype=jnp.float32,
                          mesh=None, kernel: Optional[str] = None) -> Executor:
    """pr1.cpp parity: load the graph twice (untransposed for degree,
    transposed for PR) with plain TCSC (pr1.cpp:32-53)."""
    cfg_deg = GraphConfig(num_vertices=num_vertices, directed=True,
                          transpose=False, compression=Compression.TCSC)
    cfg_pr = GraphConfig(num_vertices=num_vertices, directed=True,
                         transpose=True, compression=Compression.TCSC)
    g_deg = Graph.load(path, cfg_deg, mesh=mesh)
    deg_ex = run_degree_for_handoff(g_deg, value_dtype, kernel=kernel)
    g_pr = Graph.load(path, cfg_pr, mesh=mesh)
    pr = PageRankProgram(value_dtype=value_dtype)
    pr_ex = Executor(g_pr, pr,
                     EngineConfig(stationary=True, ordering=Ordering.ROW),
                     kernel=kernel)
    pr_ex.initialize(other=deg_ex)
    pr_ex.execute(num_iterations)
    return pr_ex


def run_degree_for_handoff(graph: Graph, value_dtype=jnp.float32,
                           kernel: Optional[str] = None) -> Executor:
    deg = DegreeProgram(value_dtype=value_dtype)
    ex = Executor(graph, deg,
                  EngineConfig(stationary=True, ordering=Ordering.ROW),
                  kernel=kernel)
    ex.initialize()
    ex.execute(1)
    return ex
