"""graphtap — a distributed graph-analytics framework in JAX.

A from-scratch JAX/XLA re-creation of the capabilities of
hmofrad/GraphTap (C++/MPI, IEEE CLUSTER 2019): linear-algebra (matrix-view)
vertex-centric graph processing, where one superstep of a vertex program is a
semiring SpMV/SpMSpV ``y = A (x)`` over a 2D-tiled sparse adjacency matrix,
followed by an apply step.

Instead of GraphTap's MPI leader/follower choreography
(reference: src/mpi/env.hpp, src/vp/vertex_program.hpp), communication is
expressed as mesh-axis collectives under ``jax.shard_map`` on a
``('rows','cols')`` device mesh: the message vector x is all-gathered along
the ``rows`` axis (column groups), and partial accumulators y are
reduce-scattered along the ``cols`` axis (row groups). The diagonal
leader-election of the reference (matrix.hpp:327-341) is replaced by a
segment-to-device alignment built into the tiling (see parallel/layout.py).
"""

from graphtap.config import GraphConfig, EngineConfig, Compression, Ordering
from graphtap.parallel.layout import Partition, make_mesh
from graphtap.ingest.graph import Graph
from graphtap.engine.program import VertexProgram
from graphtap.engine.executor import Executor
from graphtap.kernels.semiring import Semiring, plus_times, min_plus, min_select

__version__ = "0.1.0"

__all__ = [
    "GraphConfig", "EngineConfig", "Compression", "Ordering",
    "Partition", "make_mesh", "Graph", "VertexProgram", "Executor",
    "Semiring", "plus_times", "min_plus", "min_select",
]
