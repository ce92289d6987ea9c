"""VertexProgram: the five-callback user surface.

Same protocol as the reference's ``Vertex_Program`` virtuals
(reference: vertex_program.hpp:32-45): initializer / messenger / combiner
(the semiring) / applicator / infinity — except every callback is a
vectorized jnp function over a whole vertex segment, traced into the jitted
superstep, instead of a per-vertex scalar virtual call.

Vertex state is a pytree (dict of arrays); each array is sharded one
segment per device. Callbacks receive local (L,)-shaped leaves inside
``shard_map`` and must be shape-polymorphic (plain jnp ops are).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from graphtap.kernels.semiring import Semiring

State = Dict[str, jnp.ndarray]


class VertexProgram:
    """Subclass and override. See apps/ for the reference programs."""

    #: the (⊕, ⊗, id) triple — replaces the combiner overloads
    semiring: Semiring
    #: dtype of messages / accumulators
    value_dtype: Any = jnp.float32
    #: engine mode flags (reference: vertex_program.hpp:27-29)
    stationary: bool = True
    gather_depends_on_apply: bool = False
    apply_depends_on_iter: bool = False

    # -- lifecycle --------------------------------------------------------
    def init(self, vids: np.ndarray, i_mask: np.ndarray,
             other: Optional[State]) -> Tuple[State, np.ndarray]:
        """Build the initial state and changed bitmap, host-side.

        ``vids``: (D, L) global vertex id per slot; ``i_mask``: (D, L)
        in-edge mask of the owner segment (the reference applies the
        initializer only where the I bit is set, vertex_program.hpp:476-483);
        ``other``: a predecessor program's final state for pipelines like
        Deg→PR (pr.cpp:48). Returns (state, changed0).
        """
        raise NotImplementedError

    def messenger(self, state: State) -> jnp.ndarray:
        """Vertex → outgoing message value (traced)."""
        raise NotImplementedError

    def applicator(self, state: State, y: jnp.ndarray,
                   iteration: jnp.ndarray) -> Tuple[State, jnp.ndarray]:
        """(state, accumulator, iteration) → (new state, changed mask) (traced)."""
        raise NotImplementedError

    def infinity(self):
        """The unreached-state sentinel used by the checksum oracle
        (reference default 0, vertex_program.hpp:40)."""
        return 0

    # -- oracle helpers ---------------------------------------------------
    def get_state(self, state: State) -> jnp.ndarray:
        """Scalar summary per vertex (reference: State::get_state)."""
        raise NotImplementedError

    def format_state(self, state_row: Dict[str, Any]) -> str:
        """Pretty-print one vertex (reference: State::print_state)."""
        return ",".join(f"{k}={v}" for k, v in state_row.items())
