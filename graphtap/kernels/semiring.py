"""Semirings: the (multiply, add, identity) triple of a vertex program.

The reference expresses the semiring through virtual ``combiner`` overloads
(reference: vertex_program.hpp:36-37; e.g. plus-times in pr.h:35-41,
min-plus in sssp.h:49-56, min in cc.h:43-49). Here a semiring is a frozen
dataclass of jnp-vectorized callables plus the metadata the SpMV kernels
need: which segment-reduction primitive implements the ⊕-fold, and the
⊕-identity used for padding lanes and inactive message slots
(the reference's ``infinity()``, vertex_program.hpp:40).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

INF_I32 = 2147483647  # INT32_MAX sentinel (reference: bfs.h:12, sssp.h:12, cc.h:12)


@dataclass(frozen=True)
class Semiring:
    """A semiring (⊕, ⊗, id⊕) acting on message values.

    ``mul(x, w)`` combines a gathered message x with an edge weight w
    (w is None for unweighted graphs); ``add`` is the elementwise ⊕;
    ``identity`` is the ⊕-identity (used for padding and inactive slots);
    ``reduce_kind`` picks the segment-reduction primitive ('sum'|'min'|'max').
    """

    name: str
    add: Callable[[Any, Any], Any]
    mul: Callable[[Any, Optional[Any]], Any]
    identity: Any
    reduce_kind: str  # 'sum' | 'min' | 'max'

    def identity_like(self, dtype) -> jnp.ndarray:
        return jnp.asarray(self.identity, dtype=dtype)

    def segment_reduce(self, data, segment_ids, num_segments, indices_are_sorted=True):
        if self.reduce_kind == "sum":
            return jax.ops.segment_sum(
                data, segment_ids, num_segments, indices_are_sorted=indices_are_sorted)
        if self.reduce_kind == "min":
            return jax.ops.segment_min(
                data, segment_ids, num_segments, indices_are_sorted=indices_are_sorted)
        if self.reduce_kind == "max":
            return jax.ops.segment_max(
                data, segment_ids, num_segments, indices_are_sorted=indices_are_sorted)
        raise ValueError(self.reduce_kind)

    def axis_reduce(self, data, axis):
        """⊕-fold along an array axis (used for all_to_all reduce-scatter)."""
        if self.reduce_kind == "sum":
            return jnp.sum(data, axis=axis)
        if self.reduce_kind == "min":
            return jnp.min(data, axis=axis)
        if self.reduce_kind == "max":
            return jnp.max(data, axis=axis)
        raise ValueError(self.reduce_kind)


def plus_times() -> Semiring:
    """(+, *, 0): degree and PageRank (reference: pr.h:35-41, deg.h:43-49)."""
    def mul(x, w):
        return x if w is None else x * w
    return Semiring(name="plus_times", add=lambda a, b: a + b, mul=mul,
                    identity=0, reduce_kind="sum")


def min_plus(inf: int = INF_I32) -> Semiring:
    """(min, +w, INF): SSSP (reference: sssp.h:49-56).

    The ⊗ guards the INF sentinel so INF + w does not wrap in int32; valid
    path lengths are assumed << INT32_MAX (true for u32[<=128] weights on
    graphs of < 2^24 vertices, reference: converter.cpp:81 weight range).
    """
    def mul(x, w):
        if w is None:
            return x
        return jnp.where(x >= inf, inf, x + w)
    return Semiring(name="min_plus", add=jnp.minimum, mul=mul,
                    identity=inf, reduce_kind="min")


def min_select(inf: int = INF_I32) -> Semiring:
    """(min, id, INF): CC label propagation and BFS parent-min
    (reference: cc.h:43-49, bfs.h:57-64 — their weighted combiner adds w,
    but both apps run unweighted so ⊗ is identity)."""
    def mul(x, w):
        return x if w is None else jnp.where(x >= inf, inf, x + w)
    return Semiring(name="min_select", add=jnp.minimum, mul=mul,
                    identity=inf, reduce_kind="min")
