"""Mesh-aligned 2D partition of the adjacency matrix and vertex vectors.

This module replaces the reference's tiling + diagonal leader election
(reference: src/mat/tiling.hpp, src/mat/matrix.hpp:273-495) with a layout
designed around device-mesh collectives. The guiding constraint of the
reference's design — "every rank must own the authoritative copy of exactly
one x segment and one y segment, positioned so that the column-group
broadcast and the row-group reduction deliver segments to their owners" —
is solved there by reordering tile rows until every rank sits on the
diagonal (matrix.hpp:327-341). On a device mesh the same alignment is obtained
for free by choosing the segment-to-device map below; no reordering, no
leader ranks, no per-group communicators.

Layout
------
Let the mesh be ``('rows','cols')`` with shape (R, C), D = R*C devices.
The (padded) vertex space [0, n_pad) is cut into D segments of length
L = n_pad / D; ``seg(v) = v // L``.

* Device (i, j) **owns** vertex segment ``s = j*R + i`` (column-major flat
  index). Vertex state V, the changed bitmap C, and the authoritative y
  segment all live there.

* Device (i, j)'s **tile** holds every edge (r, c) with
  ``seg(c) // R == j`` (its column block) and ``seg(r) % R == i`` (its row
  block).

* **x build**: each device computes messages m for its own segment (length
  L) and all-gathers along the ``rows`` axis. Within mesh column j the
  participants own segments ``j*R + 0 .. j*R + (R-1)``, so the gather
  concatenates, in axis order, exactly the contiguous global column range
  ``[j*R*L, (j+1)*R*L)`` — a dense x block, no reshuffle needed.
  (Replaces bcast_stationary / scatter+gather, vertex_program.hpp:788-862.)

* **y reduce**: the local SpMV accumulates into a row-block vector of
  length C*L laid out as the concatenation ``[seg(k*R+i) for k in 0..C-1]``
  (local row = ``(seg(r)//R)*L + r%L``). A reduce-scatter along the
  ``cols`` axis then sums partials across mesh row i and delivers chunk k
  — segment ``k*R + i`` — precisely to its owner (i, k).
  (Replaces the leader/follower partial-y fold, vertex_program.hpp:1510-1573.)

Per-iteration communication per device is therefore
``(R-1)*L`` (gather) + ``(C-1)*L`` (reduce-scatter) words, the 2D-optimal
n*(R+C-2)/D, over the device interconnect.

Device order: JAX enumerates mesh devices row-major, so the device at mesh
position (i, j) holds shard ``b = i*C + j`` of any array sharded
``P(('rows','cols'))`` along its leading axis. Shard b corresponds to
vertex segment ``s = (b % C) * R + (b // C)``. Helpers below convert
between "shard order" (device-stacked arrays) and "vertex order".
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh, PartitionSpec as P

ROWS = "rows"
COLS = "cols"


def integer_factorize(n: int) -> tuple[int, int]:
    """Near-square factorization n = a*b, a <= b (reference: tiling.hpp:65-73)."""
    a = b = int(math.isqrt(n))
    while a * b != n:
        b += 1
        a = n // b
    assert a * b == n
    return a, b


def make_mesh(devices: Optional[Sequence] = None,
              shape: Optional[tuple[int, int]] = None) -> Mesh:
    """Build the ('rows','cols') mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    d = len(devices)
    if shape is None:
        shape = integer_factorize(d)
    r, c = shape
    if r * c != d:
        raise ValueError(f"mesh shape {shape} != {d} devices")
    dev_arr = np.asarray(devices).reshape(r, c)
    return Mesh(dev_arr, (ROWS, COLS))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class Partition:
    """Static description of the vertex/tile partition for one mesh shape."""

    nv: int        # logical vertex count (num_vertices + 1, for vertex id 0)
    R: int         # mesh rows
    C: int         # mesh cols
    L: int         # segment length (padded)

    @classmethod
    def build(cls, nv: int, R: int, C: int, segment_align: int = 1024) -> "Partition":
        D = R * C
        L = _round_up(max(1, -(-nv // D)), segment_align)
        return cls(nv=nv, R=R, C=C, L=L)

    # -- sizes ------------------------------------------------------------
    @property
    def D(self) -> int:
        return self.R * self.C

    @property
    def n_pad(self) -> int:
        return self.D * self.L

    @property
    def tile_rows(self) -> int:
        """Local row-block length per device (C segments)."""
        return self.C * self.L

    @property
    def tile_cols(self) -> int:
        """Local column-block length per device (R segments)."""
        return self.R * self.L

    # -- shard <-> segment maps ------------------------------------------
    def seg_of_shard(self, b: int) -> int:
        """Vertex segment owned by mesh shard b (row-major device order)."""
        i, j = divmod(b, self.C)
        return j * self.R + i

    def shard_of_seg(self, s: int) -> int:
        j, i = divmod(s, self.R)
        return i * self.C + j

    def shard_perm(self) -> np.ndarray:
        """perm[b] = segment owned by shard b."""
        return np.array([self.seg_of_shard(b) for b in range(self.D)], dtype=np.int64)

    # -- edge -> device assignment (host-side, vectorized) ----------------
    def edge_device(self, r: np.ndarray, c: np.ndarray) -> np.ndarray:
        """Mesh shard index b = i*C + j for each edge (r, c)."""
        i = (r // self.L) % self.R
        j = (c // self.L) // self.R
        return i * self.C + j

    def local_row(self, r: np.ndarray) -> np.ndarray:
        """Row index within the owning device's row-block (length C*L)."""
        return ((r // self.L) // self.R) * self.L + (r % self.L)

    def local_col(self, c: np.ndarray) -> np.ndarray:
        """Col index within the owning device's gathered x block (length R*L)."""
        seg = c // self.L
        j = seg // self.R
        return c - j * self.R * self.L

    def global_row(self, i: int, lr: np.ndarray) -> np.ndarray:
        """Inverse of local_row for mesh row i."""
        k = lr // self.L
        return (k * self.R + i) * self.L + (lr % self.L)

    def global_col(self, j: int, lc: np.ndarray) -> np.ndarray:
        return j * self.R * self.L + lc

    # -- vector layout conversions (host-side) ----------------------------
    def to_vertex_order(self, arr_shards: np.ndarray) -> np.ndarray:
        """(D, L, ...) shard-order array -> (n_pad, ...) in vertex-id order."""
        out = np.empty((self.n_pad,) + arr_shards.shape[2:], dtype=arr_shards.dtype)
        for b in range(self.D):
            s = self.seg_of_shard(b)
            out[s * self.L:(s + 1) * self.L] = arr_shards[b]
        return out

    def from_vertex_order(self, vec: np.ndarray) -> np.ndarray:
        """(n_pad, ...) vertex-order array -> (D, L, ...) shard-order."""
        out = np.empty((self.D, self.L) + vec.shape[1:], dtype=vec.dtype)
        for b in range(self.D):
            s = self.seg_of_shard(b)
            out[b] = vec[s * self.L:(s + 1) * self.L]
        return out

    def owner_vids(self) -> np.ndarray:
        """(D, L) global vertex id held at each shard-local slot."""
        vids = np.empty((self.D, self.L), dtype=np.int32)
        for b in range(self.D):
            s = self.seg_of_shard(b)
            vids[b] = np.arange(s * self.L, (s + 1) * self.L, dtype=np.int32)
        return vids


# Common PartitionSpecs for device-stacked arrays: leading axis is the flat
# device axis (one block per device), remaining axes unsharded.
SPEC_DEVICE_STACKED = P((ROWS, COLS))


def device_stacked_spec(extra_dims: int) -> P:
    return P((ROWS, COLS), *([None] * extra_dims))
