"""Semiring SpMV/SpMSpV kernels over one device tile.

The hot loop of the reference —
``for j in cols: for i in JA[j]..JA[j+1]: y[IA[i]] ⊕= x[j] ⊗ A[i]``
(reference: spmv_stationary, vertex_program.hpp:1116-1327) — is a serial
scatter in C++. Here it becomes: gather x per edge, ⊗ with the weight,
mask padding lanes to the ⊕-identity, then a segment-⊕ over destination
rows. The TCSC renumbering (dense nnz-row ids shared across the row group)
is kept precisely because it makes the segment space compact
(reference: TCSC_BASE populate, compressed_column.hpp:370-417).

Two interchangeable engine kernels plus a ground truth, cross-validated in
tests (the engine picks between the two, engine/executor.py):
  * ``spmv_segment``        — jax.ops.segment_{sum,min,max} over the sorted
                              destination rows (an XLA scatter-reduce).
  * ``spmv_sorted_scan``    — segmented associative scan + a gather at the
                              row ends; no scatter anywhere.
  * ``spmv_dense_reference``— one-hot expansion ground truth for tiny tiles.

All take static shapes; per-device nnz arrives as a traced scalar and
padding lanes are masked.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from graphtap.kernels.semiring import Semiring


def edge_contributions(
    x: jnp.ndarray,            # (ncols_local,) gathered message block
    cols: jnp.ndarray,         # (Ep,) int32 local col per edge
    weights: Optional[jnp.ndarray],  # (Ep,) or None
    nnz: jnp.ndarray,          # scalar int32 valid-edge count
    semiring: Semiring,
) -> jnp.ndarray:
    """Per-edge x[col] ⊗ w with padding masked to the ⊕-identity."""
    xv = jnp.take(x, cols, axis=0)
    contrib = semiring.mul(xv, weights)
    valid = jax.lax.broadcasted_iota(jnp.int32, (cols.shape[0], 1), 0)[:, 0] < nnz
    return jnp.where(valid, contrib, semiring.identity_like(contrib.dtype))


def spmv_segment(
    x: jnp.ndarray,
    rows: jnp.ndarray,          # (Ep,) segment ids, sorted ascending
    cols: jnp.ndarray,
    weights: Optional[jnp.ndarray],
    nnz: jnp.ndarray,
    num_segments: int,
    semiring: Semiring,
) -> jnp.ndarray:
    """Segment-reduce SpMV: returns y over [0, num_segments)."""
    contrib = edge_contributions(x, cols, weights, nnz, semiring)
    return semiring.segment_reduce(contrib, rows, num_segments,
                                   indices_are_sorted=True)


def scatter_to_dense(
    y_compact: jnp.ndarray,     # (NR,) values in renumbered row space
    ir: jnp.ndarray,            # (NR,) renumbered -> dense local row, pad = out-of-bounds
    dense_len: int,
    semiring: Semiring,
) -> jnp.ndarray:
    """Expand a renumbered accumulator to the dense row block.

    Padding entries of ``ir`` point one past the end and are dropped
    (mode='drop'), mirroring the reference's IR scatter on update
    (tcsc_spmspv2.hpp:531-536)."""
    y = jnp.full((dense_len,), semiring.identity_like(y_compact.dtype),
                 dtype=y_compact.dtype)
    return y.at[ir].set(y_compact, mode="drop")


def spmv_sorted_scan(
    x: jnp.ndarray,
    rows: jnp.ndarray,          # (Ep,) segment ids, sorted ascending
    cols: jnp.ndarray,
    weights: Optional[jnp.ndarray],
    nnz: jnp.ndarray,
    ja: jnp.ndarray,            # (NR+1,) CSR-style row pointer over valid edges
    semiring: Semiring,
) -> jnp.ndarray:
    """Scatter-free segment reduce for sorted edges.

    Since the TCSC build sorts edges by destination row, the ⊕-fold can
    be a *segmented scan* followed by a gather at the segment ends (the
    row-pointer array ``ja`` — the same JA the reference's TCSC carries,
    compressed_column.hpp:284). All memory ops are gathers; no scatter
    appears anywhere in the superstep.

    Sum semirings additionally avoid the log-depth segmented scan: a plain
    cumsum + pointer-difference would be cheapest, but a single running
    f32 sum over tens of millions of edges loses ~eps·Σ per row (the
    reference accumulates in f64, deg.h:19). The segmented scan resets at
    each row boundary, so error stays at eps·(row sum) — same as the
    serial loop.
    """
    contrib = edge_contributions(x, cols, weights, nnz, semiring)
    flags = jnp.concatenate([
        jnp.ones((1,), dtype=bool), rows[1:] != rows[:-1]])

    def combine(a, b):
        (va, fa), (vb, fb) = a, b
        v = jnp.where(fb, vb, semiring.add(va, vb))
        return v, fa | fb

    scanned, _ = jax.lax.associative_scan(combine, (contrib, flags))
    # y[k] = scanned[ja[k+1]-1] for non-empty rows, identity otherwise
    ends = ja[1:]
    starts = ja[:-1]
    idx = jnp.maximum(ends - 1, 0)
    y = jnp.take(scanned, idx, axis=0)
    return jnp.where(ends > starts, y,
                     semiring.identity_like(contrib.dtype))


def expand_compact(
    y_compact: jnp.ndarray,     # (NR,) values in renumbered row space
    iv_dense: jnp.ndarray,      # (dense_len,) renumbered id per dense row, -1 if none
    semiring: Semiring,
) -> jnp.ndarray:
    """Gather-based inverse of the TCSC renumbering: dense row block from
    the compact accumulator (the scatter-free alternative to
    ``scatter_to_dense``)."""
    mask = iv_dense >= 0
    y = jnp.take(y_compact, jnp.clip(iv_dense, 0, y_compact.shape[0] - 1),
                 axis=0)
    return jnp.where(mask, y, semiring.identity_like(y_compact.dtype))


def spmv_dense_reference(
    x: jnp.ndarray,
    rows: jnp.ndarray,
    cols: jnp.ndarray,
    weights: Optional[jnp.ndarray],
    nnz: jnp.ndarray,
    num_segments: int,
    semiring: Semiring,
) -> jnp.ndarray:
    """Ground-truth SpMV via explicit one-hot expansion (tiny tiles only)."""
    contrib = edge_contributions(x, cols, weights, nnz, semiring)
    onehot = rows[:, None] == jnp.arange(num_segments)[None, :]
    expanded = jnp.where(onehot, contrib[:, None],
                         semiring.identity_like(contrib.dtype))
    return semiring.axis_reduce(expanded, axis=0)
