"""Tile construction: filtering, renumbering, compression.

Re-creates the behavior of the reference's format-build pipeline —
``Matrix::init_filtering`` (matrix.hpp:813-858), ``filter_vertices``
(matrix.hpp:861-1122), ``classify_vertices`` (matrix.hpp:1125-1282) and the
``*_BASE::populate`` builders (compressed_column.hpp) — as one vectorized
host-side pass that emits padded, fixed-shape device arrays. Padding to
static shapes is the key XLA-ism the C++ never needed: every device must
run the same jitted superstep, so edge arrays are padded to the max across
devices and masked.

Format notes (reference: compressed_column.hpp):
  * CSC  — row ids are raw local rows; y is dense over the row block.
  * DCSC — reference shape (compressed_column.hpp:156-271): column ids
           renumbered into the compact nnz-col space and a JC table
           mapping compact id -> dense local col, so the kernel gathers
           x through JC (dcsc_spmv.hpp:216-230). Kernel-lab format; see
           config.py for why TCSC is the distributed default.
  * TCSC — the paper's format: row ids renumbered to dense nnz-row indices
           shared across the whole mesh row ("row group"), so the segment
           reduction targets a compact [0, nnzrows) space and the
           accumulator scatter (IR) is a dense map
           (reference: TCSC_BASE::populate, compressed_column.hpp:370-417).
  * TCSC_CF — TCSC plus regular/source/sink classification; the
           vertex-class masks are computed here, the three-phase execution
           plans are engine-side (engine/executor.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graphtap.config import Compression
from graphtap.parallel.layout import Partition, ROWS, COLS


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class TileSet:
    """Device-stacked, padded tile arrays for one (matrix, mesh) pair.

    All arrays have a leading device axis of size D = R*C (row-major mesh
    order); under ``shard_map`` each device sees its slice of size 1.
    """

    part: Partition
    compression: Compression
    has_weight: bool
    Ep: int                      # padded edges per device
    NR: int                      # padded segment-space size for the y reduction
    nnz_total: int               # total (deduped) edge count across devices

    rows: np.ndarray             # (D, Ep) int32, ⊕-segment ids, sorted ascending
    cols: np.ndarray             # (D, Ep) int32, local col in [0, R*L) for x gather
    weights: Optional[np.ndarray]  # (D, Ep) or None
    nnz: np.ndarray              # (D, 1) int32 valid-edge counts
    ja: np.ndarray               # (D, NR+1) int32 row pointer over valid edges
    ir: Optional[np.ndarray]     # (D, NR) int32 renumbered->dense local row (pad=C*L)
    iv_dense: Optional[np.ndarray]  # (D, C*L) int32 dense row -> renumbered id, -1 if none
    nnzrows: np.ndarray          # (D, 1) int32 nnz rows of the device's row group
    i_own: np.ndarray            # (D, L) bool — in-edge mask of the owner segment
    j_own: np.ndarray            # (D, L) bool — out-edge mask of the owner segment
    # vertex classes over the owner segment (for TCSC_CF / stats):
    regular_own: np.ndarray      # (D, L) bool — i_own & j_own
    source_own: np.ndarray       # (D, L) bool — i_own & ~j_own (rows w/o cols)
    sink_own: np.ndarray         # (D, L) bool — j_own & ~i_own (cols w/o rows)
    nnzcols: np.ndarray          # (D, 1) int32 nnz cols of the device's col group
    # DCSC only: compact col id -> dense local col (reference JC,
    # compressed_column.hpp:163); cols then hold compact ids and the
    # kernel gathers x through this table (dcsc_spmv.hpp:216-230)
    jc: Optional[np.ndarray] = None   # (D, NCp) int32 or None

    def device_arrays(self, mesh: Mesh):
        """Place the stacked arrays on the mesh (leading axis device-sharded).
        Multi-process: every host contributes its addressable devices' rows
        (parallel/multihost.py::put_device_stacked)."""
        from graphtap.parallel.multihost import put_device_stacked

        def put(a):
            if a is None:
                return None
            return put_device_stacked(a, mesh)
        return {
            "rows": put(self.rows),
            "cols": put(self.cols),
            "weights": put(self.weights),
            "nnz": put(self.nnz),
            "ja": put(self.ja),
            "ir": put(self.ir),
            "iv_dense": put(self.iv_dense),
            "nnzrows": put(self.nnzrows),
            "i_own": put(self.i_own),
            "j_own": put(self.j_own),
            "regular_own": put(self.regular_own),
            "source_own": put(self.source_own),
            "sink_own": put(self.sink_own),
            "jc": put(self.jc),
        }

    def edge_balance(self) -> dict:
        """Imbalance report (analog of Matrix::balance, matrix.hpp:563-687)."""
        counts = self.nnz[:, 0].astype(np.float64)
        mean = counts.mean() if counts.size else 0.0
        return {
            "per_device": counts.astype(np.int64).tolist(),
            "mean": float(mean),
            "max": float(counts.max() if counts.size else 0),
            "imbalance": float((counts.max() / mean - 1.0) if mean > 0 else 0.0),
        }

    def balance_report(self, threshold: float = 0.2) -> str:
        """Master-style one-line balance report printed at load (the
        reference prints per-rank/rowgroup/colgroup imbalance with skip
        threshold 0.2, matrix.hpp:617-685 — report only, like there)."""
        b = self.edge_balance()
        line = (f"Edge balance: edges={self.nnz_total} "
                f"mean/dev={b['mean']:.0f} max/dev={b['max']:.0f} "
                f"imbalance={b['imbalance']:.3f}")
        if b["imbalance"] > threshold:
            line += f" (exceeds threshold {threshold})"
        return line


def classify_vertices(r: np.ndarray, c: np.ndarray, n_pad: int):
    """Vertex classes over the stored matrix (reference:
    classify_vertices, matrix.hpp:1125-1282): regular = row∧col present,
    source rows = rows without cols, sink cols = cols without rows.

    Multi-process: each host holds only its post-``exchange_edges`` share
    of the edge list, so the presence bitvectors are OR-combined across
    processes — the same leader OR the reference does for its filter
    bitvectors (matrix.hpp:990-1006). No-op single-process."""
    from graphtap.parallel import multihost as mh
    has_row = np.zeros(n_pad, dtype=bool)
    has_col = np.zeros(n_pad, dtype=bool)
    has_row[np.asarray(r, np.int64)] = True
    has_col[np.asarray(c, np.int64)] = True
    has_row = mh.global_or(has_row)
    has_col = mh.global_or(has_col)
    return {
        "regular": has_row & has_col,
        "source_row": has_row & ~has_col,
        "sink_col": has_col & ~has_row,
    }


def build_cf_tilesets(
    r: np.ndarray, c: np.ndarray, w: Optional[np.ndarray],
    part: Partition, parallel_edges: bool = True,
    edge_align: int = 1024, weight_dtype=np.int32,
):
    """TCSC_CF: three edge-subset tilesets for the first / middle / last
    iteration phases (reference: the five JA/JC pointer sets of
    TCSC_CF_BASE, compressed_column.hpp:606-1120, executed per phase in
    spmv_stationary, vertex_program.hpp:1243-1320):

      first  — regular-row edges, all columns (REG_R_NNZ_C)
      middle — regular rows × regular columns (REG_R_REG_C)
      last   — everything except regular-row × sink-col (REG_R_REG_C +
               SRC_R_REG_C + SRC_R_SNK_C)

    Sink columns' messages are zero under the I-masked degree handoff
    (pr.h / vertex_program.hpp:476-483), which is what makes dropping
    REG_R_SNK_C after iteration 0 sound.
    """
    r = np.asarray(r, np.int64)
    c = np.asarray(c, np.int64)
    cls = classify_vertices(r, c, part.n_pad)
    row_is_source = cls["source_row"][r]
    col_is_sink = cls["sink_col"][c]

    def subset(mask):
        wm = w[mask] if w is not None else None
        return build_tileset(r[mask], c[mask], wm, part,
                             compression=Compression.TCSC_CF,
                             parallel_edges=parallel_edges,
                             edge_align=edge_align,
                             weight_dtype=weight_dtype)

    full = build_tileset(r, c, w, part, compression=Compression.TCSC_CF,
                         parallel_edges=parallel_edges,
                         edge_align=edge_align, weight_dtype=weight_dtype)
    return {
        "full": full,
        "first": subset(~row_is_source),
        "middle": subset(~row_is_source & ~col_is_sink),
        "last": subset(~(~row_is_source & col_is_sink)),
    }


def build_tileset(
    r: np.ndarray,
    c: np.ndarray,
    w: Optional[np.ndarray],
    part: Partition,
    compression: Compression = Compression.TCSC,
    parallel_edges: bool = True,
    edge_align: int = 1024,
    weight_dtype=np.int32,
) -> TileSet:
    """Build the tiled, compressed representation from a host edge list.

    ``r``/``c`` are global (already transformed) row/col ids; ``w`` optional
    weights. Mirrors ingest → shuffle → filter → compress
    (reference call stack: graph.hpp:163-169) minus the MPI shuffle, which
    on a single ingest host is just the binning below. Dedup of parallel
    edges keeps the minimum weight (deterministic; the reference's
    std::unique after ColSort keeps an order-dependent survivor,
    matrix.hpp:546-557).
    """
    R, C, L, D = part.R, part.C, part.L, part.D
    r = np.asarray(r, dtype=np.int64)
    c = np.asarray(c, dtype=np.int64)
    if r.size and (r.max() >= part.n_pad or c.max() >= part.n_pad):
        raise ValueError("vertex id exceeds padded space")

    dev = part.edge_device(r, c)
    lr = part.local_row(r)
    lc = part.local_col(c)
    i_e = dev // C  # mesh row of each edge
    j_e = dev % C   # mesh col of each edge

    # --- filtering: global nnz-row mask per row group, nnz-col per col group
    # (reference: filter_vertices over _ROWS_ then _COLS_, matrix.hpp:861-1122;
    # the Isend/OR/bcast choreography collapses into these two scatters).
    rows_mask = np.zeros((R, C * L), dtype=bool)
    rows_mask[i_e, lr] = True
    cols_mask = np.zeros((C, R * L), dtype=bool)
    cols_mask[j_e, lc] = True
    # multi-process: each host sees only its devices' edges (post
    # exchange_edges); OR the partial bitvectors like the reference's
    # leader combine (matrix.hpp:990-1006). No-ops single-process.
    from graphtap.parallel import multihost as mh
    rows_mask = mh.global_or(rows_mask)
    cols_mask = mh.global_or(cols_mask)

    # prefix renumbering IV (reference: matrix.hpp:1044-1097)
    iv = np.cumsum(rows_mask, axis=1, dtype=np.int64) - 1  # valid where mask
    nnzrows_grp = rows_mask.sum(axis=1).astype(np.int64)   # per mesh row
    nnzcols_grp = cols_mask.sum(axis=1).astype(np.int64)   # per mesh col

    renumber = compression in (Compression.TCSC, Compression.TCSC_CF)
    # DCSC: columns renumbered to compact nnz-col ids; JV is the col-side
    # prefix renumbering (reference: DCSC_BASE::populate indexing via
    # nnzcols_indices, compressed_column.hpp:237-271)
    renumber_cols = compression == Compression.DCSC
    jv = np.cumsum(cols_mask, axis=1, dtype=np.int64) - 1 \
        if renumber_cols else None

    # --- per-device binning (native counting sort when available;
    # replaces the MPI all-to-all shuffle, matrix.hpp:692-810)
    from graphtap import native
    if r.size and r.max() < (1 << 32) and c.max() < (1 << 32):
        order, counts = native.bin_edges(r, c, part.L, R, C)
    else:
        order = np.argsort(dev, kind="stable")
        counts = np.bincount(dev, minlength=D)
    dev_s, lr_s, lc_s = dev[order], lr[order], lc[order]
    w_s = w[order] if w is not None else None
    ends = np.cumsum(counts)
    starts = ends - counts

    per_rows, per_cols, per_w, per_nnz = [], [], [], []
    for b in range(D):
        s, e = starts[b], ends[b]
        blr, blc = lr_s[s:e], lc_s[s:e]
        bw = w_s[s:e] if w_s is not None else None
        o = np.lexsort((blc, blr))  # sort by destination row, then col
        blr, blc = blr[o], blc[o]
        bw = bw[o] if bw is not None else None
        if not parallel_edges and blr.size:
            # dedup on (row, col); keep min weight for determinism
            key = blr * np.int64(R * L) + blc
            if bw is not None:
                o2 = np.lexsort((bw, key))
                key2, blr, blc, bw = key[o2], blr[o2], blc[o2], bw[o2]
                keep = np.concatenate(([True], key2[1:] != key2[:-1]))
                blr, blc, bw = blr[keep], blc[keep], bw[keep]
                o3 = np.lexsort((blc, blr))
                blr, blc, bw = blr[o3], blc[o3], bw[o3]
            else:
                keep = np.concatenate(([True], key[1:] != key[:-1]))
                blr, blc = blr[keep], blc[keep]
        per_rows.append(blr)
        per_cols.append(blc)
        per_w.append(bw)
        per_nnz.append(blr.size)

    # per-device counts are exact on the owning host and zero elsewhere,
    # so the global count vector is the element-wise max / sum across
    # processes (reference invariant: matrix.hpp:802-804)
    per_nnz_g = mh.global_max(np.asarray(per_nnz, np.int64))
    nnz_total = int(mh.global_sum(np.asarray(per_nnz, np.int64)).sum())
    Ep = _round_up(int(max(int(per_nnz_g.max()) if per_nnz_g.size else 0, 1)),
                   edge_align)

    if renumber:
        NR = _round_up(int(max(nnzrows_grp.max(), 1)), 128)
    else:
        NR = C * L

    rows_arr = np.zeros((D, Ep), dtype=np.int32)
    cols_arr = np.zeros((D, Ep), dtype=np.int32)
    w_arr = np.zeros((D, Ep), dtype=weight_dtype) if w is not None else None
    nnz_arr = np.zeros((D, 1), dtype=np.int32)
    ja_arr = np.zeros((D, NR + 1), dtype=np.int32)
    ir_arr = np.full((D, NR), C * L, dtype=np.int32) if renumber else None
    iv_arr = np.full((D, C * L), -1, dtype=np.int32) if renumber else None
    nnzrows_arr = np.zeros((D, 1), dtype=np.int32)
    nnzcols_arr = np.zeros((D, 1), dtype=np.int32)
    jc_arr = None
    if renumber_cols:
        NCp = _round_up(int(max(nnzcols_grp.max(), 1)), 128)
        jc_arr = np.zeros((D, NCp), dtype=np.int32)

    for b in range(D):
        i, j = divmod(b, C)
        n = per_nnz[b]
        blr, blc, bw = per_rows[b], per_cols[b], per_w[b]
        if renumber:
            seg_ids = iv[i, blr]  # dense nnz-row ids; sorted since blr sorted
        else:
            seg_ids = blr
        rows_arr[b, :n] = seg_ids
        if n < Ep:  # pad with last valid id to keep sortedness
            rows_arr[b, n:] = seg_ids[-1] if n else 0
        if renumber_cols:
            cols_arr[b, :n] = jv[j, blc]
            nzc = np.flatnonzero(cols_mask[j])
            jc_arr[b, :nzc.size] = nzc
        else:
            cols_arr[b, :n] = blc
        if w_arr is not None and bw is not None:
            w_arr[b, :n] = bw
        nnz_arr[b, 0] = n
        nnzrows_arr[b, 0] = nnzrows_grp[i]
        nnzcols_arr[b, 0] = nnzcols_grp[j]
        ja_arr[b] = np.searchsorted(rows_arr[b, :n], np.arange(NR + 1))
        if renumber:
            nz = np.flatnonzero(rows_mask[i])
            ir_arr[b, :nz.size] = nz
            iv_arr[b] = np.where(rows_mask[i], iv[i], -1)

    # --- owner-segment masks. Device (i, j) owns segment s = j*R + i, which
    # sits at chunk j of row block i and at chunk i of col block j.
    i_own = np.zeros((D, L), dtype=bool)
    j_own = np.zeros((D, L), dtype=bool)
    for b in range(D):
        i, j = divmod(b, C)
        i_own[b] = rows_mask[i, j * L:(j + 1) * L]
        j_own[b] = cols_mask[j, i * L:(i + 1) * L]

    regular_own = i_own & j_own
    source_own = i_own & ~j_own   # rows without cols (reference: matrix.hpp:1125)
    sink_own = j_own & ~i_own     # cols without rows

    return TileSet(
        part=part, compression=compression, has_weight=w is not None,
        Ep=Ep, NR=NR, nnz_total=nnz_total,
        rows=rows_arr, cols=cols_arr, weights=w_arr, nnz=nnz_arr,
        ja=ja_arr, ir=ir_arr, iv_dense=iv_arr,
        nnzrows=nnzrows_arr, i_own=i_own, j_own=j_own,
        regular_own=regular_own, source_own=source_own, sink_own=sink_own,
        nnzcols=nnzcols_arr, jc=jc_arr,
    )
