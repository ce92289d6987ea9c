"""Format/partition unit tests: edge-count conservation, renumbering
consistency, and layout round-trips — the analog of the reference's inline
invariants (graph.hpp:299, matrix.hpp:802-804, matrix.hpp:1084-1097,
compressed_column.hpp:407-416)."""

import numpy as np
import pytest

from graphtap.config import Compression
from graphtap.format.tiles import build_tileset
from graphtap.parallel.layout import Partition, integer_factorize


def test_integer_factorize():
    assert integer_factorize(1) == (1, 1)
    assert integer_factorize(8) == (2, 4)
    assert integer_factorize(16) == (4, 4)
    assert integer_factorize(7) == (1, 7)


@pytest.mark.parametrize("R,C", [(1, 1), (2, 2), (2, 4), (4, 2), (1, 8)])
def test_layout_roundtrip(R, C):
    part = Partition.build(nv=5000, R=R, C=C, segment_align=128)
    v = np.arange(part.n_pad)
    shards = part.from_vertex_order(v)
    back = part.to_vertex_order(shards)
    np.testing.assert_array_equal(v, back)
    # owner vids agree with the segment map
    vids = part.owner_vids()
    for b in range(part.D):
        s = part.seg_of_shard(b)
        assert vids[b, 0] == s * part.L
        assert part.shard_of_seg(s) == b


@pytest.mark.parametrize("R,C", [(1, 1), (2, 4)])
def test_edge_localization_roundtrip(R, C):
    part = Partition.build(nv=3000, R=R, C=C, segment_align=128)
    rng = np.random.default_rng(0)
    r = rng.integers(0, part.nv, 5000)
    c = rng.integers(0, part.nv, 5000)
    dev = part.edge_device(r, c)
    lr, lc = part.local_row(r), part.local_col(c)
    i, j = dev // C, dev % C
    np.testing.assert_array_equal(
        r, np.array([part.global_row(ii, np.array([l]))[0]
                     for ii, l in zip(i, lr)]))
    np.testing.assert_array_equal(
        c, np.array([part.global_col(jj, np.array([l]))[0]
                     for jj, l in zip(j, lc)]))


@pytest.mark.parametrize("R,C", [(1, 1), (2, 4)])
@pytest.mark.parametrize("comp", [Compression.CSC, Compression.TCSC])
def test_tileset_invariants(R, C, comp):
    part = Partition.build(nv=2000, R=R, C=C, segment_align=128)
    rng = np.random.default_rng(7)
    E = 9000
    r = rng.integers(0, part.nv, E).astype(np.int64)
    c = rng.integers(0, part.nv, E).astype(np.int64)
    ts = build_tileset(r, c, None, part, compression=comp, edge_align=256)

    # edge-count conservation across the shuffle (graph.hpp:299-300)
    assert ts.nnz_total == E
    assert int(ts.nnz.sum()) == E

    # every row id within bounds; sorted per device
    for b in range(part.D):
        n = int(ts.nnz[b, 0])
        rows = ts.rows[b, :n]
        assert (np.diff(rows) >= 0).all()
        assert rows.max(initial=0) < ts.NR
        cols = ts.cols[b, :n]
        assert cols.max(initial=0) < part.tile_cols

    if comp == Compression.TCSC:
        # renumbering consistency (matrix.hpp:1084-1097): IR maps dense
        # renumbered ids back to local rows monotonically, shared across
        # each mesh row.
        for i in range(R):
            base = ts.ir[i * C]
            for j in range(C):
                np.testing.assert_array_equal(ts.ir[i * C + j], base)
            nr = int(ts.nnzrows[i * C, 0])
            valid = base[:nr]
            assert (np.diff(valid) > 0).all()
            assert valid.max(initial=-1) < part.tile_rows


def test_dedup_keeps_min_weight():
    part = Partition.build(nv=100, R=1, C=1, segment_align=128)
    r = np.array([3, 3, 3, 5], dtype=np.int64)
    c = np.array([4, 4, 4, 6], dtype=np.int64)
    w = np.array([9, 2, 5, 1], dtype=np.int32)
    ts = build_tileset(r, c, w, part, compression=Compression.CSC,
                       parallel_edges=False, edge_align=128)
    assert ts.nnz_total == 2
    n = int(ts.nnz[0, 0])
    assert n == 2
    assert set(ts.weights[0, :n].tolist()) == {2, 1}


def test_owner_masks():
    part = Partition.build(nv=1000, R=2, C=2, segment_align=128)
    # one edge: 0 -> 600
    r = np.array([600], dtype=np.int64)
    c = np.array([0], dtype=np.int64)
    ts = build_tileset(r, c, None, part, compression=Compression.TCSC,
                       edge_align=128)
    i_own = part.to_vertex_order(ts.i_own)
    j_own = part.to_vertex_order(ts.j_own)
    assert i_own[600] and i_own.sum() == 1
    assert j_own[0] and j_own.sum() == 1
    src = part.to_vertex_order(ts.source_own)
    snk = part.to_vertex_order(ts.sink_own)
    assert src[600] and snk[0]
