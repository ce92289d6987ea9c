"""Multi-host path: byte-range ingest, edge routing, distributed tile
build consistency, and the global-array assembly.

A single pytest process cannot run jax.distributed with P>1, so these
tests exercise the same code paths the multi-process run takes, with the
process structure simulated: per-process byte-range reads are unioned,
per-process edge selections are checked to partition the edge set, and
per-"process" tile builds (each given only its devices' edges, plus the
globally-OR'd filter masks the real path exchanges) are asserted
bit-identical to the single-host build — the determinism the reference
gets from its all-to-all + leader-OR choreography
(matrix.hpp:692-810, :861-1122).
"""

import numpy as np
import pytest

import jax

from graphtap import Graph, GraphConfig, Compression, make_mesh
from graphtap.config import Ordering
from graphtap.format import tiles as tiles_mod
from graphtap.format.tiles import build_tileset
from graphtap.parallel import multihost as mh
from graphtap.parallel.layout import Partition
from graphtap.ingest.io import read_edge_list


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("pcnt", [2, 3, 5])
def test_byte_range_reads_partition_the_file(rmat10_files, weighted, pcnt):
    path = rmat10_files["weighted" if weighted else "plain"]
    full_r, full_c, full_w = read_edge_list(path, has_weight=weighted)
    parts = [read_edge_list(path, has_weight=weighted,
                            process_index=p, process_count=pcnt)
             for p in range(pcnt)]
    r = np.concatenate([p[0] for p in parts])
    c = np.concatenate([p[1] for p in parts])
    np.testing.assert_array_equal(r, full_r)
    np.testing.assert_array_equal(c, full_c)
    if weighted:
        np.testing.assert_array_equal(
            np.concatenate([p[2] for p in parts]), full_w)


def test_host_edge_share_partitions_edges():
    mesh = make_mesh(jax.devices()[:8], shape=(2, 4))
    part = Partition.build(1025, 2, 4, segment_align=128)
    rng = np.random.default_rng(0)
    r = rng.integers(0, 1025, size=5000)
    c = rng.integers(0, 1025, size=5000)
    # fake 2-process placement: devices 0-3 on proc 0, 4-7 on proc 1
    proc_map = np.array([0, 0, 0, 0, 1, 1, 1, 1])
    m0 = mh.host_edge_share(r, c, part, mesh, process_index=0,
                            proc_map=proc_map)
    m1 = mh.host_edge_share(r, c, part, mesh, process_index=1,
                            proc_map=proc_map)
    assert (m0 ^ m1).all()                      # exact partition
    dev = part.edge_device(r, c)
    assert (proc_map[dev[m0]] == 0).all()
    assert (proc_map[dev[m1]] == 1).all()


@pytest.mark.parametrize("comp", [Compression.TCSC, Compression.CSC])
def test_distributed_tileset_matches_global(comp, monkeypatch, rmat10_path):
    """Each simulated process builds tiles from only its devices' edges;
    with the mask/count reductions faked to return the true globals, its
    local devices' rows must equal the single-host build's."""
    mesh = make_mesh(jax.devices()[:8], shape=(2, 4))
    part = Partition.build(1025, 2, 4, segment_align=128)
    raw = np.fromfile(rmat10_path, dtype=np.uint32).reshape(-1, 2)
    r, c = raw[:, 0].astype(np.int64), raw[:, 1].astype(np.int64)

    ref = build_tileset(r, c, None, part, compression=comp, edge_align=256)

    proc_map = np.array([0, 0, 0, 0, 1, 1, 1, 1])
    # the real path ORs/maxes partial masks across processes
    # (tiles.py uses mh.global_or / global_max / global_sum, which are
    # identity at P=1); emulate P=2 by injecting the combining functions
    shares = [mh.host_edge_share(r, c, part, mesh, process_index=p,
                                 proc_map=proc_map) for p in (0, 1)]
    partials = {}
    for p in (0, 1):
        rp, cp = r[shares[p]], c[shares[p]]
        dev = part.edge_device(rp, cp)
        rm = np.zeros((2, part.tile_rows), dtype=bool)
        rm[(dev // 4), part.local_row(rp)] = True
        cm = np.zeros((4, part.tile_cols), dtype=bool)
        cm[(dev % 4), part.local_col(cp)] = True
        partials[p] = (rm, cm)
    true_rows = partials[0][0] | partials[1][0]
    true_cols = partials[0][1] | partials[1][1]

    for p in (0, 1):
        monkeypatch.setattr(mh, "global_or",
                            lambda m, tr=true_rows, tc=true_cols:
                            tr if m.shape == tr.shape else tc)
        monkeypatch.setattr(mh, "global_max",
                            lambda x: np.maximum(np.asarray(x),
                                                 _counts(ref)))
        monkeypatch.setattr(mh, "global_sum",
                            lambda x: _counts(ref))
        rp, cp = r[shares[p]], c[shares[p]]
        local = build_tileset(rp, cp, None, part, compression=comp,
                              edge_align=256)
        assert local.Ep == ref.Ep and local.NR == ref.NR
        assert local.nnz_total == ref.nnz_total
        for b in range(8):
            if proc_map[b] != p:
                continue
            np.testing.assert_array_equal(local.rows[b], ref.rows[b])
            np.testing.assert_array_equal(local.cols[b], ref.cols[b])
            np.testing.assert_array_equal(local.nnz[b], ref.nnz[b])
            np.testing.assert_array_equal(local.ja[b], ref.ja[b])
            np.testing.assert_array_equal(local.i_own[b], ref.i_own[b])
            if comp == Compression.TCSC:
                np.testing.assert_array_equal(local.ir[b], ref.ir[b])
                np.testing.assert_array_equal(local.iv_dense[b],
                                              ref.iv_dense[b])


def _counts(ref):
    return ref.nnz[:, 0].astype(np.int64)


def test_exchange_edges_single_process_identity():
    mesh = make_mesh(jax.devices()[:8], shape=(2, 4))
    part = Partition.build(1025, 2, 4, segment_align=128)
    r = np.array([1, 2, 3]); c = np.array([4, 5, 6])
    r2, c2, w2 = mh.exchange_edges(r, c, None, part, mesh)
    np.testing.assert_array_equal(r, r2)
    assert w2 is None


def test_put_device_stacked_matches_device_put():
    mesh = make_mesh(jax.devices()[:8], shape=(2, 4))
    a = np.arange(8 * 16, dtype=np.int32).reshape(8, 16)
    arr = mh.put_device_stacked(a, mesh)
    np.testing.assert_array_equal(np.asarray(arr), a)
    assert len(arr.sharding.device_set) == 8


def test_allgather_state_identity():
    x = jax.numpy.arange(32.0)
    np.testing.assert_array_equal(mh.allgather_state(x), np.arange(32.0))
