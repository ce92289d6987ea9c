"""Ingest tests: binary/text readers, byte-range parallel reads, edge
transforms (graph.hpp:266-292 semantics), RMAT generator."""

import os

import numpy as np
import pytest

from graphtap.ingest.io import (read_edge_list, apply_transforms,
                                write_binary)
from graphtap.ingest.rmat import rmat_edges


def test_read_reference_binary(rmat10_path):
    r, c, w = read_edge_list(rmat10_path)
    assert r.size == 16384 and w is None
    assert r.max() <= 1023 and c.max() <= 1023


def test_read_reference_binary_weighted(rmat10_w_path):
    r, c, w = read_edge_list(rmat10_w_path, has_weight=True)
    assert r.size == 16384 and w is not None
    assert w.min() >= 1 and w.max() <= 128


def test_parallel_read_shards_cover_file(rmat10_path):
    parts = [read_edge_list(rmat10_path, process_index=i, process_count=4)
             for i in range(4)]
    r = np.concatenate([p[0] for p in parts])
    c = np.concatenate([p[1] for p in parts])
    r0, c0, _ = read_edge_list(rmat10_path)
    np.testing.assert_array_equal(r, r0)
    np.testing.assert_array_equal(c, c0)


def test_text_roundtrip(tmp_path):
    path = tmp_path / "g.el"
    rng = np.random.default_rng(3)
    r = rng.integers(0, 50, 200)
    c = rng.integers(0, 50, 200)
    w = rng.integers(1, 10, 200)
    with open(path, "w") as f:
        for a, b, ww in zip(r, c, w):
            f.write(f"{a} {b} {ww}\n")
    rr, cc, www = read_edge_list(str(path), has_weight=True)
    np.testing.assert_array_equal(rr, r)
    np.testing.assert_array_equal(cc, c)
    np.testing.assert_array_equal(www, w)
    # parallel text read covers the file exactly once
    parts = [read_edge_list(str(path), has_weight=True,
                            process_index=i, process_count=3)
             for i in range(3)]
    rcat = np.concatenate([p[0] for p in parts])
    np.testing.assert_array_equal(rcat, r)


def test_binary_roundtrip(tmp_path):
    path = str(tmp_path / "g.bin")
    r = np.array([1, 2, 3]); c = np.array([4, 5, 6]); w = np.array([7, 8, 9])
    write_binary(path, r, c, w)
    rr, cc, ww = read_edge_list(path, has_weight=True)
    np.testing.assert_array_equal(rr, r)
    np.testing.assert_array_equal(ww, w)


def test_transforms():
    r = np.array([1, 2, 2]); c = np.array([1, 3, 5])
    w = np.array([9, 8, 7], dtype=np.int32)
    # self-loop removal
    rr, cc, ww = apply_transforms(r, c, w, self_loops=False)
    assert rr.size == 2 and 1 not in rr
    # transpose
    rr, cc, _ = apply_transforms(r, c, None, transpose=True)
    np.testing.assert_array_equal(rr, c)
    np.testing.assert_array_equal(cc, r)
    # acyclic: row <= col
    rr, cc, _ = apply_transforms(np.array([5, 2]), np.array([3, 4]), None,
                                 acyclic=True)
    assert (rr <= cc).all()
    # undirected mirror doubles and swaps
    rr, cc, ww = apply_transforms(r, c, w, directed=False)
    assert rr.size == 6
    np.testing.assert_array_equal(rr[3:], c)
    np.testing.assert_array_equal(cc[3:], r)
    np.testing.assert_array_equal(ww[3:], w)


def test_rmat_generator():
    r, c, w = rmat_edges(scale=10, edge_factor=16, seed=5, weighted=True)
    assert r.size == 16384
    assert r.max() < 1024 and c.max() < 1024
    assert w.min() >= 1 and w.max() <= 128
    # deterministic
    r2, c2, _ = rmat_edges(scale=10, edge_factor=16, seed=5, weighted=True)
    np.testing.assert_array_equal(r, r2)
    # skewed: top-64 vertices own a disproportionate share of edges
    deg = np.bincount(r, minlength=1024)
    assert np.sort(deg)[-64:].sum() > 0.2 * r.size


def test_text_native_vs_numpy_large(tmp_path):
    """A multi-MB text file parses identically through the native
    gt_parse_text path and the NumPy fallback (reference: parread_text,
    graph.hpp:234-306)."""
    from graphtap import native
    path = tmp_path / "big.el"
    rng = np.random.default_rng(11)
    n = 300_000                               # ~3.5 MB of text
    r = rng.integers(0, 1 << 20, n)
    c = rng.integers(0, 1 << 20, n)
    np.savetxt(path, np.stack([r, c], axis=1), fmt="%d")
    rr, cc, _ = read_edge_list(str(path))
    np.testing.assert_array_equal(rr, r)
    np.testing.assert_array_equal(cc, c)
    if native.available():
        # force the NumPy fallback and compare
        import graphtap.native as nat
        saved = nat._lib
        try:
            nat._lib = None
            nat._tried = True
            r2, c2, _ = read_edge_list(str(path))
        finally:
            nat._lib = saved
        np.testing.assert_array_equal(r2, rr)
        np.testing.assert_array_equal(c2, cc)
