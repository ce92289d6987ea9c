"""Native host library tests (C++ via ctypes, with NumPy fallback
equivalence)."""

import numpy as np
import pytest

from graphtap import native


def test_native_builds():
    assert native.available(), "native library failed to build"


def test_parse_text():
    data = b"1 2 7\n3 4 9\n 10 20 30 \n"
    arr = native.parse_text(data, 3)
    np.testing.assert_array_equal(arr, [[1, 2, 7], [3, 4, 9], [10, 20, 30]])
    with pytest.raises(ValueError):
        native.parse_text(b"1 2 x", 3)


def test_sort_edges():
    rng = np.random.default_rng(0)
    k1 = rng.integers(0, 50, 1000).astype(np.uint32)
    k2 = rng.integers(0, 50, 1000).astype(np.uint32)
    perm = native.sort_edges(k1, k2)
    np.testing.assert_array_equal(perm, np.lexsort((k2, k1)))


def test_dedup_edges():
    r = np.array([1, 1, 1, 2, 2], dtype=np.uint32)
    c = np.array([3, 3, 4, 5, 5], dtype=np.uint32)
    w = np.array([9, 2, 7, 1, 8], dtype=np.uint32)
    rr, cc, ww = native.dedup_edges(r, c, w)
    np.testing.assert_array_equal(rr, [1, 1, 2])
    np.testing.assert_array_equal(cc, [3, 4, 5])
    np.testing.assert_array_equal(ww, [2, 7, 1])


def test_bin_edges_matches_layout():
    from graphtap.parallel.layout import Partition
    part = Partition.build(nv=3000, R=2, C=4, segment_align=128)
    rng = np.random.default_rng(1)
    r = rng.integers(0, part.nv, 5000).astype(np.int64)
    c = rng.integers(0, part.nv, 5000).astype(np.int64)
    perm, counts = native.bin_edges(r, c, part.L, part.R, part.C)
    dev = part.edge_device(r, c)
    np.testing.assert_array_equal(np.sort(dev[perm]), dev[perm])
    np.testing.assert_array_equal(counts, np.bincount(dev, minlength=8))
