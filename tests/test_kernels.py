"""Kernel unit tests: cross-validate the segment-reduce SpMV against the
dense one-hot ground truth on random tiles, over all semirings — the
analog of the reference's single-node kernel lab cross-checks
(src/singlenode/main.cpp; op counts and checksums must match across
formats)."""

import numpy as np
import pytest

import jax.numpy as jnp

from graphtap.kernels.semiring import (plus_times, min_plus, min_select,
                                       INF_I32)
from graphtap.kernels.spmv import (spmv_segment, spmv_dense_reference,
                                   spmv_sorted_scan, scatter_to_dense,
                                   expand_compact)


def _random_tile(rng, n_rows, n_cols, nnz, Ep, weighted, dtype):
    rows = np.sort(rng.integers(0, n_rows, nnz)).astype(np.int32)
    cols = rng.integers(0, n_cols, nnz).astype(np.int32)
    rows_p = np.concatenate([rows, np.full(Ep - nnz, rows[-1] if nnz else 0,
                                           np.int32)])
    cols_p = np.concatenate([cols, np.zeros(Ep - nnz, np.int32)])
    w = None
    if weighted:
        w = rng.integers(1, 129, Ep).astype(np.int32)
    if dtype == np.float64:
        x = rng.random(n_cols)
        if w is not None:
            w = w.astype(np.float64)
    else:
        x = rng.integers(0, 1000, n_cols).astype(np.int32)
    return rows_p, cols_p, w, x


@pytest.mark.parametrize("semiring,dtype", [
    (plus_times(), np.float64),
    (min_plus(), np.int32),
    (min_select(), np.int32),
])
@pytest.mark.parametrize("weighted", [False, True])
def test_segment_vs_dense(semiring, dtype, weighted):
    rng = np.random.default_rng(42)
    n_rows, n_cols, nnz, Ep = 96, 160, 700, 1024
    rows, cols, w, x = _random_tile(rng, n_rows, n_cols, nnz, Ep, weighted, dtype)
    y1 = spmv_segment(jnp.asarray(x), jnp.asarray(rows), jnp.asarray(cols),
                      None if w is None else jnp.asarray(w),
                      jnp.int32(nnz), n_rows, semiring)
    y2 = spmv_dense_reference(jnp.asarray(x), jnp.asarray(rows),
                              jnp.asarray(cols),
                              None if w is None else jnp.asarray(w),
                              jnp.int32(nnz), n_rows, semiring)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), rtol=1e-12)


@pytest.mark.parametrize("semiring,dtype", [
    (plus_times(), np.float64),
    (min_plus(), np.int32),
    (min_select(), np.int32),
])
@pytest.mark.parametrize("weighted", [False, True])
def test_scan_vs_dense(semiring, dtype, weighted):
    """The scatter-free segmented-scan kernel must agree with ground truth,
    including empty segments and padding lanes."""
    rng = np.random.default_rng(11)
    n_rows, n_cols, nnz, Ep = 96, 160, 700, 1024
    rows, cols, w, x = _random_tile(rng, n_rows, n_cols, nnz, Ep, weighted,
                                    dtype)
    ja = np.searchsorted(rows[:nnz], np.arange(n_rows + 1)).astype(np.int32)
    y1 = spmv_sorted_scan(jnp.asarray(x), jnp.asarray(rows),
                          jnp.asarray(cols),
                          None if w is None else jnp.asarray(w),
                          jnp.int32(nnz), jnp.asarray(ja), semiring)
    y2 = spmv_dense_reference(jnp.asarray(x), jnp.asarray(rows),
                              jnp.asarray(cols),
                              None if w is None else jnp.asarray(w),
                              jnp.int32(nnz), n_rows, semiring)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), rtol=1e-12)


def test_expand_compact_matches_scatter():
    sem = plus_times()
    y_comp = jnp.asarray(np.array([1.0, 2.0, 3.0]))
    ir = jnp.asarray(np.array([4, 7, 10], np.int32))
    iv = np.full(10, -1, np.int32)
    iv[4], iv[7] = 0, 1
    y1 = scatter_to_dense(y_comp, ir, 10, sem)
    y2 = expand_compact(y_comp, jnp.asarray(iv), sem)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2))


def test_empty_segments_fill_identity():
    sem = min_select()
    rows = jnp.asarray(np.array([2, 2, 5], np.int32))
    cols = jnp.asarray(np.array([0, 1, 2], np.int32))
    x = jnp.asarray(np.array([7, 3, 9], np.int32))
    y = spmv_segment(x, rows, cols, None, jnp.int32(3), 8, sem)
    y = np.asarray(y)
    assert y[2] == 3 and y[5] == 9
    # untouched segments must hold the ⊕-identity (INF for min)
    assert all(y[i] == INF_I32 for i in (0, 1, 3, 4, 6, 7))


def test_scatter_to_dense_drops_padding():
    sem = plus_times()
    y_comp = jnp.asarray(np.array([1.0, 2.0, 3.0]))
    ir = jnp.asarray(np.array([4, 7, 10], np.int32))  # 10 == dense_len → dropped
    y = scatter_to_dense(y_comp, ir, 10, sem)
    y = np.asarray(y)
    assert y[4] == 1.0 and y[7] == 2.0
    assert y.sum() == 3.0


def test_padding_masked_to_identity():
    sem = plus_times()
    rows = jnp.asarray(np.array([0, 0, 1, 1], np.int32))
    cols = jnp.asarray(np.array([0, 1, 0, 1], np.int32))
    x = jnp.asarray(np.array([5.0, 7.0]))
    # only the first 2 edges are valid
    y = spmv_segment(x, rows, cols, None, jnp.int32(2), 2, sem)
    np.testing.assert_allclose(np.asarray(y), [12.0, 0.0])
