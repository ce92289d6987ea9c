"""TCSC_CF (computation filtering) tests: the pr.cpp pipeline with
_TCSC_CF_ must produce the same values as plain TCSC and the golden model
(reference: the formats are outputs-equivalent; singlenode harness
cross-checks)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from graphtap import Graph, GraphConfig, Compression, make_mesh
from graphtap.apps.pagerank import run_pagerank
from graphtap.format.tiles import classify_vertices

import golden

NV = 1025
REF_PR_CHECKSUM = 317.0176895329694


@pytest.fixture(scope="module", params=[(1, 1), (2, 2)],
                ids=["mesh1x1", "mesh2x2"])
def mesh(request):
    r, c = request.param
    return make_mesh(jax.devices()[: r * c], shape=(r, c))


def test_classification(rmat10_edges):
    src, dst = rmat10_edges
    # stored matrix = transpose (PR orientation): rows = dst, cols = src
    cls = classify_vertices(dst, src, 2048)
    has_in = np.zeros(2048, bool); has_in[dst] = True
    has_out = np.zeros(2048, bool); has_out[src] = True
    np.testing.assert_array_equal(cls["regular"], has_in & has_out)
    np.testing.assert_array_equal(cls["source_row"], has_in & ~has_out)
    np.testing.assert_array_equal(cls["sink_col"], has_out & ~has_in)


def test_pagerank_tcsc_cf_matches_reference(mesh, rmat10_edges):
    """pr.cpp's exact config: _TCSC_CF_ with the phased first/middle/last
    execution (pr.cpp:33, vertex_program.hpp:1243-1320)."""
    src, dst = rmat10_edges
    cfg = GraphConfig(num_vertices=1024, directed=True, transpose=True,
                      compression=Compression.TCSC_CF)
    g = Graph.from_edges(src, dst, None, cfg, mesh=mesh)
    ex = run_pagerank(g, num_iterations=20, value_dtype=jnp.float64)
    total, _ = ex.checksum()
    gold = golden.pagerank(src, dst, NV, 20)
    assert total == pytest.approx(gold.sum(), rel=1e-12)
    np.testing.assert_allclose(ex.state_vector()["rank"], gold,
                               rtol=1e-10, atol=1e-12)


def test_pagerank_tcsc_cf_reference_checksum(mesh, reference_rmat10):
    """The reference binary's printed checksum on its own rmat10_1024.bin
    (skips where that file is absent)."""
    cfg = GraphConfig(num_vertices=1024, directed=True, transpose=True,
                      compression=Compression.TCSC_CF)
    g = Graph.load(reference_rmat10, cfg, mesh=mesh)
    ex = run_pagerank(g, num_iterations=20, value_dtype=jnp.float64)
    total, _ = ex.checksum()
    assert total == pytest.approx(REF_PR_CHECKSUM, rel=1e-9)


def test_pagerank_tcsc_cf_convergence(mesh, rmat10_edges):
    """iters=0 on a CF matrix: first-phase step, middle-phase loop with
    the regular-rows-only vote, last-phase flush (reference:
    vertex_program.hpp:1885-1923, :425-429). Must match the plain-TCSC
    convergence run."""
    src, dst = rmat10_edges
    cfg_cf = GraphConfig(num_vertices=1024, directed=True, transpose=True,
                         compression=Compression.TCSC_CF)
    g_cf = Graph.from_edges(src, dst, None, cfg_cf, mesh=mesh)
    ex_cf = run_pagerank(g_cf, num_iterations=0, value_dtype=jnp.float64)

    cfg_t = GraphConfig(num_vertices=1024, directed=True, transpose=True,
                        compression=Compression.TCSC)
    g_t = Graph.from_edges(src, dst, None, cfg_t, mesh=mesh)
    ex_t = run_pagerank(g_t, num_iterations=0, value_dtype=jnp.float64)

    assert ex_cf.iteration > 1
    # the regular-rows-only vote can stop a step earlier than plain
    # TCSC's all-rows vote (reference: vertex_program.hpp:1885-1923 —
    # CF defers source rows to the flush), so agreement is at the
    # convergence tolerance (tol=1e-5), not bitwise
    np.testing.assert_allclose(ex_cf.state_vector()["rank"],
                               ex_t.state_vector()["rank"],
                               rtol=0, atol=2e-5)
    cs_cf, _ = ex_cf.checksum()
    cs_t, _ = ex_t.checksum()
    assert cs_cf == pytest.approx(cs_t, abs=2e-3)
