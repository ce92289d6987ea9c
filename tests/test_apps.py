"""End-to-end app tests on the generated RMAT-10 fixture (conftest.py),
validated against independent NumPy golden models, through both SpMV
kernels; plus the reference's own printed oracle (BASELINE.md) on its
rmat10 file where that file is present.

The meshes are 1×1 and the 2×4 CPU-device simulation, so every app also
runs the real all_gather / reduce-scatter collectives.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from graphtap import Graph, GraphConfig, Compression, make_mesh
from graphtap.apps import (run_pagerank, run_cc, run_bfs, run_sssp,
                           run_degree)
from graphtap.apps.cc import cc_config
from graphtap.apps.bfs import bfs_config
from graphtap.apps.sssp import sssp_config
from graphtap.engine.executor import KERNELS

import golden

NV = 1025  # 1024 vertices + the id-0 slot (reference: graph.hpp:84-85)

# Captured from the reference single-node lab (g++-built, see BASELINE.md):
#   ./main 0 rmat10_1024.bin 1024 20 -> Final value 317.018, V[0]=0.165455 ...
REF_PR_CHECKSUM = 317.0176895329694


@pytest.fixture(scope="module", params=[(1, 1), (2, 4)],
                ids=["mesh1x1", "mesh2x4"])
def mesh(request):
    import jax
    r, c = request.param
    return make_mesh(jax.devices()[: r * c], shape=(r, c))


@pytest.mark.parametrize("kernel", KERNELS)
def test_pagerank_matches_reference(mesh, rmat10_edges, kernel):
    src, dst = rmat10_edges
    cfg = GraphConfig(num_vertices=1024, directed=True, transpose=True,
                      compression=Compression.TCSC)
    g = Graph.from_edges(src, dst, None, cfg, mesh=mesh)
    ex = run_pagerank(g, num_iterations=20, value_dtype=jnp.float64,
                      kernel=kernel)
    total, reachable = ex.checksum()
    gold = golden.pagerank(src, dst, NV, 20)
    assert total == pytest.approx(gold.sum(), rel=1e-12)
    ranks = ex.state_vector()["rank"]
    np.testing.assert_allclose(ranks, gold, rtol=1e-10, atol=1e-12)


def test_pagerank_reference_checksum(mesh, reference_rmat10):
    """The reference binary's printed PageRank checksum on its own
    rmat10_1024.bin (skips where that file is absent)."""
    cfg = GraphConfig(num_vertices=1024, directed=True, transpose=True,
                      compression=Compression.TCSC)
    g = Graph.load(reference_rmat10, cfg, mesh=mesh)
    ex = run_pagerank(g, num_iterations=20, value_dtype=jnp.float64)
    total, _ = ex.checksum()
    assert total == pytest.approx(REF_PR_CHECKSUM, rel=1e-9)


def test_degree(mesh, rmat10_edges):
    src, dst = rmat10_edges
    cfg = GraphConfig(num_vertices=1024, directed=True, transpose=False,
                      compression=Compression.TCSC)
    g = Graph.from_edges(src, dst, None, cfg, mesh=mesh)
    ex = run_degree(g, value_dtype=jnp.float64)
    deg = ex.state_vector()["degree"]
    gold = golden.degree(src, dst, NV)
    np.testing.assert_array_equal(deg.astype(np.int64), gold)


@pytest.mark.parametrize("kernel", KERNELS)
def test_bfs(mesh, rmat10_edges, kernel):
    src, dst = rmat10_edges
    g = Graph.from_edges(src, dst, None, bfs_config(1024), mesh=mesh)
    ex = run_bfs(g, root=0, kernel=kernel)
    sv = ex.state_vector()
    parent_g, hops_g = golden.bfs(src, dst, NV, root=0)
    np.testing.assert_array_equal(sv["hops"].astype(np.int64), hops_g)
    reached = hops_g != golden.INF
    np.testing.assert_array_equal(sv["parent"][reached].astype(np.int64),
                                  parent_g[reached])


@pytest.mark.parametrize("kernel", KERNELS)
def test_cc(mesh, rmat10_edges, kernel):
    src, dst = rmat10_edges
    g = Graph.from_edges(src, dst, None, cc_config(1024), mesh=mesh)
    ex = run_cc(g, kernel=kernel)
    labels = ex.state_vector()["label"]
    gold = golden.cc(src, dst, NV)
    np.testing.assert_array_equal(labels.astype(np.int64), gold)


@pytest.mark.parametrize("kernel", KERNELS)
def test_sssp(mesh, rmat10_w_edges, kernel):
    src, dst, w = rmat10_w_edges
    g = Graph.from_edges(src, dst, w, sssp_config(1024), mesh=mesh)
    ex = run_sssp(g, root=0, kernel=kernel)
    dist = ex.state_vector()["distance"]
    gold = golden.sssp(src, dst, w, NV, root=0)
    np.testing.assert_array_equal(dist.astype(np.int64), gold)


def test_checksum_reachable_counts(mesh, rmat10_edges):
    src, dst = rmat10_edges
    g = Graph.from_edges(src, dst, None, bfs_config(1024), mesh=mesh)
    ex = run_bfs(g, root=0)
    total, reachable = ex.checksum()
    _, hops_g = golden.bfs(src, dst, NV, root=0)
    mask = hops_g != golden.INF
    assert reachable == int(mask.sum())
    assert total == pytest.approx(float(hops_g[mask].sum()))


@pytest.mark.parametrize("capacity", [8, 64, 100000])
def test_bfs_sparse_exchange(mesh, rmat10_edges, capacity):
    """Activity-filtered exchange (reference: scatter/gather_nonstationary,
    vertex_program.hpp:865-966): sparse/dense vote per iteration must not
    change any result. Small capacities force mid-run dense fallbacks."""
    from graphtap.apps.bfs import BFSProgram
    from graphtap.config import EngineConfig, Ordering
    from graphtap.engine.executor import Executor

    src, dst = rmat10_edges
    g = Graph.from_edges(src, dst, None, bfs_config(1024), mesh=mesh)
    ex = Executor(g, BFSProgram(root=0),
                  EngineConfig(stationary=False, apply_depends_on_iter=True,
                               ordering=Ordering.ROW,
                               sparse_exchange_capacity=capacity))
    ex.initialize()
    ex.execute(0)
    sv = ex.state_vector()
    parent_g, hops_g = golden.bfs(src, dst, NV, root=0)
    np.testing.assert_array_equal(sv["hops"].astype(np.int64), hops_g)


def test_sssp_sparse_exchange(mesh, rmat10_w_edges):
    from graphtap.apps.sssp import SSSPProgram
    from graphtap.config import EngineConfig, Ordering
    from graphtap.engine.executor import Executor

    src, dst, w = rmat10_w_edges
    g = Graph.from_edges(src, dst, w, sssp_config(1024), mesh=mesh)
    ex = Executor(g, SSSPProgram(root=0),
                  EngineConfig(stationary=False, gather_depends_on_apply=True,
                               ordering=Ordering.ROW,
                               sparse_exchange_capacity=32))
    ex.initialize()
    ex.execute(0)
    dist = ex.state_vector()["distance"]
    gold = golden.sssp(src, dst, w, NV, root=0)
    np.testing.assert_array_equal(dist.astype(np.int64), gold)
