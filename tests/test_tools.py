"""Tools tests: converter CLI parity, stats oracle, kernel lab variants,
checkpoints and the profiled execution path."""

import os
import subprocess
import sys

import numpy as np
import pytest

from graphtap.ingest.io import read_edge_list, write_binary
from graphtap.tools.converter import main as converter_main
from graphtap.tools.oracle import state_stats
from graphtap.tools.kernel_lab import VARIANTS, run_variant

import golden

NV = 1025


def test_converter_bin_to_text_roundtrip(tmp_path, capsys, rmat10_path):
    txt = str(tmp_path / "g.el")
    back = str(tmp_path / "g.bin")
    assert converter_main([rmat10_path, txt, "--text-out"]) == 0
    out = capsys.readouterr().out
    assert "Edges: 16384" in out
    assert converter_main([txt, back]) == 0
    r0, c0, _ = read_edge_list(rmat10_path)
    r1, c1, _ = read_edge_list(back)
    np.testing.assert_array_equal(r0, r1)
    np.testing.assert_array_equal(c0, c1)


def test_converter_add_weights_and_displacement(tmp_path, rmat10_path):
    out = str(tmp_path / "w.bin")
    converter_main([rmat10_path, out, "--weights", "add", "--displacement",
                    "1", "--seed", "7"])
    r, c, w = read_edge_list(out, has_weight=True)
    r0, c0, _ = read_edge_list(rmat10_path)
    np.testing.assert_array_equal(r, r0 + 1)
    assert w.min() >= 1 and w.max() <= 128


def test_state_stats():
    vals = np.array([1.0, 2.0, 2.0, 3.0, 2147483647.0])
    s = state_stats(vals, 2147483647)
    assert s["count"] == 4
    assert s["mean"] == pytest.approx(2.0)
    assert s["mode"] == 2.0
    assert s["max"] == 3.0


@pytest.mark.parametrize("which", sorted(VARIANTS))
def test_kernel_lab_variants_agree(which, rmat10_path, rmat10_edges):
    r = run_variant(which, rmat10_path, 1024, 5)
    # all variants must produce the same checksum AND the same stored-edge
    # operation count (the reference's cross-format invariant,
    # csc_spmv.hpp:222-228); the checksum is the f64 golden model's, at
    # f32 tolerance
    src, dst = rmat10_edges
    gold = golden.pagerank(src, dst, NV, 5).sum()
    assert r["checksum"] == pytest.approx(gold, rel=1e-5)
    assert r["operations"] == src.size * 5
    assert r["slots"] >= r["operations"]


def test_kernel_lab_rejects_removed_variant(capsys):
    from graphtap.tools.kernel_lab import main
    assert main(["5", "g.bin", "1024", "5"]) == 1
    assert "Usage" in capsys.readouterr().out


def test_pr1_two_load(rmat10_path, rmat10_edges):
    from graphtap.apps.pagerank import run_pagerank_two_load
    import jax.numpy as jnp
    ex = run_pagerank_two_load(rmat10_path, 1024, num_iterations=20,
                               value_dtype=jnp.float64)
    total, _ = ex.checksum()
    src, dst = rmat10_edges
    assert total == pytest.approx(golden.pagerank(src, dst, NV, 20).sum(),
                                  rel=1e-9)


def test_checkpoint_resume(tmp_path, rmat10_path):
    """Save at iteration 10, restore into a fresh executor, run 10 more:
    must bit-match the straight 20-iteration run."""
    import jax
    import jax.numpy as jnp
    from graphtap import Graph, GraphConfig, Compression, make_mesh
    from graphtap.apps.degree import DegreeProgram
    from graphtap.apps.pagerank import PageRankProgram
    from graphtap.config import EngineConfig, Ordering
    from graphtap.engine.executor import Executor
    from graphtap.tools.checkpoint import save_state, load_state

    mesh = make_mesh(jax.devices()[:4], shape=(2, 2))
    cfg = GraphConfig(num_vertices=1024, directed=True, transpose=True,
                      compression=Compression.TCSC)
    g = Graph.load(rmat10_path, cfg, mesh=mesh)

    def fresh_pr():
        deg_ex = Executor(g, DegreeProgram(value_dtype=jnp.float64),
                          EngineConfig(stationary=True, ordering=Ordering.COL))
        deg_ex.initialize()
        deg_ex.execute(1)
        ex = Executor(g, PageRankProgram(value_dtype=jnp.float64),
                      EngineConfig(stationary=True, ordering=Ordering.ROW))
        ex.initialize(other=deg_ex)
        return ex

    straight = fresh_pr()
    straight.execute(20)

    first = fresh_pr()
    first.execute(10)
    path = str(tmp_path / "pr_it10.npz")
    save_state(first, path)

    resumed = fresh_pr()
    assert load_state(resumed, path) == 10
    resumed.execute(10)

    np.testing.assert_array_equal(resumed.state_vector()["rank"],
                                  straight.state_vector()["rank"])
    assert resumed.checksum() == straight.checksum()


def test_checkpoint_shape_mismatch_rejected(tmp_path, rmat10_path):
    import jax
    import jax.numpy as jnp
    from graphtap import Graph, GraphConfig, Compression, make_mesh
    from graphtap.apps.degree import DegreeProgram
    from graphtap.config import EngineConfig, Ordering
    from graphtap.engine.executor import Executor
    from graphtap.tools.checkpoint import save_state, load_state

    mesh = make_mesh(jax.devices()[:1], shape=(1, 1))
    cfg = GraphConfig(num_vertices=1024, directed=True, transpose=False,
                      compression=Compression.TCSC)
    g = Graph.load(rmat10_path, cfg, mesh=mesh)
    ex = Executor(g, DegreeProgram(value_dtype=jnp.float64),
                  EngineConfig(stationary=True, ordering=Ordering.ROW))
    ex.initialize()
    path = str(tmp_path / "deg.npz")
    save_state(ex, path)

    cfg2 = GraphConfig(num_vertices=2048, directed=True, transpose=False,
                       compression=Compression.TCSC)
    g2 = Graph.load(rmat10_path, cfg2, mesh=mesh)
    ex2 = Executor(g2, DegreeProgram(value_dtype=jnp.float64),
                   EngineConfig(stationary=True, ordering=Ordering.ROW))
    ex2.initialize()
    with pytest.raises(ValueError):
        load_state(ex2, path)


def test_execute_profiled_matches_and_reports(rmat10_edges):
    """The -DTIMING analog: split-phase execution must produce the same
    PageRank result as the fused loop, print 'Iteration: n' lines, and
    fill the PhaseTimer (reference: vertex_program.hpp:422, 2134-2152)."""
    import jax.numpy as jnp
    from graphtap import Graph, GraphConfig, Compression, make_mesh
    from graphtap.apps.degree import DegreeProgram
    from graphtap.apps.pagerank import PageRankProgram
    from graphtap.config import EngineConfig, Ordering
    from graphtap.engine.executor import Executor
    import jax

    src, dst = rmat10_edges
    mesh = make_mesh(jax.devices()[:4], shape=(2, 2))
    cfg = GraphConfig(num_vertices=1024, directed=True, transpose=True,
                      compression=Compression.TCSC)
    g = Graph.from_edges(src, dst, None, cfg, mesh=mesh)
    deg = Executor(g, DegreeProgram(value_dtype=jnp.float64),
                   EngineConfig(stationary=True, ordering=Ordering.COL))
    deg.initialize()
    deg.execute(1)

    ex_a = Executor(g, PageRankProgram(value_dtype=jnp.float64),
                    EngineConfig(stationary=True, ordering=Ordering.ROW))
    ex_a.initialize(other=deg)
    ex_a.execute(5)

    lines = []
    ex_b = Executor(g, PageRankProgram(value_dtype=jnp.float64),
                    EngineConfig(stationary=True, ordering=Ordering.ROW))
    ex_b.initialize(other=deg)
    timer = ex_b.execute_profiled(5, printer=lines.append)
    assert lines.count("Iteration: 1") == 1 and "Iteration: 5" in lines
    assert set(timer.samples) == {"scatter_gather", "combine", "apply"}
    assert all(len(v) == 5 for v in timer.samples.values())
    np.testing.assert_allclose(ex_b.state_vector()["rank"],
                               ex_a.state_vector()["rank"], rtol=1e-12)


def test_execute_profiled_convergence_flush(rmat10_edges):
    """Profiled BFS to convergence must bit-match the fused loop — the
    profiled path now runs the same post-convergence flush from the
    stale x (reference: vertex_program.hpp:425-429)."""
    import jax
    import jax.numpy as jnp
    from graphtap import Graph, GraphConfig, Compression, make_mesh
    from graphtap.apps.bfs import BFSProgram, bfs_config
    from graphtap.config import EngineConfig, Ordering
    from graphtap.engine.executor import Executor

    src, dst = rmat10_edges
    mesh = make_mesh(jax.devices()[:4], shape=(2, 2))
    g = Graph.from_edges(src, dst, None, bfs_config(1024), mesh=mesh)
    eng = EngineConfig(stationary=False, apply_depends_on_iter=True,
                       ordering=Ordering.ROW)
    ex_a = Executor(g, BFSProgram(root=0), eng)
    ex_a.initialize()
    ex_a.execute(0)
    ex_b = Executor(g, BFSProgram(root=0), eng)
    ex_b.initialize()
    ex_b.execute_profiled(0, printer=None)
    assert ex_b.iteration == ex_a.iteration
    for k in ex_a.state_vector():
        np.testing.assert_array_equal(ex_b.state_vector()[k],
                                      ex_a.state_vector()[k])


def test_execute_profiled_cf_phases(rmat10_edges):
    """Profiled TCSC_CF PageRank must run the first/middle/last phase
    plans in the fused loop's positions (reference: spmv_stationary phase
    gating, vertex_program.hpp:1243-1320) and bit-match execute()."""
    import jax
    import jax.numpy as jnp
    from graphtap import Graph, GraphConfig, Compression, make_mesh
    from graphtap.apps.degree import DegreeProgram
    from graphtap.apps.pagerank import PageRankProgram
    from graphtap.config import EngineConfig, Ordering
    from graphtap.engine.executor import Executor

    src, dst = rmat10_edges
    mesh = make_mesh(jax.devices()[:4], shape=(2, 2))
    cfg = GraphConfig(num_vertices=1024, directed=True, transpose=True,
                      compression=Compression.TCSC_CF)
    g = Graph.from_edges(src, dst, None, cfg, mesh=mesh)
    deg = Executor(g, DegreeProgram(value_dtype=jnp.float64),
                   EngineConfig(stationary=True, ordering=Ordering.COL),
                   tiles=g.tiled(Ordering.COL, compression=Compression.TCSC))
    deg.initialize()
    deg.execute(1)
    ex_a = Executor(g, PageRankProgram(value_dtype=jnp.float64),
                    EngineConfig(stationary=True, ordering=Ordering.ROW))
    ex_a.initialize(other=deg)
    ex_a.execute(5)
    ex_b = Executor(g, PageRankProgram(value_dtype=jnp.float64),
                    EngineConfig(stationary=True, ordering=Ordering.ROW))
    ex_b.initialize(other=deg)
    ex_b.execute_profiled(5, printer=None)
    np.testing.assert_allclose(ex_b.state_vector()["rank"],
                               ex_a.state_vector()["rank"], rtol=1e-12)


def test_trace_summary_reads_a_recorded_trace(tmp_path):
    """The trace reduction of tools_dev/kernel_ab.py on a small trace
    recorded here (its device planes are CPU threads)."""
    import jax
    import jax.numpy as jnp
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools_dev"))
    from kernel_ab import summarize_trace

    f = jax.jit(lambda x: jnp.sort(jnp.sin(x)))
    x = jnp.ones(1 << 12)
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    s = summarize_trace(str(tmp_path), plane_prefix="/host:CPU")
    assert s["lines"]
    line = next(iter(s["lines"].values()))
    assert line["events"] >= 1 and line["total_ns"] >= 0
    assert len(line["top"]) <= 8
    assert s["busy_share"] is None        # no GPU stream lines here
    with pytest.raises(ValueError):
        summarize_trace(str(tmp_path / "missing"))
