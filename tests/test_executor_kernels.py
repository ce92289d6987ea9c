"""The engine's SpMV kernel selection: the default, the apps inheriting
it, the removed kernels rejected by name, and the compile-cache rule."""

import os

import jax
import jax.numpy as jnp
import pytest

from graphtap import Graph, GraphConfig, Compression, make_mesh
from graphtap.apps.bfs import run_bfs, bfs_config
from graphtap.apps.degree import DegreeProgram
from graphtap.config import EngineConfig, Ordering
from graphtap.engine import executor as executor_mod
from graphtap.engine.executor import DEFAULT_KERNEL, KERNELS, Executor
from graphtap.tools import compile_cache


@pytest.fixture(scope="module")
def graph(rmat10_edges):
    src, dst = rmat10_edges
    mesh = make_mesh(jax.devices()[:1], shape=(1, 1))
    cfg = GraphConfig(num_vertices=1024, directed=True, transpose=False,
                      compression=Compression.TCSC)
    return Graph.from_edges(src, dst, None, cfg, mesh=mesh)


def _degree(graph, **kw):
    return Executor(graph, DegreeProgram(value_dtype=jnp.float32),
                    EngineConfig(stationary=True, ordering=Ordering.ROW),
                    **kw)


def test_kernels_are_the_portable_pair():
    assert KERNELS == ("scan", "segment")
    assert DEFAULT_KERNEL in KERNELS


def test_default_kernel_selected(graph):
    assert _degree(graph).kernel == DEFAULT_KERNEL
    assert _degree(graph, kernel=None).kernel == DEFAULT_KERNEL
    for k in KERNELS:
        assert _degree(graph, kernel=k).kernel == k


def test_apps_inherit_the_default(rmat10_edges, monkeypatch):
    """The apps pass no kernel of their own, so the one selection point
    in engine/executor.py decides for them."""
    src, dst = rmat10_edges
    mesh = make_mesh(jax.devices()[:1], shape=(1, 1))
    g = Graph.from_edges(src, dst, None, bfs_config(1024), mesh=mesh)
    for k in KERNELS:
        monkeypatch.setattr(executor_mod, "DEFAULT_KERNEL", k)
        assert run_bfs(g, root=0).kernel == k


@pytest.mark.parametrize("name", ["shuffle", "shuffle2", "panel", "onehot",
                                  "auto"])
def test_removed_kernels_rejected(graph, name):
    with pytest.raises(ValueError, match="unknown SpMV kernel"):
        _degree(graph, kernel=name)


def test_compile_cache_default_dir(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    prev = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.setup_compile_cache()
        assert path == os.path.join(compile_cache.CHECKOUT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert os.path.exists(os.path.join(compile_cache.CHECKOUT,
                                           "graphtap", "__init__.py"))
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    prev = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.setup_compile_cache() == str(tmp_path)
        # left to JAX: nothing here points the cache under the checkout
        assert jax.config.jax_compilation_cache_dir == prev
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
