"""Test config: an 8-device CPU mesh, x64 for the f64 PageRank oracle (the
reference's value path is double, deg.h:19), and the graph fixtures.

Tests run on the CPU only: ``JAX_PLATFORMS=cpu`` plus XLA's
``--xla_force_host_platform_device_count=8`` give eight virtual devices,
so the 2x4 mesh tests exercise the real all_gather / reduce-scatter
collectives.

The RMAT-10 fixtures are generated here from a seed (1,024 vertices,
16,384 edges, weights 1..128 on the weighted copy) and written in the
reference's binary edge-list layout — ``u32`` (row, col) pairs, or
(row, col, weight) triples — so the binary readers still read real files.
The reference repository's own ``data/rmat10_1024*.bin`` files are used
only by the tests that check its printed checksums. They are looked for in
``reference/data`` beside this checkout (the reference repository cloned
next to this one as ``reference``); ``GRAPHTAP_REFERENCE_DATA`` names
another directory. Those tests skip where the file is absent.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from graphtap.ingest.io import write_binary  # noqa: E402
from graphtap.ingest.rmat import rmat_edges  # noqa: E402

RMAT10_SCALE = 10
RMAT10_EDGES = 16 << RMAT10_SCALE
RMAT10_SEED = 1
REFERENCE_DATA_ENV = "GRAPHTAP_REFERENCE_DATA"
REFERENCE_DATA_DEFAULT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "reference", "data")


@pytest.fixture(scope="session")
def rmat10_files(tmp_path_factory):
    """{"plain": path, "weighted": path} of the generated RMAT-10 graph.
    Both hold the same edges; the weighted file adds the weights."""
    r, c, w = rmat_edges(scale=RMAT10_SCALE, edge_factor=16,
                         seed=RMAT10_SEED, weighted=True)
    d = tmp_path_factory.mktemp("rmat10")
    paths = {"plain": str(d / "rmat10_1024.bin"),
             "weighted": str(d / "rmat10_1024_w.bin")}
    write_binary(paths["plain"], r, c, None)
    write_binary(paths["weighted"], r, c, w)
    return paths


@pytest.fixture(scope="session")
def rmat10_path(rmat10_files):
    return rmat10_files["plain"]


@pytest.fixture(scope="session")
def rmat10_w_path(rmat10_files):
    return rmat10_files["weighted"]


@pytest.fixture(scope="session")
def rmat10_edges(rmat10_path):
    raw = np.fromfile(rmat10_path, dtype=np.uint32).reshape(-1, 2)
    return raw[:, 0].astype(np.int64), raw[:, 1].astype(np.int64)


@pytest.fixture(scope="session")
def rmat10_w_edges(rmat10_w_path):
    raw = np.fromfile(rmat10_w_path, dtype=np.uint32).reshape(-1, 3)
    return (raw[:, 0].astype(np.int64), raw[:, 1].astype(np.int64),
            raw[:, 2].astype(np.int32))


@pytest.fixture
def reference_rmat10():
    """Path of the reference repository's rmat10_1024.bin, from
    ``GRAPHTAP_REFERENCE_DATA`` or else ``REFERENCE_DATA_DEFAULT``; skips
    the test when that directory does not hold it."""
    d = os.environ.get(REFERENCE_DATA_ENV) or REFERENCE_DATA_DEFAULT
    path = os.path.join(d, "rmat10_1024.bin")
    if not os.path.exists(path):
        pytest.skip(f"reference data absent: {path} (set "
                    f"{REFERENCE_DATA_ENV} to the reference repository's "
                    "data/ directory)")
    return path
