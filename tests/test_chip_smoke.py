"""chip_smoke.py off the GPU: every phase function passes its own check on
CPU meshes at RMAT-10, and the script itself refuses to run without a GPU
(exit code non-zero, no ``"ok"`` line)."""

import json
import os
import subprocess
import sys

import jax
import pytest

from graphtap import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

SCALE = 10


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("smoke_cache"))


@pytest.fixture(scope="module", params=[(1, 1), (2, 2)],
                ids=["mesh1x1", "mesh2x2"])
def mesh(request):
    r, c = request.param
    return make_mesh(jax.devices()[: r * c], shape=(r, c))


def test_phase_pagerank(mesh, cache):
    rec, ranks = cs.phase_pagerank(mesh, SCALE, 20, cache)
    assert rec["iterations"] == 20 and rec["edges"] == 16 << SCALE
    assert ranks.shape == ((1 << SCALE) + 1,)
    assert rec["max_rel_err"] <= cs.PR_RTOL
    assert {"ingest", "tiles", "upload", "compile"} <= set(rec["setup_s"])
    assert {"bytes_in_use_start", "bytes_in_use",
            "peak_bytes_in_use"} <= set(rec)


def test_phase_bfs(mesh, cache):
    rec, sv = cs.phase_bfs(mesh, SCALE, cache)
    assert rec["iterations"] > 1 and rec["reached"] > 1


def test_phase_cc(mesh, cache):
    rec = cs.phase_cc(mesh, SCALE, cache)
    assert rec["iterations"] > 1 and rec["components"] >= 1


def test_phase_sssp(mesh, cache):
    rec = cs.phase_sssp(mesh, SCALE, cache)
    assert rec["iterations"] > 1 and rec["reached"] > 1


def test_phase_mesh_matches_one_device(cache):
    recs = cs.phase_mesh(jax.devices(), SCALE, SCALE, 20, cache)
    assert [r["mesh"] for r in recs] == [[2, 2], [1, 1], [2, 2], [1, 1]]
    assert recs[0]["vs_one_device"]["max_rel_err"] <= cs.PR_RTOL


def test_check_ranks_rejects_drift():
    import numpy as np
    want = np.full(100, 0.15) + np.arange(100)
    got = want.copy()
    got[7] *= 1 + 10 * cs.PR_RTOL
    with pytest.raises(cs.SmokeFailure):
        cs.check_ranks("drift", got, want)
    with pytest.raises(cs.SmokeFailure):
        cs.check_equal("labels", [1, 2, 3], [1, 2, 4])


def test_script_refuses_cpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jc"))
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            assert json.loads(line).get("ok") is not True


@pytest.mark.parametrize("chips", [1, 4])
def test_main_reports_cards_used(chips, monkeypatch, capsys, tmp_path):
    """The last line counts the cards the phases ran on, not every device
    JAX sees (eight here)."""
    seen = []

    def rec(mesh):
        seen.append(mesh.devices.size)
        return {"phase": "stub", "scale": 1, "kernel": "scan",
                "mesh": list(mesh.devices.shape), "iterations": 1,
                "setup_s": {}, "loop_s": 1.0, "gteps": 0.0,
                "bytes_in_use_start": None, "bytes_in_use": None,
                "peak_bytes_in_use": None}

    monkeypatch.setattr(cs, "CACHE", str(tmp_path))
    monkeypatch.setattr(cs, "setup_compile_cache", lambda: None)
    monkeypatch.setattr(cs, "require_gpu", lambda: None)
    monkeypatch.setattr(cs, "nvidia_smi", lambda: [])
    monkeypatch.setattr(cs, "phase_pagerank", lambda m: (rec(m), None))
    monkeypatch.setattr(cs, "phase_bfs", lambda m: (rec(m), None))
    monkeypatch.setattr(cs, "phase_cc", rec)
    monkeypatch.setattr(cs, "phase_sssp", rec)
    monkeypatch.setattr(cs, "phase_mesh", lambda devs: [
        rec(make_mesh(devs, shape=(2, 2)))])
    assert cs.main(["--chips", str(chips)]) == 0
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["ok"] is True and last["device"]["count"] == chips
    assert set(seen) == {chips}
