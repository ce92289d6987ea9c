"""REAL multi-process runtime test: 2 OS processes, jax.distributed with
a local coordinator, byte-range ingest + exchange_edges + distributed
PageRank — the true multi-process code paths (put_device_stacked,
allgather_state, global_or), not the monkeypatched simulation of
test_multihost.py. Reference analog: ``mpirun -np 4 bin/pr``
(README.md:7-10) on one machine."""
import os
import socket
import subprocess
import sys

import pytest

import golden

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "two_process_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.timeout(600)
def test_two_process_pagerank(rmat10_path, rmat10_edges):
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # workers set their own
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(i), "2", str(port), rmat10_path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\n{out}\n{err[-3000:]}"
    out0 = outs[0][1]
    lines = {ln.split()[0]: ln.split()[1:] for ln in out0.splitlines()
             if ln and ln.split()[0] in ("EDGES", "CHECKSUM",
                                         "CHECKSUM_CF", "CHECKSUM_SEGMENT")}
    assert int(lines["EDGES"][0]) == 16384          # conservation
    # the f64 golden model (20 iters); every vertex holds a finite rank
    src, dst = rmat10_edges
    gold = golden.pagerank(src, dst, 1025, 20).sum()
    for key in ("CHECKSUM", "CHECKSUM_CF", "CHECKSUM_SEGMENT"):
        cs = float(lines[key][0])
        reach = int(lines[key][1])
        assert abs(cs - gold) < 2e-3, (key, cs, gold)
        assert reach == 1025, key
