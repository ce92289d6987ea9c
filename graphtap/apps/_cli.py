"""Shared CLI harness for the app mains.

Re-creates the reference binaries' UX (reference: README.md:7-10 —
``mpirun -np N bin/pr <file> <nvertices> [<iters|root>]``) and their
grep-target output lines (graphtap.slurm:101-104; formats from
Env::print_time env.hpp:130-133, checksum vertex_program.hpp:1944-1958):

    <App> end-to-end time: <f> seconds
    Execute time: <f> seconds
    Iterations: <n>
    Value checksum: <v>
    Reachable vertices: <n>

Usage: ``python -m graphtap.apps.pr <file> <nvertices> [<iters>]``
(pr1, deg, cc, bfs, sssp analogous).
"""

from __future__ import annotations

import argparse
import time

from graphtap.tools.compile_cache import setup_compile_cache


def app_main(name: str, run, third_arg: str = "iters", default_third=0):
    """Parse the reference-style argv, run the app, print the oracle
    lines. ``run(graph_path, nvertices, third)`` must return the
    finished Executor."""
    p = argparse.ArgumentParser(prog=f"graphtap.apps.{name}")
    p.add_argument("file")
    p.add_argument("nvertices", type=int)
    p.add_argument(third_arg, type=int, nargs="?", default=default_third)
    args = p.parse_args()
    setup_compile_cache()

    t0 = time.perf_counter()
    ex, t_exec = run(args.file, args.nvertices, getattr(args, third_arg))
    t_total = time.perf_counter() - t0

    checksum, reachable = ex.checksum()
    import jax
    if jax.process_index() == 0:
        # load-time balance report (reference: Matrix::balance,
        # matrix.hpp:617-685, master-only print, threshold 0.2)
        print(ex.tiles.balance_report())
    print(f"{name} end-to-end time: {t_total:f} seconds")
    print(f"Execute time: {t_exec:f} seconds")
    print(f"Iterations: {ex.iteration}")
    print(f"Value checksum: {checksum:f}")
    print(f"Reachable vertices: {reachable}")
    return ex


def timed(fn, *a, **kw):
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    return out, time.perf_counter() - t0
