"""pr1: two-load PageRank binary (reference: src/apps/pr1.cpp) — loads
the graph twice (untransposed for degree, transposed for PR), plain
TCSC (pr1.cpp:32-53)."""
from graphtap.apps.pagerank import run_pagerank_two_load
from graphtap.apps._cli import app_main, timed


def _run(path, nv, iters):
    return timed(run_pagerank_two_load, path, nv, num_iterations=iters)


if __name__ == "__main__":
    app_main("pr1", _run)
