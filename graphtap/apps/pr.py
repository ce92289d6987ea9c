"""pr: two-phase PageRank binary (reference: src/apps/pr.cpp).

``python -m graphtap.apps.pr <file> <nvertices> [<iters>]`` — one
load of the transposed matrix with TCSC_CF, Deg on _COL_ then PR on
_ROW_ with the state handoff (pr.cpp:36-50).

``__main__`` shim only; import the API from
``graphtap.apps.pagerank`` (PageRankProgram, run_pagerank), not
from here."""
from graphtap import Graph, GraphConfig, Compression
from graphtap.apps.pagerank import run_pagerank
from graphtap.apps._cli import app_main, timed


def _run(path, nv, iters):
    g = Graph.load(path, GraphConfig(num_vertices=nv, directed=True,
                                     transpose=True,
                                     compression=Compression.TCSC_CF))
    return timed(run_pagerank, g, num_iterations=iters)


if __name__ == "__main__":
    app_main("pr", _run)
