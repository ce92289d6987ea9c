"""deg: degree CLI binary (reference: src/apps/deg.cpp — stationary,
_TCSC_, one iteration).

``__main__`` shim only (the analog of the reference's thin .cpp main);
import the API from ``graphtap.apps.degree`` (DegreeProgram,
run_degree), not from here."""
from graphtap import Graph, GraphConfig, Compression
from graphtap.apps.degree import run_degree
from graphtap.apps._cli import app_main, timed


def _run(path, nv, _third):
    g = Graph.load(path, GraphConfig(num_vertices=nv, directed=True,
                                     transpose=False,
                                     compression=Compression.TCSC))
    return timed(run_degree, g)


if __name__ == "__main__":
    app_main("deg", _run, third_arg="iters", default_third=1)
