from graphtap.apps.degree import DegreeProgram, run_degree
from graphtap.apps.pagerank import PageRankProgram, run_pagerank, run_pagerank_two_load
from graphtap.apps.cc import CCProgram, run_cc
from graphtap.apps.bfs import BFSProgram, run_bfs
from graphtap.apps.sssp import SSSPProgram, run_sssp

__all__ = [
    "DegreeProgram", "run_degree",
    "PageRankProgram", "run_pagerank", "run_pagerank_two_load",
    "CCProgram", "run_cc", "BFSProgram", "run_bfs", "SSSPProgram", "run_sssp",
]
