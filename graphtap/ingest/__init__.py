from graphtap.ingest.io import read_edge_list, apply_transforms, write_binary
from graphtap.ingest.graph import Graph
from graphtap.ingest.rmat import rmat_edges

__all__ = ["read_edge_list", "apply_transforms", "write_binary", "Graph", "rmat_edges"]
