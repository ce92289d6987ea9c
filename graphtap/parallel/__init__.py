from graphtap.parallel.layout import Partition, make_mesh, integer_factorize

__all__ = ["Partition", "make_mesh", "integer_factorize"]
