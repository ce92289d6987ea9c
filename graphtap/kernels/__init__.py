from graphtap.kernels.semiring import Semiring, plus_times, min_plus, min_select
from graphtap.kernels.spmv import spmv_segment, spmv_dense_reference

__all__ = [
    "Semiring", "plus_times", "min_plus", "min_select",
    "spmv_segment", "spmv_dense_reference",
]
