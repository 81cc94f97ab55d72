"""Array helpers shared by the port's routines, and the core surface of
``nd4js_tpu/core``: array creation and elementwise maps (``ndarray``),
leading-dimension batching (``batch``) and compensated sums (``kahan``,
on the CUDA kernel ``csrc/kahan_sum.cu``)."""
from .ndarray import (array, asarray, tabulate, zip_elems, concat, stack,
                      map_elems, reduce_elems, slice_elems)
from .batch import batched, broadcast_leading
from .kahan import kahan_sum, kahan_dot, two_sum

__all__ = [
    "array", "asarray", "tabulate", "zip_elems", "concat", "stack",
    "map_elems", "reduce_elems", "slice_elems",
    "batched", "broadcast_leading", "kahan_sum", "kahan_dot", "two_sum",
]
