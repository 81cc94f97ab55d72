"""Utilities, the counterpart of ``nd4js_tpu/utils/``: geometry
(``regular_simplex``), iteration helpers, k-nearest neighbours
(``KDTree``), fixed-step RK4 integration and plain-array helpers."""
from .geom import regular_simplex
from .iter import (linspace, irange, cartesian_prod, repeat,
                   argmin, argmax, imin, imax)
from .spatial import KDTree
from .integrate import rk4_step, odeint_rk4
from .arrays import (binary_search, binary_rangesearch, heap_sort_gen,
                     shuffle, is_array, Comparator, checked_array)

__all__ = ["regular_simplex", "linspace", "irange", "cartesian_prod",
           "repeat", "argmin", "argmax", "imin", "imax", "KDTree",
           "rk4_step", "odeint_rk4", "binary_search", "binary_rangesearch",
           "heap_sort_gen", "shuffle", "is_array", "Comparator",
           "checked_array"]
