"""ND-array core: creation, elementwise zip, concat/stack, slicing — the
counterpart of ``nd4js_tpu/core/ndarray.py``.

Arrays are plain ``torch.Tensor``; element access ``a(i, j)`` is
``a[i, j]``. ``zip_elems`` is an n-ary broadcasting map that applies its
mapper to whole tensors, ``tabulate`` evaluates an index function on
broadcast int32 index grids, ``slice_elems`` takes the reference's
syntax (ints, ``[start, end, step]`` triples, ``'new'``, ``'...'``) and
``reduce_elems`` folds with a binary reducer.

Every routine accepts an optional ``dtype`` (a name of
``dt.ARRAY_TYPES``, a torch dtype or a numpy one). Host data (lists,
scalars, numpy arrays) goes to ``device`` (default
``config.default_device``); tensors keep theirs.
"""
from __future__ import annotations

import operator
from typing import Callable

import numpy as np
import torch

from .. import config, dt

__all__ = [
    "array", "asarray", "tabulate", "zip_elems", "concat", "stack",
    "map_elems", "reduce_elems", "slice_elems",
]

# integer and bool types that array() stores as int32
_INTS = (torch.int64, torch.int32, torch.int16, torch.int8, torch.bool)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def _resolve_dtype(dtype):
    if dtype is None:
        return None
    if isinstance(dtype, str):
        if dtype not in dt.ARRAY_TYPES:
            raise ValueError(
                f"Invalid dtype '{dtype}'. Must be one of "
                f"{sorted(dt.ARRAY_TYPES)}.")
        return dt.ARRAY_TYPES[dtype]
    return _torch_dtype(dtype)


def _inferred(dtype: torch.dtype) -> torch.dtype:
    """What :func:`array` stores a value of ``dtype`` as: float64 becomes
    ``config.default_float``, integers and bools int32, complex128
    complex64 under a float32 default; other types stay."""
    if dtype == torch.float64:
        return config.default_float
    if dtype in _INTS:
        return torch.int32
    if dtype == torch.complex128 and config.default_float == torch.float32:
        return torch.complex64
    return dtype


def _from_host(a: np.ndarray, dtype, device) -> torch.Tensor:
    """A copy of ``a`` as a tensor on ``device``, cast to ``dtype`` (None
    keeps its own) on the host before it is moved."""
    a = np.asarray(a, dtype=a.dtype.newbyteorder("="), order="C")
    t = torch.tensor(a) if dtype is None else torch.tensor(a).to(dtype)
    return t.to(config.default_device if device is None else device)


def _as_out(v, device) -> torch.Tensor:
    """What an index function or a mapper returned, as a tensor: numpy
    arrays keep their dtype, Python values take torch's (as jnp.asarray
    takes jnp's)."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, np.ndarray):
        return _from_host(v, None, device)
    return torch.as_tensor(v, device=device)


def array(content, dtype=None, device=None) -> torch.Tensor:
    """A new tensor from (nested) sequences, scalars or arrays.

    Dtype inference as in the JAX package: Python and numpy float64
    become :data:`config.default_float` (float32), every integer type and
    bool int32, complex128 complex64 under a float32 default.
    """
    dtype = _resolve_dtype(dtype)
    if isinstance(content, torch.Tensor):
        return content.to(device=content.device if device is None
                          else device,
                          dtype=_inferred(content.dtype) if dtype is None
                          else dtype, copy=True)
    a = np.asarray(content)
    if dtype is None:
        dtype = _inferred(_torch_dtype(a.dtype))
    return _from_host(a, dtype, device)


def asarray(content, dtype=None, device=None) -> torch.Tensor:
    """Tensors and numpy arrays pass through with their dtype (converted
    only if ``dtype`` is given; numpy float64 stays float64), anything
    else is :func:`array`."""
    dtype = _resolve_dtype(dtype)
    if isinstance(content, torch.Tensor):
        t = content if device is None else content.to(device)
        return t if dtype is None else t.to(dtype)
    if isinstance(content, np.ndarray):
        return _from_host(content, dtype, device)
    return array(content, dtype=dtype, device=device)


def _lift_all(arrays, device):
    """Tensors as they are; host data on ``device``, or on the device of
    the first tensor among ``arrays`` when none is given."""
    if device is None:
        device = next((a.device for a in arrays
                       if isinstance(a, torch.Tensor)), None)
    return [a if isinstance(a, torch.Tensor) else asarray(a, device=device)
            for a in arrays]


def tabulate(shape, dtype=None, idx2val: Callable | None = None,
             device=None) -> torch.Tensor:
    """Build an array from an index function.

    ``idx2val`` receives one int32 index tensor per dimension, already
    broadcast to ``shape``, on ``device``, and computes the values on
    whole tensors:

        tabulate((3, 4), 'float32', lambda i, j: i * 10 + j)

    The two-argument form ``tabulate(shape, idx2val)`` is also accepted.
    """
    if idx2val is None and callable(dtype):
        dtype, idx2val = None, dtype
    if idx2val is None:
        raise TypeError("tabulate() requires an index function")
    shape = tuple(int(s) for s in shape)
    dtype = _resolve_dtype(dtype)
    device = config.default_device if device is None else device
    if len(shape) == 0:
        out = _as_out(idx2val(), device)
        return out.to(dtype) if dtype is not None else out
    nd = len(shape)
    grids = [torch.arange(s, dtype=torch.int32, device=device)
             .reshape([s if k == d else 1 for k in range(nd)]).expand(shape)
             for d, s in enumerate(shape)]
    out = _as_out(idx2val(*grids), device)
    out = out.broadcast_to(shape).contiguous()
    return out.to(dtype) if dtype is not None else out


def zip_elems(arrays, mapper: Callable | None = None, dtype=None,
              device=None) -> torch.Tensor:
    """N-ary elementwise map with full NumPy broadcasting.

    ``mapper`` receives the broadcast tensors and returns the result; it
    may be left out only when a single array is given.
    ``zip_elems([a, b], lambda x, y: x*y + 1)``.
    """
    if callable(arrays) and mapper is not None and not callable(mapper):
        arrays, mapper = mapper, arrays  # tolerate swapped order
    ts = _lift_all(arrays if isinstance(arrays, (list, tuple))
                   else [arrays], device)
    dtype = _resolve_dtype(dtype)
    shape = torch.broadcast_shapes(*[t.shape for t in ts])
    bs = [t.broadcast_to(shape) for t in ts]
    if mapper is None:
        if len(bs) != 1:
            raise TypeError("zip_elems() with multiple arrays requires a mapper")
        out = bs[0]
    else:
        out = _as_out(mapper(*bs), bs[0].device).broadcast_to(shape)
    return out.to(dtype) if dtype is not None else out


def _joined(arrays, dtype, device):
    ts = _lift_all(arrays, device)
    dtype = _resolve_dtype(dtype)
    if dtype is None:
        dtype = dt.super_dtype(*[t.dtype for t in ts])
    return [t.to(dtype) for t in ts]


def concat(arrays, axis: int = 0, dtype=None, device=None) -> torch.Tensor:
    """Concatenate along ``axis``, promoting to the least common dtype of
    ``dt.super_dtype``."""
    return torch.cat(_joined(arrays, dtype, device), dim=axis)


def stack(arrays, axis: int = 0, dtype=None, device=None) -> torch.Tensor:
    """Stack along a new ``axis``, promoting as :func:`concat`."""
    return torch.stack(_joined(arrays, dtype, device), dim=axis)


def map_elems(a, mapper: Callable, dtype=None, device=None) -> torch.Tensor:
    """Elementwise map; the mapper works on whole tensors."""
    return zip_elems([a], mapper, dtype=dtype, device=device)


# reducers with a one-call reduction (the JAX package's jnp functions);
# the value is the reduction over one axis or a tuple of them
def _prod(a, axis):
    for ax in sorted(axis, reverse=True):
        a = torch.prod(a, dim=ax)
    return a


_FAST = {torch.add: torch.sum, operator.add: torch.sum,
         torch.mul: _prod, operator.mul: _prod,
         torch.maximum: torch.amax, torch.minimum: torch.amin}


def reduce_elems(a, axes=None, reducer: Callable | None = None,
                 dtype=None, initial=None, device=None):
    """Reduce over ``axes`` (all when None) with a binary reducer.

    ``torch.add``, ``torch.mul``, ``torch.maximum`` and ``torch.minimum``
    (and ``operator.add``/``operator.mul``) take one reduction call; any
    other ``reducer(acc, x)`` is folded over the reduced elements in order,
    one call each (use only for small axes).
    """
    a = asarray(a, dtype=dtype, device=device)
    if reducer is None:
        raise TypeError("reduce_elems() requires a reducer")
    if axes is None:
        axes = tuple(range(a.ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    axes = tuple(sorted(ax % a.ndim for ax in axes))
    if reducer in _FAST:
        return _FAST[reducer](a, axes) if axes else a
    # generic fold: the reduced axes to the front, flattened
    perm = axes + tuple(i for i in range(a.ndim) if i not in axes)
    moved = a.permute(perm)
    red_size = int(np.prod([a.shape[i] for i in axes], dtype=np.int64))
    flat = moved.reshape((red_size,) + tuple(moved.shape[len(axes):]))
    if initial is None:
        acc, rest = flat[0], flat[1:]
    else:
        acc = torch.as_tensor(initial, dtype=a.dtype, device=a.device) \
            .broadcast_to(flat.shape[1:])
        rest = flat
    for x in rest:
        acc = reducer(acc, x)
    return acc


def _dims_taken(s) -> int:
    """Axes of the input that one index entry consumes."""
    if s is None:
        return 0
    if isinstance(s, torch.Tensor) and s.dtype == torch.bool or \
            isinstance(s, np.ndarray) and s.dtype == np.bool_:
        return s.ndim
    return 1


def slice_elems(a, *slices):
    """NumPy-style slicing with the reference's syntax.

    Accepted per-axis specifiers: an int (drops the axis), a Python
    ``slice``, a list/tuple ``[start, end, step]`` (entries may be None),
    ``'new'`` (inserts a length-1 axis) and ``'...'`` (Ellipsis). A
    negative step gives what NumPy gives: the axis is flipped and sliced
    with the positive step (torch refuses negative steps).
    """
    a = asarray(a)
    idx = []
    for s in slices:
        if s is Ellipsis or (isinstance(s, str) and s == "..."):
            idx.append(Ellipsis)
        elif isinstance(s, str) and s == "new":
            idx.append(None)
        elif isinstance(s, (list, tuple)):
            start, end, step = (list(s) + [None, None, None])[:3]
            idx.append(slice(start, end, step))
        else:
            idx.append(s)
    # the input axis of each entry, the Ellipsis spanning what is left
    fill = a.ndim - sum(_dims_taken(s) for s in idx if s is not Ellipsis)
    axis = 0
    for k, s in enumerate(idx):
        if s is Ellipsis:
            axis += fill
            continue
        if isinstance(s, slice) and s.step is not None and s.step < 0:
            n = a.shape[axis]
            r = range(*s.indices(n))
            a = a.flip(axis)
            start = n - 1 - r[0] if len(r) else 0
            idx[k] = slice(start, start + (len(r) - 1) * -s.step + 1
                           if len(r) else 0, -s.step)
        axis += _dims_taken(s)
    return a[tuple(idx)]
