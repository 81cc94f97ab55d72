"""Leading-dimension broadcasting, the counterpart of
``nd4js_tpu/core/batch.py``.

``batched(core_ndims)`` lifts a function written for fixed trailing
ranks to arbitrary broadcastable leading dims: the wrapper broadcasts
the leading shapes together, flattens them into ONE batch axis, calls
the function once, and restores the leading shape on every output.
Where JAX used ``vmap``, the port's core functions take that explicit
batch axis themselves (they index with ``...``), so no per-matrix loop
runs. Zero leading dims call the core function on the bare matrices.
"""
from __future__ import annotations

import functools
import math

import torch

__all__ = ["batched", "broadcast_leading"]


def broadcast_leading(arrays, core_ndims):
    """Broadcast the leading (batch) dims of ``arrays`` against each other.

    ``core_ndims[i]`` trailing dims of ``arrays[i]`` are the core shape
    and are left untouched. Returns (broadcast_arrays, batch_shape).
    """
    lead_shapes = []
    for a, c in zip(arrays, core_ndims):
        if a.ndim < c:
            raise ValueError(
                f"operand has ndim {a.ndim}, needs at least {c} core dims")
        lead_shapes.append(a.shape[: a.ndim - c])
    bshape = tuple(torch.broadcast_shapes(*lead_shapes))
    out = [a.expand(bshape + a.shape[a.ndim - c:])
           for a, c in zip(arrays, core_ndims)]
    return out, bshape


def _restore(out, bshape):
    if isinstance(out, torch.Tensor):
        return out.reshape(bshape + out.shape[1:])
    return type(out)(_restore(o, bshape) for o in out)


def batched(core_ndims, n_array_args=None):
    """Decorator: lift a core function to broadcast leading dims.

    ``core_ndims`` gives the trailing core rank of each positional
    tensor argument; the first ``n_array_args`` (default
    ``len(core_ndims)``) positional args are tensors, the rest pass
    through. The core function is exposed as ``wrapper.core``.
    """
    core_ndims = tuple(core_ndims)
    n_arr = len(core_ndims) if n_array_args is None else n_array_args

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            arrs, rest = list(args[:n_arr]), args[n_arr:]
            arrs, bshape = broadcast_leading(arrs, core_ndims)
            if bshape == ():
                return f(*arrs, *rest, **kwargs)
            nbatch = math.prod(bshape)
            flat = [a.reshape((nbatch,) + a.shape[len(bshape):])
                    for a in arrs]
            return _restore(f(*flat, *rest, **kwargs), bshape)

        wrapper.core = f
        return wrapper

    return deco
