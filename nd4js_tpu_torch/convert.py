"""Carry state between the JAX package and the port, as numpy arrays.

The library has no learned weights: its state is the input arrays and a
factorisation: ``R_packed`` plus the list of ``(k, V, T)`` panels that
``la.qr._qr_factor_batched`` returns in both packages, or the
``(R_packed, V, taus, perm)`` of the ``rrqr_kernel`` in both; and the
optimisers' states, NamedTuples of the same fields in both packages
(``LsqState``, ``TlsState``, ``LBFGSState`` and the LM, ODR, dogleg and
L-BFGS drivers' states), given as numpy arrays, e.g.
``jax.tree.map(np.asarray, state)``.
"""
from __future__ import annotations

import typing

import numpy as np
import torch

from . import config

__all__ = ["as_tensor", "from_numpy", "rrqr_from_numpy", "vts_from_numpy",
           "state_from_numpy"]


def as_tensor(a, device=None) -> torch.Tensor:
    """A tensor for an entry point. A tensor keeps its device unless
    ``device`` is given; anything else is copied to ``device`` or, without
    one, to ``config.default_device``. Dtypes are kept (integers are
    promoted by the routines themselves)."""
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(device)
    return torch.tensor(np.asarray(a), device=(
        config.default_device if device is None else device))


def from_numpy(arr, device=None) -> torch.Tensor:
    """numpy array → tensor on ``device`` (default ``config.default_device``)
    with the port's dtype rule: integers and bools become float64, floats
    keep their precision."""
    t = as_tensor(np.asarray(arr), device)
    return t.to(config.default_float_for(t.dtype))


def vts_from_numpy(vts, device=None):
    """A ``[(k, V, T), ...]`` factorisation given as numpy arrays (e.g.
    ``np.asarray`` of the JAX package's ``_qr_factor_batched`` output)
    → the port's form, ``[(int k, tensor V, tensor T), ...]``."""
    return [(int(k), from_numpy(V, device), from_numpy(T, device))
            for k, V, T in vts]


def rrqr_from_numpy(r_packed, v, taus, perm, device=None):
    """A column-pivoted factorisation ``(R_packed, V, taus, perm)`` given as
    numpy arrays (e.g. ``np.asarray`` of the JAX package's ``rrqr_kernel``
    output) → tensors on ``device``: floats as :func:`from_numpy` gives
    them, ``perm`` kept an int32 tensor."""
    perm = torch.from_numpy(np.array(perm, dtype=np.int32)).to(
        config.default_device if device is None else device)
    return (from_numpy(r_packed, device), from_numpy(v, device),
            from_numpy(taus, device), perm)


def state_from_numpy(cls, state, device=None):
    """An optimiser's state as the port's NamedTuple ``cls`` (e.g.
    ``opt._trust_region.LsqState`` or ``opt.lm._LMState``) from the JAX
    package's state of the same fields in the same order, given as numpy
    arrays: integer fields (counters, slots) as int32 tensors, floating ones
    keeping their precision, and a field annotated with a NamedTuple state
    (``_LMState.st``, ``_MinState.mem``) converted the same way."""
    hints = typing.get_type_hints(cls)
    out = []
    for name, v in zip(cls._fields, state):
        sub = hints.get(name)
        if isinstance(sub, type) and issubclass(sub, tuple) \
                and hasattr(sub, "_fields"):
            out.append(state_from_numpy(sub, v, device))
            continue
        a = np.asarray(v)
        t = as_tensor(a, device)
        out.append(t.to(torch.int32) if a.dtype.kind in "iub" else t)
    return cls(*out)
