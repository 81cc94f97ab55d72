"""Unpivoted LDLᵀ decomposition and solve, the counterpart of
``nd4js_tpu/la/ldl.py``: the half/half recursion of ``cholesky.py`` with
a diagonal D and no square roots, for symmetric matrices whose leading
minors are nonsingular (``pldlp.py`` pivots for the general case).

    L21 = A21·L11⁻ᵀ·D1⁻¹,   A22' = A22 − L21·D1·L21ᵀ

Leaves of n ≤ 16 run the unrolled column recurrence. Returns (L, d): L
unit lower triangular, d the diagonal of D.
"""
from __future__ import annotations

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core.mm import mm, mt
from .tri import _tril_inv_core, tril_solve, tril_t_solve

__all__ = ["ldl_decomp", "ldl_solve"]

_BASE = 16


def _ldl_base(a):
    """The column recurrence on (..., n, n), n ≤ 16
    (``nd4js_tpu/la/ldl.py:27-47``)."""
    n = a.shape[-1]
    cols = []
    ds = []
    for j in range(n):
        if j == 0:
            d = a[..., 0, 0]
            ds.append(d)
            cols.append(a[..., :, 0] / d[..., None])
        else:
            prev = torch.stack(cols, dim=-1)                  # (..., n, j)
            lj = prev[..., j, :]                              # (..., j)
            dvec = torch.stack(ds, dim=-1)                    # (..., j)
            acc = mm(prev, (lj * dvec)[..., None])[..., 0]
            col = a[..., :, j] - acc
            d = col[..., j]
            ds.append(d)
            cols.append(col / d[..., None])
    return torch.tril(torch.stack(cols, dim=-1)), torch.stack(ds, dim=-1)


def _ldl_core(a):
    n = a.shape[-1]
    if n <= _BASE:
        return _ldl_base(a)
    m = n // 2
    l11, d1 = _ldl_core(a[..., :m, :m])
    l21 = mm(a[..., m:, :m], mt(_tril_inv_core(l11))) / d1[..., None, :]
    a22 = a[..., m:, m:] - mm(l21 * d1[..., None, :], mt(l21))
    l22, d2 = _ldl_core(a22)
    top = torch.cat([l11, a.new_zeros(l11.shape[:-2] + (m, n - m))], -1)
    bot = torch.cat([l21, l22], -1)
    return torch.cat([top, bot], -2), torch.cat([d1, d2], -1)


def ldl_decomp(a, device=None):
    """A = L·D·Lᵀ with L unit lower triangular, batched over leading
    dims. Returns (L, d), d the diagonal of D. Only the lower triangle of
    A is read. An array-like ``a`` goes to ``device`` (default
    ``config.default_device``)."""
    a = as_tensor(a, device)
    return _ldl_core(a.to(default_float_for(a.dtype)))


def ldl_solve(l, d, y, device=None):
    """Solve A·x = y from (L, d) of :func:`ldl_decomp`; leading dims
    broadcast. Array-likes go to ``device`` (default
    ``config.default_device``), d and y to L's device."""
    l = as_tensor(l, device)
    d, y = as_tensor(d, l.device), as_tensor(y, l.device)
    z = tril_solve(l, y)
    z = z / d[..., :, None]
    return tril_t_solve(l, z)
