"""Cholesky decomposition and solve, the counterpart of
``nd4js_tpu/la/cholesky.py``: a half/half recursion that carries L⁻¹
beside L, so that trailing updates and downstream solves are GEMMs.

    L   = [[L11, 0], [L21, L22]],   L21 = A21·L11⁻ᵀ
    L⁻¹ = [[L11⁻¹, 0], [−L22⁻¹·L21·L11⁻¹, L22⁻¹]]

Leaves go to the ``chol_leaf`` kernel. Non-SPD input gives NaN (the
square root of a negative), not an exception; ``config.debug_checks``
turns that into a DebugCheckError at the public boundary.
"""
from __future__ import annotations

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core.debug import dassert, dcheck_finite
from ..core.mm import mm, mt
from ..ops.chol_leaf import LEAF, chol_leaf
from .tri import tril_solve, tril_t_solve

__all__ = ["cholesky_decomp", "cholesky_solve"]

_BASE = 16         # leaf width on the CPU, as the JAX package uses there


def _chol_rec(a: torch.Tensor, with_inv: bool, base: int | None = None):
    """(L, L⁻¹ or None) of ``a`` (..., n, n) by the half/half recursion
    (``nd4js_tpu/la/cholesky.py:90-152``).

    ``with_inv=False`` prunes what the caller does not need: the left
    child always takes its inverse (it whitens the panel,
    L21 = A21·L11⁻ᵀ), but the right spine and the off-diagonal inverse
    block do not.

    Leaf routing differs from the JAX package. There the Pallas leaf runs
    only off the CPU, and only for a flat batch ≤ 32 under a top n ≥ 256
    (``la/cholesky.py:111-126``), because the TPU grid serialises over
    the batch under the scoped-VMEM limit. That limit has no counterpart
    on an H100, where every block of the batch runs in parallel. So here
    EVERY leaf goes through ``ops.chol_leaf.chol_leaf``, which launches
    the kernel for a CUDA tensor and runs its plain version for a CPU one.
    ``base`` (the leaf width) defaults to 64, the kernel's widest, on the
    card, and to 16 on the CPU, the width the JAX package uses there;
    tests pass it to compare both widths with the JAX package's own
    ``_chol_inv_core(a, base=…)``.
    """
    if base is None:
        base = LEAF if a.is_cuda else _BASE
    return _chol_rec_inner(a, with_inv, base)


def _leaf(a: torch.Tensor, with_inv: bool):
    n = a.shape[-1]
    l, li = chol_leaf(a.reshape((-1, n, n)), with_inv)
    return l.reshape(a.shape), (None if li is None else li.reshape(a.shape))


def _chol_rec_inner(a: torch.Tensor, with_inv: bool, base: int):
    n = a.shape[-1]
    if n <= base:
        return _leaf(a, with_inv)
    m = n // 2
    l11, i11 = _chol_rec_inner(a[..., :m, :m], True, base)
    l21 = mm(a[..., m:, :m], mt(i11))
    l22, i22 = _chol_rec_inner(a[..., m:, m:] - mm(l21, mt(l21)),
                               with_inv, base)
    ztop = a.new_zeros(a.shape[:-2] + (m, n - m))
    L = torch.cat([torch.cat([l11, ztop], -1), torch.cat([l21, l22], -1)],
                  -2)
    if not with_inv:
        return L, None
    i21 = -mm(i22, mm(l21, i11))
    Li = torch.cat([torch.cat([i11, ztop], -1), torch.cat([i21, i22], -1)],
                   -2)
    return L, Li


def _chol_core(a: torch.Tensor) -> torch.Tensor:
    """Cholesky factor L for arbitrary leading dims."""
    return _chol_rec(a, False)[0]


def _chol_inv_core(a: torch.Tensor, base: int | None = None):
    """(L, L⁻¹): the inverse rides along the recursion, so downstream
    triangular solves become GEMMs."""
    return _chol_rec(a, True, base)


def cholesky_decomp(a, inv: bool = False, device=None):
    """Lower Cholesky factor L with A = L·Lᵀ, batched over leading dims.
    Only the lower triangle of A is read.

    ``inv=True`` also returns L⁻¹, computed inside the recursion (two
    extra GEMMs per node); pass it to :func:`cholesky_solve` to make each
    solve two GEMMs. An array-like ``a`` goes to ``device`` (default
    ``config.default_device``)."""
    a = as_tensor(a, device)
    a = a.to(default_float_for(a.dtype))
    if a.ndim < 2:
        raise ValueError("cholesky_decomp expects ndim >= 2")
    l, li = _chol_rec(a, inv)
    dcheck_finite(l, "cholesky_decomp L")
    dassert(torch.diagonal(l, dim1=-2, dim2=-1) > 0,
            "cholesky_decomp: non-positive pivot (input not SPD?)")
    return (l, li) if inv else l


def cholesky_solve(l, y, l_inv=None, device=None):
    """Solve A @ x = y given L from :func:`cholesky_decomp`. With
    ``l_inv`` (from ``cholesky_decomp(a, inv=True)``) the solve is two
    GEMMs, x = L⁻ᵀ·(L⁻¹·y); without it, two blocked triangular solves.
    Leading dims broadcast."""
    y = as_tensor(y, device)
    if l_inv is not None:
        l_inv = as_tensor(l_inv, device)
        y = y.to(l_inv.dtype)
        return mm(mt(l_inv), mm(l_inv, y))
    l = as_tensor(l, device)
    z = tril_solve(l, y.to(l.dtype))
    return tril_t_solve(l, z)
