"""LU decomposition with partial pivoting, the counterpart of
``nd4js_tpu/la/lu.py``: a blocked right-looking factorisation whose
panels go to the ``lu_panel`` kernel, with the U block and the trailing
update as GEMMs, and a fused factor-and-solve through the ``lu_gesv``
kernel.

Conventions, as in the JAX package:
  * ``lu_decomp(A) -> (LU, P)`` with ``A[..., P, :] = L @ U``: LU packs
    unit-lower L below the diagonal and U on and above it; P is an int32
    row-permutation vector of length M.
  * Singular pivots do not raise: a zero pivot gives a zero L column and
    a zero U diagonal, and the solves then give inf/nan.
"""
from __future__ import annotations

import math

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core.debug import dcheck_finite
from ..core.mm import mm
from ..ops.lu_panel import lu_gesv, lu_panel
from .tri import _tril_inv_core, _tril_solve_blocked, _triu_solve_blocked

__all__ = ["lu_decomp", "lu_solve", "lu_solve_fused"]

_PANEL = 128


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x (B, R, C) in the order idx (B, R)."""
    return torch.gather(x, 1, idx[:, :, None].expand(x.shape))


def _lu_core_batched(a: torch.Tensor):
    """Blocked LU of a (B, M, N) batch → (LU, P (B, M) int32)
    (``nd4js_tpu/la/lu.py:44-75``)."""
    Bn, M, N = a.shape
    K = min(M, N)
    a = a.clone()
    perm = torch.arange(M, dtype=torch.int64, device=a.device).repeat(Bn, 1)
    for k in range(0, K, _PANEL):
        b = min(_PANEL, K - k)
        praw, rank = lu_panel(a[:, k:, k:k + b].contiguous())
        # rows come back in input order; (rank, original index) sorts
        # them into the LAPACK-packed layout: the pivots by step, then
        # the rows never pivoted in their original order
        mk = M - k
        iota = torch.arange(mk, device=a.device)
        pperm = torch.argsort(rank.to(torch.int64) * mk + iota, dim=1)
        bottom = _gather_rows(a[:, k:], pperm)
        bottom[:, :, k:k + b] = _gather_rows(praw, pperm)
        perm[:, k:] = torch.gather(perm[:, k:], 1, pperm)
        if k + b < N:
            eye = torch.eye(b, dtype=a.dtype, device=a.device)
            l_kk = torch.tril(bottom[:, :b, k:k + b], -1) + eye
            u_top = mm(_tril_inv_core(l_kk), bottom[:, :b, k + b:])
            bottom[:, b:, k + b:] -= mm(bottom[:, b:, k:k + b], u_top)
            bottom[:, :b, k + b:] = u_top
        a[:, k:] = bottom
    return a, perm.to(torch.int32)


def lu_decomp(a, device=None):
    """Packed LU with partial pivoting, batched over leading dims.

    Returns (LU, P): LU (..., M, N) packs unit-L below the diagonal and U
    on and above it; P (..., M) int32 with A[..., P, :] = L @ U. An
    array-like ``a`` goes to ``device`` (default
    ``config.default_device``)."""
    a = as_tensor(a, device)
    a = a.to(default_float_for(a.dtype))
    if a.ndim < 2:
        raise ValueError("lu_decomp expects ndim >= 2")
    lead = a.shape[:-2]
    m, n = a.shape[-2:]
    lu, p = _lu_core_batched(a.reshape((max(1, math.prod(lead)), m, n)))
    return lu.reshape(lead + (m, n)), p.reshape(lead + (m,))


def lu_solve_fused(a, y, device=None):
    """Solve A @ x = y by partial-pivot LU, the factorisation and both
    substitutions in ONE launch of the ``lu_gesv`` kernel for square
    systems with N ≤ 128; larger N falls back to ``lu_decomp`` +
    ``lu_solve``. Same results as ``lu_solve(*lu_decomp(a), y)`` up to
    rounding. ``y`` may be (..., N) or (..., N, K); leading dims
    broadcast."""
    a, y = as_tensor(a, device), as_tensor(y, device)
    a = a.to(default_float_for(a.dtype))
    y = y.to(a.dtype)
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError("lu_solve_fused expects square (..., N, N)")
    squeeze = y.ndim == 1 or y.ndim == a.ndim - 1
    if squeeze:
        y = y[..., None]
    n = a.shape[-1]
    lead = tuple(torch.broadcast_shapes(a.shape[:-2], y.shape[:-2]))
    a = a.expand(lead + a.shape[-2:])
    y = y.expand(lead + y.shape[-2:])
    if n > _PANEL:
        x = lu_solve(*lu_decomp(a), y)
    else:
        k = y.shape[-1]
        bn = max(1, math.prod(lead))
        x = lu_gesv(a.reshape((bn, n, n)).contiguous(),
                    y.reshape((bn, n, k)).contiguous()).reshape(lead + (n, k))
        dcheck_finite(x, "lu_solve_fused x")
    return x[..., 0] if squeeze else x


def lu_solve(lu, p, y, device=None):
    """Solve A @ x = y given (LU, P) from :func:`lu_decomp`: permute y,
    then blocked forward and backward substitution (all diagonal-block
    inverses in one batched GEMM tree per triangle). Leading dims
    broadcast."""
    lu, y = as_tensor(lu, device), as_tensor(y, device)
    p = as_tensor(p, device).to(torch.int64)
    y = y.to(lu.dtype)
    n = lu.shape[-1]
    lead = tuple(torch.broadcast_shapes(lu.shape[:-2], p.shape[:-1],
                                        y.shape[:-2]))
    lu = lu.expand(lead + lu.shape[-2:])
    p = p.expand(lead + p.shape[-1:])
    y = y.expand(lead + y.shape[-2:])
    yp = torch.gather(y, -2, p[..., None].expand(lead + (p.shape[-1],
                                                         y.shape[-1])))
    eye = torch.eye(n, dtype=lu.dtype, device=lu.device)
    z = _tril_solve_blocked(torch.tril(lu, -1) + eye, yp)
    x = _triu_solve_blocked(torch.triu(lu), z)
    dcheck_finite(x, "lu_solve x")
    return x
