"""SVD facade, the counterpart of ``nd4js_tpu/la/svd.py``: the default
SVD, numerical rank, square solve and minimum-norm least squares by the
rank-truncated pseudo-inverse.

``svd_decomp``'s 'auto' routes min(M, N) ≥ 128 to the simultaneous-rotation
``svd_gram`` and smaller inputs to the one-sided Jacobi of ``svd_jac``
(the ``jacobi_sweeps`` kernel); 'blocked' and 'dc' name the block Jacobi
of ``svd_block_jac`` and the divide-and-conquer of ``svd_dc``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..convert import as_tensor
from ..core.batch import batched
from ..core.mm import mm, mt
from .singular_matrix_solve_error import SingularMatrixSolveError
from .svd_block_jac import svd_jac_blocked
from .svd_dc import svd_dc
from .svd_gram import svd_gram
from .svd_jac import svd_jac_1sided
from .urv import urv_decomp_full, urv_lstsq

__all__ = ["svd_decomp", "svd_rank", "svd_solve", "svd_lstsq", "rank",
           "lstsq"]


def svd_decomp(a, method: str = "auto", device=None, **kw):
    """Default SVD: A = U·diag(sv)·V, batched over leading dims.

    method: 'auto' (min(M, N) ≥ 128 goes to 'gram', smaller inputs to
    'jacobi'), 'jacobi' (one-sided Jacobi, the ``jacobi_sweeps`` kernel),
    'gram' (simultaneous rotations, GEMMs), 'blocked' (block Jacobi,
    ``svd_jac_blocked``) or 'dc' (divide and conquer on the bidiagonal,
    ``svd_dc``). Keywords pass to the chosen method. An array-like ``a``
    goes to ``device`` (default ``config.default_device``)."""
    if method == "auto":
        shape = np.shape(a)
        big = len(shape) >= 2 and min(shape[-2:]) >= 128
        method = "gram" if big else "jacobi"
    if method == "jacobi":
        return svd_jac_1sided(a, device=device, **kw)
    if method == "gram":
        return svd_gram(a, device=device, **kw)
    if method == "blocked":
        return svd_jac_blocked(a, device=device, **kw)
    if method == "dc":
        return svd_dc(a, device=device, **kw)
    raise ValueError(f"unknown method {method!r}")


def svd_rank(sv, tol=None, device=None):
    """Numerical rank from descending singular values:
    #{i : sv_i > tol·sv₀}, tol = √eps by default. int32."""
    sv = as_tensor(sv, device)
    if tol is None:
        tol = float(np.sqrt(torch.finfo(sv.dtype).eps))
    return (sv > tol * sv[..., :1]).sum(-1).to(torch.int32)


@batched((2, 1, 2, 2))
def _svd_lstsq(u, sv, v, y, rcond):
    live = sv > rcond * sv[..., :1]
    inv = torch.where(live, 1 / torch.where(sv == 0, 1.0, sv), 0.0)
    return mm(mt(v), mm(mt(u), y) * inv[..., :, None])


def svd_lstsq(u, sv, v, y, rcond=None, device=None):
    """Minimum-norm least squares by the truncated pseudo-inverse,
    x = Vᵀ·diag(1/sv_trunc)·Uᵀ·y, dropping sv ≤ rcond·sv₀ (rcond = √eps
    by default). Leading dims broadcast; sv, v and y go to u's device."""
    u = as_tensor(u, device)
    sv, v, y = (as_tensor(t, u.device) for t in (sv, v, y))
    y = y.to(u.dtype)
    if rcond is None:
        rcond = float(np.sqrt(torch.finfo(u.dtype).eps))
    return _svd_lstsq(u, sv, v, y, rcond)


def svd_solve(u, sv, v, y, device=None):
    """Square solve from an SVD; raises SingularMatrixSolveError, carrying
    the truncated solution, when any matrix's rank is below n."""
    x = svd_lstsq(u, sv, v, y, device=device)
    r = svd_rank(sv, device=x.device)
    if bool((r < np.shape(v)[-1]).any()):
        raise SingularMatrixSolveError(x)
    return x


def rank(a, tol=None, device=None):
    """Numerical rank of A: ``svd_rank`` of ``svd_decomp``'s sv."""
    _, sv, _ = svd_decomp(a, device=device)
    return svd_rank(sv, tol=tol)


def lstsq(a, y, rcond=None, method: str = "svd", device=None):
    """Minimum-norm least squares. method 'svd' (the default):
    ``svd_decomp`` then ``svd_lstsq``; 'urv': the complete orthogonal
    decomposition, the same minimum-norm solution (``rcond`` does not
    apply: the strong RRQR decides the rank)."""
    if method == "urv":
        u, r, v, rk = urv_decomp_full(a, device=device)
        return urv_lstsq(u, r, v, rk, y)
    if method != "svd":
        raise ValueError(f"unknown method {method!r}")
    u, sv, v = svd_decomp(a, device=device)
    return svd_lstsq(u, sv, v, y, rcond=rcond)
