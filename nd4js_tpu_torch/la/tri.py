"""Triangular extractors, inversion and solves, the counterpart of
``nd4js_tpu/la/tri.py``: ``tril``/``triu``, ``_tril_inv_core`` and
``tri_inv`` (log-depth nilpotent product), and the solves by three
methods:

  * ``"block"`` (the default): blocked substitution, all diagonal-block
    inverses in one batched GEMM tree (``_tril_solve_blocked``,
    ``_triu_solve_blocked``);
  * ``"scan"``: row-by-row substitution, the classical algorithm and the
    accuracy reference (``_tril_solve_scan``, a Python loop over rows
    where the JAX package has a ``lax.scan``);
  * ``"inv"``: one GEMM with the explicit inverse.

All work is batched tensor code (``core.mm``); no triangular-solve
library call stands in for it. ``_tril_solve.core`` and
``_triu_solve.core`` solve on tensors of one leading batch axis (or none)
without the public wrappers' conversions, where the JAX package calls
``triu_solve.core``.
"""
from __future__ import annotations

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core.batch import batched
from ..core.debug import dcheck_finite
from ..core.mm import mm

__all__ = ["tril", "triu", "tri_inv", "tril_solve", "triu_solve",
           "tril_t_solve", "triu_t_solve"]


def tril(a, k: int = 0, device=None) -> torch.Tensor:
    """Lower-triangular part. An array-like ``a`` goes to ``device``
    (default ``config.default_device``)."""
    return torch.tril(as_tensor(a, device), k)


def triu(a, k: int = 0, device=None) -> torch.Tensor:
    """Upper-triangular part. An array-like ``a`` goes to ``device``
    (default ``config.default_device``)."""
    return torch.triu(as_tensor(a, device), k)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _tril_inv_core(L: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of lower-triangular ``L`` (..., n, n).

    L = (I + M)·D with D = diag(L) and M = (L − D)·D⁻¹ strictly lower
    (so Mⁿ = 0), hence L⁻¹ = D⁻¹·(I + M)⁻¹ with
    (I + M)⁻¹ = (I − M)(I + M²)(I + M⁴)···, ⌈log₂ n⌉ factors, then one
    Newton–Schulz polish X ← X·(2I − L·X). Above 128, block columns of
    128 invert their diagonal blocks this way and combine by block
    forward substitution (``nd4js_tpu/la/tri.py:47-110``).
    """
    n = L.shape[-1]
    if n > 128:
        b = 128
        rows = []
        eye_n = _eye(n, L)
        lead = L.shape[:-2]
        for k in range(0, n, b):
            e = min(k + b, n)
            dinv = _tril_inv_core(L[..., k:e, k:e])
            rhs = eye_n[k:e].expand(lead + (e - k, n))
            if k > 0:
                rhs = rhs - mm(L[..., k:e, :k], torch.cat(rows, dim=-2))
            rows.append(mm(dinv, rhs))
        return torch.cat(rows, dim=-2)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    dinv = 1.0 / d
    if n == 1:
        return dinv[..., None]
    M = torch.tril(L, -1) * dinv[..., None, :]
    eye = _eye(n, L)
    X = eye - M
    S = M
    span = 2          # X matches the Neumann series through M^(span-1)
    while span < n:
        S = mm(S, S)
        X = X + mm(X, S)
        span *= 2
    X = X * dinv[..., :, None]
    # the telescoped product is exact per factor but loses ~√n·eps
    # componentwise across factors; one polish squares that residual
    X = X + mm(X, eye - mm(L, X))
    return torch.tril(X)


def tri_inv(a, lower: bool = True, device=None) -> torch.Tensor:
    """Inverse of a triangular matrix (..., n, n), batched over leading
    dims. An array-like ``a`` goes to ``device`` (default
    ``config.default_device``)."""
    a = as_tensor(a, device)
    a = a.to(default_float_for(a.dtype))
    if lower:
        return _tril_inv_core(a)
    # reversing both axes makes U lower triangular
    return _tril_inv_core(a.flip(-2, -1)).flip(-2, -1)


def _tril_solve_scan(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Forward substitution row by row (``nd4js_tpu/la/tri.py:125-139``):
    x_i = (y_i − L[i, :]·x) / L[i, i], with the rows of x not yet solved
    still zero. L (..., n, n), y (..., n, K)."""
    n = L.shape[-2]
    lead = torch.broadcast_shapes(L.shape[:-2], y.shape[:-2])
    x = y.new_zeros(lead + y.shape[-2:])
    for i in range(n):
        li = L[..., i, :]                                   # (..., n)
        acc = mm(li[..., None, :], x)[..., 0, :]            # (..., K)
        x[..., i, :] = (y[..., i, :] - acc) / L[..., i, i, None]
    return x


def _diag_blocks(T: torch.Tensor, nb: int, b: int) -> torch.Tensor:
    """The nb diagonal b×b blocks of (..., nb·b, nb·b) as (..., nb, b, b)."""
    g = T.reshape(T.shape[:-2] + (nb, b, nb, b))
    return torch.diagonal(g, dim1=-4, dim2=-2).movedim(-1, -3)


def _pad_to_blocks(T: torch.Tensor, y: torch.Tensor, nb: int, block: int):
    """Broadcast T (..., n, n) and y (..., n, K) to one leading shape and
    pad them to nb·block rows: identity on T's new diagonal, zeros in y."""
    n = T.shape[-2]
    npad = nb * block - n
    lead = torch.broadcast_shapes(T.shape[:-2], y.shape[:-2])
    T = T.expand(lead + T.shape[-2:])
    y = y.expand(lead + y.shape[-2:])
    if npad:
        eye_pad = _eye(nb * block, T)[n:, :].expand(lead + (npad, nb * block))
        zeros = T.new_zeros(lead + (n, npad))
        T = torch.cat([torch.cat([T, zeros], -1), eye_pad], -2)
        y = torch.cat([y, y.new_zeros(lead + (npad, y.shape[-1]))], -2)
    return T, y


def _default_block(n: int) -> int:
    # nb ≈ 4 blocks: a constant number of steps at every size
    block = max(32, -(-n // 4))
    return -(-block // 32) * 32


def _tril_solve_blocked(L: torch.Tensor, y: torch.Tensor,
                        block: int | None = None) -> torch.Tensor:
    """Blocked forward substitution for lower-triangular ``L``
    (..., n, n): all diagonal-block inverses in one batched log-depth
    GEMM tree, then nb−1 steps of two GEMMs each
    (``nd4js_tpu/la/tri.py:151-187``)."""
    n = L.shape[-2]
    block = _default_block(n) if block is None else block
    if n <= block:
        return mm(_tril_inv_core(L), y)
    nb = -(-n // block)
    L, y = _pad_to_blocks(L, y, nb, block)
    dinv = _tril_inv_core(_diag_blocks(L, nb, block))   # (..., nb, b, b)
    xs = []
    for i in range(nb):
        rhs = y[..., i * block:(i + 1) * block, :]
        if i > 0:
            rhs = rhs - mm(L[..., i * block:(i + 1) * block, :i * block],
                           torch.cat(xs, dim=-2))
        xs.append(mm(dinv[..., i, :, :], rhs))
    return torch.cat(xs, dim=-2)[..., :n, :]


def _triu_solve_blocked(U: torch.Tensor, y: torch.Tensor,
                        block: int | None = None) -> torch.Tensor:
    """Blocked backward substitution for upper-triangular ``U``
    (..., n, n): all diagonal-block inverses in one batched log-depth
    GEMM tree, then nb−1 steps of two GEMMs each
    (``nd4js_tpu/la/tri.py:190-225``)."""
    n = U.shape[-2]
    block = _default_block(n) if block is None else block
    if n <= block:
        inv = _tril_inv_core(U.flip(-2, -1)).flip(-2, -1)
        return mm(inv, y)
    nb = -(-n // block)
    U, y = _pad_to_blocks(U, y, nb, block)
    d = _diag_blocks(U, nb, block).flip(-2, -1)
    dinv = _tril_inv_core(d).flip(-2, -1)               # (..., nb, b, b)
    xs = [None] * nb
    for i in range(nb - 1, -1, -1):
        rhs = y[..., i * block:(i + 1) * block, :]
        if i < nb - 1:
            xdone = torch.cat(xs[i + 1:], dim=-2)
            rhs = rhs - mm(U[..., i * block:(i + 1) * block,
                             (i + 1) * block:], xdone)
        xs[i] = mm(dinv[..., i, :, :], rhs)
    return torch.cat(xs, dim=-2)[..., :n, :]


def _solve_core(T: torch.Tensor, y: torch.Tensor, method: str,
                lower: bool = True) -> torch.Tensor:
    if method == "scan":
        if not lower:
            return _tril_solve_scan(T.flip(-2, -1), y.flip(-2)).flip(-2)
        return _tril_solve_scan(T, y)
    if method == "inv":
        if not lower:
            return mm(_tril_inv_core(T.flip(-2, -1)).flip(-2, -1), y)
        return mm(_tril_inv_core(T), y)
    if method == "block":
        return (_tril_solve_blocked if lower else _triu_solve_blocked)(T, y)
    raise ValueError(f"unknown method {method!r}")


def _operands(T, y, device):
    """T and y as tensors on one device (an array-like goes to ``device``,
    default ``config.default_device``), in their common floating dtype."""
    T, y = as_tensor(T, device), as_tensor(y, device)
    dtype = default_float_for(torch.promote_types(T.dtype, y.dtype))
    return T.to(dtype), y.to(dtype)


@batched((2, 2))
def _tril_solve(L: torch.Tensor, y: torch.Tensor, method: str = "block"):
    return _solve_core(L, y, method)


@batched((2, 2))
def _triu_solve(U: torch.Tensor, y: torch.Tensor, method: str = "block"):
    x = _solve_core(U, y, method, lower=False)
    dcheck_finite(x, "triu_solve x (singular diagonal?)")
    return x


def tril_solve(L, y, method: str = "block", device=None) -> torch.Tensor:
    """Solve L @ x = y with L lower-triangular (..., N, N), y (..., N, K);
    leading dims broadcast; ``method`` is "block", "scan" or "inv".
    Array-likes go to ``device`` (default ``config.default_device``)."""
    return _tril_solve(*_operands(L, y, device), method)


def triu_solve(U, y, method: str = "block", device=None) -> torch.Tensor:
    """Solve U @ x = y with U upper-triangular (..., N, N), y (..., N, K);
    leading dims broadcast; ``method`` is "block", "scan" or "inv".
    Array-likes go to ``device`` (default ``config.default_device``)."""
    return _triu_solve(*_operands(U, y, device), method)


def tril_t_solve(L, y, method: str = "block", device=None) -> torch.Tensor:
    """Solve Lᵀ @ x = y."""
    L, y = _operands(L, y, device)
    return _triu_solve(L.transpose(-1, -2), y, method)


def triu_t_solve(U, y, method: str = "block", device=None) -> torch.Tensor:
    """Solve Uᵀ @ x = y."""
    U, y = _operands(U, y, device)
    return _tril_solve(U.transpose(-1, -2), y, method)
