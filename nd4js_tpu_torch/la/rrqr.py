"""Rank-revealing (column-pivoted) QR, the counterpart of the batched path
of ``nd4js_tpu/la/rrqr.py``.

The pivoted factorisation is one call of the ``rrqr_kernel`` kernel
(norms downdated after each reflector); Q is rebuilt from its reflectors
by compact-WY panels of 128, applied in reverse (GEMMs). Rank-aware
solves are masked rather than cut: rows and columns at index ≥ rank are
replaced by the identity before the triangular solve and the solution
is zeroed there after, which gives the reference's "zero the trailing
rows" answer with fixed shapes.

The single-matrix path that the optimisers and the strong RRQR call
(``_rrqr_factor``, ``_build_q``, ``_rrqr_core``;
``nd4js_tpu/la/rrqr.py:43-105``, ``:149-155``) recomputes the exact
trailing column norms at every step, a different pivot rule from the
kernel's downdate, so it does not go through the kernel: it is plain
tensor code, as the JAX package builds it in XLA.
"""
from __future__ import annotations

import math

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core.batch import batched
from ..core.mm import mm, mt
from ..ops.rrqr_kernel import rrqr_kernel
from .permute import unpermute_rows
from .qr import _form_t, _form_t_batched
from .singular_matrix_solve_error import SingularMatrixSolveError
from .tri import _triu_solve

__all__ = ["rrqr_decomp", "rrqr_decomp_full", "rrqr_rank", "rrqr_solve",
           "rrqr_lstsq"]

_PANEL = 128


def _rrqr_factor(a: torch.Tensor):
    """Column-pivoted Householder factorisation of one matrix (M, N), the
    exact trailing column norms recomputed at every step and the first
    of equal norms taken. Returns (R_packed, V, taus, perm) with
    A[:, perm] = Q·R."""
    M, N = a.shape
    K = min(M, N)
    dev = a.device
    rows = torch.arange(M, device=dev)
    colv = torch.arange(N, device=dev)
    V = a.new_zeros((M, K))
    taus = a.new_zeros((K,))
    perm = torch.arange(N, dtype=torch.int32, device=dev)
    for j in range(K):
        # exact trailing column norms over rows >= j
        nrm2 = torch.where(rows[:, None] >= j, a * a, 0.0).sum(0)
        p = torch.argmax(torch.where(colv >= j, nrm2, -torch.inf))
        # swap columns j <-> p
        swap = torch.where(colv == j, p, torch.where(colv == p, j, colv))
        a = a[:, swap]
        perm = perm[swap]
        # Householder on column j, rows >= j
        x = a[:, j]
        x0 = x[j]
        sigma = torch.where(rows > j, x * x, 0.0).sum()
        nrm = torch.sqrt(x0 * x0 + sigma)
        beta = torch.where(x0 >= 0, -nrm, nrm)
        den = x0 - beta
        safe_den = torch.where(den == 0, 1.0, den)
        v = torch.where(rows > j, x / safe_den, 0.0)
        v = torch.where(rows == j, 1.0, v)
        safe_beta = torch.where(beta == 0, 1.0, beta)
        tau = torch.where(nrm == 0, 0.0, (beta - x0) / safe_beta)
        w = torch.where(colv > j, tau * mm(v[None], a)[0], 0.0)
        a = a - v[:, None] * w[None, :]
        newc = torch.where(rows == j, beta, 0.0)
        newc = torch.where(rows < j, a[:, j], newc)
        a = torch.cat([a[:, :j], newc[:, None], a[:, j + 1:]], 1)
        V[:, j] = v
        taus[j] = tau
    return a, V, taus, perm


def _build_q(V: torch.Tensor, taus: torch.Tensor, ncols: int):
    """Q (M, ncols) of one matrix from its stored reflectors by
    compact-WY panels of 128, applied in reverse (GEMMs)."""
    M, K = V.shape
    B = torch.eye(M, ncols, dtype=V.dtype, device=V.device)
    for k in reversed(range(0, K, _PANEL)):
        b = min(_PANEL, K - k)
        Vp = V[k:, k:k + b]
        T = _form_t(Vp, taus[k:k + b])
        sub = B[k:, :]
        B = torch.cat([B[:k], sub - mm(Vp, mm(T, mm(mt(Vp), sub)))], 0)
    return B


def _rrqr_core(a: torch.Tensor, economic: bool):
    """Column-pivoted QR of one matrix by :func:`_rrqr_factor`:
    (Q, R, perm) with A[:, perm] = Q·R."""
    M, N = a.shape
    K = min(M, N)
    r, V, taus, perm = _rrqr_factor(a)
    q = _build_q(V, taus, K if economic else M)
    return q, torch.triu(r[:K] if economic else r), perm


def _rrqr_assemble(r, V, taus, perm, economic: bool):
    """(Q, R, perm) from the kernel's factorisation of a flat batch: Q is
    H_0···H_{K−1} applied to the first ``ncols`` columns of I by
    compact-WY panels in reverse (``nd4js_tpu/la/rrqr.py:108-129``)."""
    Bn, M, N = r.shape
    K = min(M, N)
    ncols = K if economic else M
    B = torch.eye(M, ncols, dtype=r.dtype, device=r.device).repeat(Bn, 1, 1)
    for k in reversed(range(0, K, _PANEL)):
        b = min(_PANEL, K - k)
        Vp, T = _form_t_batched(V[:, k:, k:k + b], taus[:, k:k + b])
        sub = B[:, k:, :]
        sub -= mm(Vp, mm(T, mm(mt(Vp), sub)))
    return B, torch.triu(r[:, :K] if economic else r), perm


def _rrqr_public(a, economic: bool, device):
    a = as_tensor(a, device)
    a = a.to(default_float_for(a.dtype))
    if a.ndim < 2:
        raise ValueError("rrqr_decomp expects ndim >= 2")
    lead = a.shape[:-2]
    M, N = a.shape[-2:]
    a3 = a.reshape((max(1, math.prod(lead)), M, N))
    q, r, perm = _rrqr_assemble(*rrqr_kernel(a3), economic)
    return (q.reshape(lead + q.shape[-2:]),
            r.reshape(lead + (r.shape[-2], N)), perm.reshape(lead + (N,)))


def rrqr_decomp(a, device=None):
    """Economic column-pivoted QR: A[:, P] = Q·R. Returns (Q (..., M, K),
    R (..., K, N), P (..., N) int32). An array-like ``a`` goes to
    ``device`` (default ``config.default_device``)."""
    return _rrqr_public(a, True, device)


def rrqr_decomp_full(a, device=None):
    """Full column-pivoted QR: Q (..., M, M), R (..., M, N)."""
    return _rrqr_public(a, False, device)


def rrqr_rank(r, tol=None, device=None):
    """Numerical rank from the R factor: #{i : |R_ii| > tol·|R_00|}, tol =
    eps·max(M, N) by default. int32."""
    r = as_tensor(r, device)
    m, n = r.shape[-2:]
    if tol is None:
        tol = torch.finfo(r.dtype).eps * max(m, n)
    d = torch.diagonal(r, dim1=-2, dim2=-1).abs()
    thresh = tol * torch.clamp(d[..., :1], min=torch.finfo(r.dtype).tiny)
    return (d > thresh).sum(-1).to(torch.int32)


def _masked_r_solve(r, qty, rank):
    """Solve R[:rank, :rank]·z = qty[:rank] with zeros elsewhere, for each
    matrix of the batch its own rank."""
    k = r.shape[-2]
    live = torch.arange(k, device=r.device) < rank[..., None]
    eye = torch.eye(k, dtype=r.dtype, device=r.device)
    r_m = torch.where(live[..., :, None] & live[..., None, :],
                      r[..., :k, :k], eye)
    rhs = torch.where(live[..., :, None], qty, 0.0)
    z = _triu_solve.core(r_m, rhs, "block")
    return torch.where(live[..., :, None], z, 0.0)


@batched((2, 2, 1, 2))
def _rrqr_lstsq_core(q, r, perm, y):
    k = min(r.shape[-2:])
    n = r.shape[-1]
    z = _masked_r_solve(r[..., :k, :], mm(mt(q[..., :k]), y), rrqr_rank(r))
    if n > k:
        z = torch.cat([z, z.new_zeros(z.shape[:-2] + (n - k, z.shape[-1]))],
                      -2)
    return unpermute_rows(z, perm)


def rrqr_lstsq(q, r, perm, y, device=None):
    """Rank-aware least squares: the minimum-residual solution with the
    rank-deficient trailing directions zeroed. Leading dims broadcast; r,
    perm and y go to q's device."""
    q = as_tensor(q, device)
    r, perm, y = (as_tensor(t, q.device) for t in (r, perm, y))
    return _rrqr_lstsq_core(q, r, perm, y.to(q.dtype))


def rrqr_solve(q, r, perm, y, device=None):
    """Square-system solve; raises SingularMatrixSolveError, carrying the
    masked solution, when R is numerically singular."""
    n = r.shape[-1]
    if r.shape[-2] < n:
        raise ValueError("rrqr_solve requires a square system")
    x = rrqr_lstsq(q, r, perm, y, device=device)
    if bool((rrqr_rank(r, device=x.device) < n).any()):
        raise SingularMatrixSolveError(x)
    return x
