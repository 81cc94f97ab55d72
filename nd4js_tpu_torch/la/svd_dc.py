"""Divide-and-conquer SVD on the bidiagonal, never squared, the
counterpart of ``nd4js_tpu/la/svd_dc.py``.

Bidiagonalise (``bidiag``), then solve the Golub-Kahan (TGK) eigenproblem:
the permuted [[0, Bᵀ], [B, 0]] is a 2K×2K symmetric tridiagonal with a
zero diagonal and the off-diagonals (a₁, b₁, a₂, b₂, …, a_K); its
eigenpairs are ±σᵢ with eigenvectors interleaving v and u, solved by the
divide-and-conquer tridiagonal eigensolver (``tridiag_dc``). Each half of
an eigenvector must be balanced (‖u‖ = ‖v‖ = 1/√2) or one-sided (σ = 0);
any other column is a σ ≈ 0 mixture, which is zeroed and rebuilt by the
forced orthonormal completion (``svd_jac._complete_u``, ``house_panel``
on the card). One CholeskyQR pass (``chol_leaf`` on the card) restores
machine-eps orthogonality of both factors. The JAX package runs this per
matrix under ``vmap``; here the bidiagonalisation and the TGK solve run
over the whole batch.

One addition to the JAX package's rule: the completion is also forced
for a factor whose columns are not orthonormal within √eps. A σ ≈ 0
cluster of a rank-deficient float32 input, spread by the solver's
eps-jitter to gaps below eps·‖B‖, can give balanced halves that are near
duplicates of each other; the polish's Cholesky of their Gram then breaks
(NaN). Where the balance test already catches the cluster, or the
factor is orthonormal, this changes nothing.

And one to its σ: the TGK solver separates equal eigenvalues by an
eps-jitter that accumulates over a cluster, so the σ ≈ 0 cluster of a
rank-deficient input comes out as σ up to (cluster size)·8·eps·‖A‖, far
above zero in float32, and U·diag(σ)·V misses A by as much. Where a TGK
σ and the Rayleigh quotient |uᵢᵀ·A·vᵢ| of the final factors differ by
more than the quotient's own error, K·eps·σ₀, the TGK value is that
jitter, and the quotient takes its place (the columns then re-sorted).
Elsewhere the TGK σ stands, with its relative accuracy.
"""
from __future__ import annotations

import torch

from ..core.mm import mm, mt
from .bidiag import _bidiag_core
from .cholesky import _chol_core
from .svd_jac import _complete_u, _descending, _svd_entry
from .tri import _tril_inv_core
from .tridiag_dc import tridiag_eigh_dc

__all__ = ["svd_dc"]

_ISQ2 = 0.7071067811865476


def _orth_polish(q):
    """One CholeskyQR pass on a nearly orthogonal square batch: its Gram
    is ≈ I, so the Cholesky never breaks (``nd4js_tpu/la/svd_dc.py:
    33-42``)."""
    l = _chol_core(mm(mt(q), q))
    return mm(q, mt(_tril_inv_core(l)))


def _force(q, ok):
    """Per matrix: a column failed the balance test, or the columns of q
    are not orthonormal within √eps (see the module docstring)."""
    eye = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
    defect = (mm(mt(q), q) - eye).abs().amax((-2, -1))
    return (~ok).any(-1) | ~(defect <= torch.finfo(q.dtype).eps ** 0.5)


def _svd_dc_core(a):
    """(U, sv, V) of a batch (B, M, N) (``nd4js_tpu/la/svd_dc.py:45-102``,
    each matrix as its lane)."""
    B, M, N = a.shape
    if M < N:
        u, sv, v = _svd_dc_core(mt(a))
        return mt(v), sv, mt(u)
    ub, b, vb = _bidiag_core(a)          # b: (B, K, K) upper bidiagonal
    K = b.shape[-1]
    if K == 1:
        d = b[:, 0, 0]
        sgn = torch.where(d < 0, -1.0, 1.0)
        return ub * sgn[:, None, None], d.abs()[:, None], vb
    eps = torch.finfo(a.dtype).eps
    off = a.new_zeros((B, 2 * K - 1))
    off[:, 0::2] = torch.diagonal(b, 0, -2, -1)
    off[:, 1::2] = torch.diagonal(b, 1, -2, -1)
    w, y = tridiag_eigh_dc(a.new_zeros((B, 2 * K)), off)
    # the positive half (ascending w: the last K), descending
    sv = torch.clamp(w[:, K:].flip(-1), min=0.0)
    y = y[:, :, K:].flip(-1)                          # (B, 2K, K)
    v_t = y[:, 0::2, :]
    u_b = y[:, 1::2, :]
    # keep balanced or one-sided halves, zero the rest for the completion
    vn = torch.sqrt((v_t * v_t).sum(1))
    un = torch.sqrt((u_b * u_b).sum(1))
    u_ok = ((un - _ISQ2).abs() <= 0.15) | (un >= 0.95)
    v_ok = ((vn - _ISQ2).abs() <= 0.15) | (vn >= 0.95)
    u_b = torch.where(u_ok[:, None, :],
                      u_b / torch.where(un == 0, 1.0, un)[:, None, :], 0.0)
    v_t = torch.where(v_ok[:, None, :],
                      v_t / torch.where(vn == 0, 1.0, vn)[:, None, :], 0.0)
    # sign fix: u's sign pinned to B·v's
    flip = torch.where((mm(b, v_t) * u_b).sum(1) < 0, -1.0, 1.0)
    u_b = u_b * flip[:, None, :]
    tol_rank = eps * K * sv.amax(-1)
    u_b = _complete_u(u_b, sv, tol_rank, force=_force(u_b, u_ok))
    v_t = _complete_u(v_t, sv, tol_rank, force=_force(v_t, v_ok))
    u_b = _orth_polish(u_b)
    v_t = _orth_polish(v_t)
    return _dejitter(a, mm(ub, u_b), sv, mm(mt(v_t), vb))


def _dejitter(a, u, sv, v):
    """σ replaced by the Rayleigh quotient where the TGK value is the
    solver's jitter (see the module docstring); columns re-sorted."""
    B, M, K = u.shape
    r = (mm(mt(u), a) * v).sum(-1)                    # uᵢᵀ·A·vᵢ
    tol = K * torch.finfo(a.dtype).eps * sv.amax(-1, keepdim=True)
    jitter = (sv - r.abs()).abs() > tol
    sv = torch.where(jitter, r.abs(), sv)
    u = u * torch.where(jitter & (r < 0), -1.0, 1.0)[:, None, :]
    order = _descending(sv)
    return (torch.gather(u, 2, order[:, None, :].expand(B, M, K)),
            torch.gather(sv, 1, order),
            torch.gather(v, 1, order[:, :, None].expand(v.shape)))


def svd_dc(a, device=None):
    """Divide-and-conquer SVD, A = U·diag(sv)·V, batched over leading
    dims. Returns (U (..., M, K), sv (..., K), V (..., K, N)). An
    array-like ``a`` goes to ``device`` (default
    ``config.default_device``)."""
    return _svd_entry(a, _svd_dc_core, device)
