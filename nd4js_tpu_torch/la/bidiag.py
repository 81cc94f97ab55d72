"""Golub-Kahan bidiagonalisation A = U·B·V, B upper bidiagonal, the
counterpart of ``nd4js_tpu/la/bidiag.py``.

U (..., M, K), B (..., K, J), V (..., J, N) with K = min(M, N) and
J = K for M ≥ N, K + 1 for M < N. Alternating left and right Householder
reflectors in a static loop over the whole batch, then U and V replayed
from the stored reflectors. Plain PyTorch: the JAX package has no kernel
here.
"""
from __future__ import annotations

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core.mm import mm
from .hessenberg import _householder_vec

__all__ = ["bidiag_decomp"]


def _bidiag_core(a):
    """(U, B, V) of a batch (Bn, M, N) (``nd4js_tpu/la/bidiag.py:27-105``,
    each matrix as its lane)."""
    Bn, M, N = a.shape
    K = min(M, N)
    J = K if M >= N else K + 1
    rows = torch.arange(M, device=a.device)
    cols = torch.arange(N, device=a.device)
    nl = max(0, min(K, M - 1))          # left reflectors
    nr = max(0, min(K, N - 2))          # right reflectors
    left, right = [], []
    for j in range(K):
        if j < nl:
            # zero a[j+1:, j]
            v, tau, _ = _householder_vec(a[:, :, j], j, rows)
            w = tau[:, None] * mm(v[:, None, :], a)[:, 0, :]
            a = a - v[:, :, None] * w[:, None, :]
            left.append((v, tau))
        if j < nr:
            # zero a[j, j+2:]
            v, tau, _ = _householder_vec(a[:, j, :], j + 1, cols)
            u = tau[:, None] * mm(a, v[:, :, None])[:, :, 0]
            a = a - u[:, :, None] * v[:, None, :]
            right.append((v, tau))
    # U = H_0···H_{nl−1}·I(M, K), applied in reverse
    u = torch.eye(M, K, dtype=a.dtype, device=a.device).repeat(Bn, 1, 1)
    for v, tau in reversed(left):
        w = tau[:, None] * mm(v[:, None, :], u)[:, 0, :]
        u = u - v[:, :, None] * w[:, None, :]
    # V = I(J, N)·G_{nr−1}···G_0, right-multiplied in reverse
    vmat = torch.eye(J, N, dtype=a.dtype, device=a.device).repeat(Bn, 1, 1)
    for v, tau in reversed(right):
        w = tau[:, None] * mm(vmat, v[:, :, None])[:, :, 0]
        vmat = vmat - w[:, :, None] * v[:, None, :]
    # B exactly bidiagonal
    r = torch.arange(K, device=a.device)[:, None]
    c = torch.arange(J, device=a.device)[None, :]
    b = torch.where((c == r) | (c == r + 1), a[:, :K, :J], 0.0)
    return u, b, vmat


def bidiag_decomp(a, device=None):
    """(U, B, V) with A = U·B·V, B upper bidiagonal, batched over leading
    dims. An array-like ``a`` goes to ``device`` (default
    ``config.default_device``)."""
    a = as_tensor(a, device)
    a = a.to(default_float_for(a.dtype))
    if a.ndim < 2:
        raise ValueError("bidiag_decomp expects ndim >= 2")
    lead, (M, N) = a.shape[:-2], a.shape[-2:]
    u, b, v = _bidiag_core(a.reshape((-1, M, N)))
    return (u.reshape(lead + u.shape[-2:]), b.reshape(lead + b.shape[-2:]),
            v.reshape(lead + v.shape[-2:]))
