"""Symmetric eigendecomposition, A = V·diag(w)·Vᵀ with w ascending, the
counterpart of ``nd4js_tpu/la/eigh.py``:

* ``eigh_jacobi`` — two-sided parallel Jacobi in Brent-Luk tournament
  order: each round rotates N/2 disjoint pairs of rows and columns at
  once, then shuffles both consistently, so the matrix stays symmetric.
  Sweeps stop per matrix once its off-diagonal measure is ≤ eps·N.
* ``eigh_tridiag_dc`` — ``la.sytrd`` (the ``sytrd_panel`` kernel) then
  the tridiagonal divide-and-conquer of ``la.tridiag_dc`` and one
  back-transform GEMM.
* ``eigh_via_svd`` — the SVD of A + ‖A‖_F·I, whose singular triplets are
  its eigenpairs, shifted back.
* ``eigh`` routes n ≥ 128 to ``dc`` and smaller inputs to Jacobi.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core.batch import batched
from ..core.mm import mm, mt
from .sytrd import sytrd
from .tridiag_dc import tridiag_eigh_dc

__all__ = ["eigh", "eigh_jacobi", "eigh_tridiag_dc", "eigh_via_svd"]


def _shuffle_cols(xt, xb):
    h = xt.shape[-1]
    if h == 1:
        return xt, xb
    nt = torch.cat([xt[..., :1], xb[..., :1], xt[..., 1:h - 1]], -1)
    nb = torch.cat([xb[..., 1:], xt[..., h - 1:]], -1)
    return nt, nb


def _round(a, v, off):
    """One tournament round on a batch (G, N, N): rotate the N/2 pairs
    (p, p + N/2) that zero each pair's off-diagonal entry, from both
    sides of A and from the right of V, then the Brent-Luk shuffle
    (``nd4js_tpu/la/eigh.py:49-85``)."""
    h = a.shape[-1] // 2
    tiny = torch.finfo(a.dtype).tiny
    app = torch.diagonal(a[:, :h, :h], dim1=-2, dim2=-1)
    aqq = torch.diagonal(a[:, h:, h:], dim1=-2, dim2=-1)
    apq = torch.diagonal(a[:, :h, h:], dim1=-2, dim2=-1)
    scale = torch.sqrt(torch.abs(app * aqq)) + torch.abs(apq) + tiny
    off = torch.maximum(off, (torch.abs(apq) / scale).amax(dim=-1))
    small = torch.abs(apq) <= tiny
    safe_apq = torch.where(small, 1.0, apq)
    tau = (aqq - app) / (2 * safe_apq)
    t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1 + tau * tau))
    t = torch.where(tau == 0, 1.0, t)
    t = torch.where(small, 0.0, t)
    c = torch.rsqrt(1 + t * t)
    s = t * c
    cr, sr = c[:, :, None], s[:, :, None]      # scale rows
    cc, sc = c[:, None, :], s[:, None, :]      # scale columns
    at, ab = a[:, :h, :], a[:, h:, :]
    a = torch.cat([cr * at - sr * ab, sr * at + cr * ab], dim=1)
    al, ar = a[:, :, :h], a[:, :, h:]
    nal, nar = _shuffle_cols(cc * al - sc * ar, sc * al + cc * ar)
    vl, vr = v[:, :, :h], v[:, :, h:]
    nvl, nvr = _shuffle_cols(cc * vl - sc * vr, sc * vl + cc * vr)
    a = torch.cat([nal, nar], dim=2)
    at, ab = _shuffle_cols(mt(a[:, :h, :]), mt(a[:, h:, :]))
    a = torch.cat([mt(at), mt(ab)], dim=1)
    return a, torch.cat([nvl, nvr], dim=2), off


def _eigh_core(a, max_sweeps: int, tol: float):
    """(diagonal, V) after Jacobi sweeps on a batch (G, N, N), N even.

    As under the JAX package's ``vmap`` of its ``while_loop``
    (``nd4js_tpu/la/eigh.py:87-99``), each matrix stops on its own: a
    sweep runs only on the matrices whose last sweep left an
    off-diagonal measure above ``tol``, and the others stay as they are
    (one host sync per sweep)."""
    G, N, _ = a.shape
    v = torch.eye(N, dtype=a.dtype, device=a.device).repeat(G, 1, 1)
    off = torch.full((G,), float("inf"), dtype=a.dtype, device=a.device)
    for _ in range(max_sweeps):
        idx = torch.nonzero(off > tol).squeeze(1)
        if idx.numel() == 0:
            break
        sa, sv = a[idx], v[idx]
        so = torch.zeros(idx.shape, dtype=a.dtype, device=a.device)
        for _ in range(N - 1):
            sa, sv, so = _round(sa, sv, so)
        a[idx], v[idx], off[idx] = sa, sv, so
    return torch.diagonal(a, dim1=-2, dim2=-1), v


@batched((2,))
def _eigh_jacobi(a, max_sweeps: int):
    N = a.shape[-1]
    a3 = a.reshape((-1, N, N))
    a3 = (a3 + mt(a3)) * 0.5
    pad = N % 2
    if pad:
        # the pad row and column are zero, so no rotation mixes the pad
        # dimension in: its eigenpair is (0, e_N)
        a3 = torch.nn.functional.pad(a3, (0, 1, 0, 1))
    w, v = _eigh_core(a3, max_sweeps, tol=torch.finfo(a.dtype).eps * N)
    if pad:
        # locate the pad pair by its vector's pad-row magnitude, not by
        # its value; every other column has an exact 0 there, so the sort
        # must be stable
        keep = torch.argsort(-v[:, N, :].abs(), dim=-1, stable=True)[:, 1:]
        w = torch.gather(w, 1, keep)
        v = torch.gather(v[:, :N, :], 2, keep[:, None, :].expand(-1, N, N))
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.gather(w, 1, order)
    v = torch.gather(v, 2, order[:, None, :].expand(-1, N, N))
    return w.reshape(a.shape[:-1]), v.reshape(a.shape)


def eigh_jacobi(a, max_sweeps: int = 30, device=None):
    """Symmetric eigendecomposition, A = V·diag(w)·Vᵀ, w ascending, by
    parallel two-sided Jacobi. Batched over leading dims. Only the
    symmetric part of A is used. An array-like ``a`` goes to ``device``
    (default ``config.default_device``)."""
    a = as_tensor(a, device)
    return _eigh_jacobi(a.to(default_float_for(a.dtype)), max_sweeps)


def eigh_via_svd(a, device=None):
    """Symmetric eigendecomposition through the SVD
    (``nd4js_tpu/la/eigh.py:129-152``): B = A + c·I with c = ‖A‖_F ≥ ρ(A)
    is positive definite, so its singular triplets are its eigenpairs (no
    ±λ ambiguity); λ = σ − c, sorted ascending (stably). Absolute accuracy
    eps·c on small eigenvalues. Batched over leading dims. An array-like
    ``a`` goes to ``device`` (default ``config.default_device``)."""
    from .svd import svd_decomp
    a = as_tensor(a, device)
    a = a.to(default_float_for(a.dtype))
    a = (a + mt(a)) * 0.5
    n = a.shape[-1]
    c = torch.sqrt((a * a).sum(dim=(-2, -1), keepdim=True)) \
        + torch.finfo(a.dtype).tiny
    b = a + c * torch.eye(n, dtype=a.dtype, device=a.device)
    u, sv, _ = svd_decomp(b)
    w = sv - c[..., 0]
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    vec = torch.gather(u, -1, order[..., None, :].expand(u.shape))
    return w, vec


def eigh_tridiag_dc(a, device=None):
    """Symmetric eigendecomposition by blocked tridiagonalisation
    (``la.sytrd``, one ``sytrd_panel`` launch per 64 columns) and
    divide-and-conquer on the tridiagonal (``la.tridiag_dc``), then one
    back-transform GEMM. Batched over leading dims. An array-like ``a``
    goes to ``device`` (default ``config.default_device``)."""
    a = as_tensor(a, device)
    a = a.to(default_float_for(a.dtype))
    if a.shape[-1] == 1:
        return a[..., 0], torch.ones_like(a)
    d, e, q = sytrd(a)
    w, v = tridiag_eigh_dc(d, e)
    return w, mm(q, v)


def eigh(a, max_sweeps: int = 30, method: str = "auto", device=None):
    """Symmetric eigendecomposition, A = V·diag(w)·Vᵀ, w ascending.

    method: 'auto' (n ≥ 128 goes to 'dc', smaller inputs to 'jacobi'),
    'jacobi' (highest relative accuracy), 'dc' (tridiagonal
    divide-and-conquer) or 'via_svd' (the SVD of a shifted A). An
    array-like ``a`` goes to ``device`` (default
    ``config.default_device``)."""
    if method == "auto":
        shape = np.shape(a)
        method = "dc" if len(shape) >= 2 and shape[-1] >= 128 else "jacobi"
    if method == "via_svd":
        return eigh_via_svd(a, device=device)
    if method == "dc":
        return eigh_tridiag_dc(a, device=device)
    if method == "jacobi":
        return eigh_jacobi(a, max_sweeps=max_sweeps, device=device)
    raise ValueError(f"unknown eigh method {method!r}")
