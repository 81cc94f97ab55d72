"""Hessenberg reduction A = Q·H·Qᵀ, H upper Hessenberg, the counterpart
of ``nd4js_tpu/la/hessenberg.py``.

Householder reduction with the batch axis written out: n < 96 runs the
unblocked loop of two-sided rank-1 updates and accumulates Q by applying
the stored reflectors to the identity in reverse; n ≥ 96 runs the
dlahr2-style blocked form, one panel of 64 reflectors at a time with the
trailing matrix updated by five GEMMs. Plain PyTorch: the JAX package has
no kernel here.
"""
from __future__ import annotations

import math

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core.batch import batched
from ..core.mm import mm, mt

__all__ = ["hessenberg_decomp"]

_PANEL = 64


def _householder_vec(x, k: int, rows):
    """Reflector zeroing x (B, n) below index k (x[:, k+1:] → 0): returns
    (v, tau, beta) with H = I − tau·v·vᵀ, v[k] = 1, v supported on rows
    ≥ k (``nd4js_tpu/la/hessenberg.py:25-43``)."""
    x0 = x[:, k]
    sigma = torch.where(rows > k, x * x, 0.0).sum(-1)
    nrm = torch.sqrt(x0 * x0 + sigma)
    beta = torch.where(x0 >= 0, -nrm, nrm)
    den = x0 - beta
    safe_den = torch.where(den == 0, 1.0, den)
    v = torch.where(rows > k, x / safe_den[:, None], 0.0)
    v = torch.where(rows == k, 1.0, v)
    safe_beta = torch.where(beta == 0, 1.0, beta)
    tau = torch.where(sigma == 0, 0.0, (beta - x0) / safe_beta)
    return v, tau, beta


def _hess_panel(a, k: int, bk: int):
    """dlahr2-style panel (``nd4js_tpu/la/hessenberg.py:49-103``): the
    reflectors of columns k..k+bk−1 without updating the trailing matrix.
    Keeps Ỹ = A·V and the compact-WY T as they grow and corrects each
    column on the fly:

        u = (a_c − Ỹ·T·V[c,:]ᵀ) − V·Tᵀ·Vᵀ·(…)

    a: (B, n, n). Returns (V (B, n, bk), T (B, bk, bk)), v_j supported on
    rows > k+j with its unit at k+j+1."""
    B, n, _ = a.shape
    rows = torch.arange(n, device=a.device)
    jidx = torch.arange(bk, device=a.device)
    atrail = a[:, :, k + 1:]
    V = a.new_zeros((B, n, bk))
    T = a.new_zeros((B, bk, bk))
    Yt = a.new_zeros((B, n, bk))
    for j in range(bk):
        c = k + j
        a_c = a[:, :, c]
        vrow = V[:, c, :]
        u = a_c - mm(Yt, mm(T, vrow[..., None]))[..., 0]
        u = u - mm(V, mm(mt(T), mm(mt(V), u[..., None])))[..., 0]
        x0 = u[:, c + 1]
        sigma = torch.where(rows > c + 1, u * u, 0.0).sum(-1)
        nrm = torch.sqrt(x0 * x0 + sigma)
        beta = torch.where(x0 >= 0, -nrm, nrm)
        beta = torch.where(sigma == 0, x0, beta)
        den = x0 - beta
        safe_den = torch.where(den == 0, 1.0, den)
        v = torch.where(rows > c + 1, u / safe_den[:, None], 0.0)
        v = v + torch.where(rows == c + 1, 1.0, 0.0)
        safe_beta = torch.where(beta == 0, 1.0, beta)
        tau = torch.where(sigma == 0, 0.0, (beta - x0) / safe_beta)
        # grow T:  t_j = −τ·T·(Vᵀ·v),  T[j,j] = τ
        w = mm(mt(V), v[..., None])
        tcol = -tau[:, None] * mm(T, w)[..., 0]
        T[:, :, j] = tcol + torch.where(jidx == j, tau[:, None], 0.0)
        # grow Ỹ: A·v over v's support (the trailing columns)
        Yt[:, :, j] = mm(atrail, v[:, k + 1:, None])[..., 0]
        V[:, :, j] = v
    return V, T


def _hessenberg_blocked(a):
    """Blocked reduction (``nd4js_tpu/la/hessenberg.py:106-125``): each
    panel from :func:`_hess_panel`, then A ← Hᵀ·(A − (A·V)·T·Vᵀ) with
    H = I − V·T·Vᵀ, five GEMMs."""
    B, n, _ = a.shape
    vts = []
    for k in range(0, n - 2, _PANEL):
        bk = min(_PANEL, n - 2 - k)
        V, T = _hess_panel(a, k, bk)
        vts.append((V, T))
        yt = mm(a, V)
        a = a - mm(mm(yt, T), mt(V))
        a = a - mm(V, mm(mt(T), mm(mt(V), a)))
    q = torch.eye(n, dtype=a.dtype, device=a.device).expand(B, n, n)
    for V, T in reversed(vts):
        q = q - mm(V, mm(T, mm(mt(V), q)))
    rows = torch.arange(n, device=a.device)
    mask = rows[:, None] <= rows[None, :] + 1
    return torch.where(mask, a, 0.0), q


def _hessenberg_core(a):
    """(H, Q) of a batch a (B, n, n) (``nd4js_tpu/la/hessenberg.py:128``)."""
    B, n, _ = a.shape
    if n <= 2:
        return a, torch.eye(n, dtype=a.dtype, device=a.device).repeat(B, 1, 1)
    if n >= 96:
        return _hessenberg_blocked(a)
    rows = torch.arange(n, device=a.device)
    vs, taus = [], []
    for j in range(n - 2):
        v, tau, _ = _householder_vec(a[:, :, j], j + 1, rows)
        # left: A ← A − τ·v·(vᵀA);  right: A ← A − (A·v)·τ·vᵀ
        w = tau[:, None] * mm(v[:, None, :], a)[:, 0]
        a = a - v[:, :, None] * w[:, None, :]
        u = tau[:, None] * mm(a, v[..., None])[..., 0]
        a = a - u[:, :, None] * v[:, None, :]
        vs.append(v)
        taus.append(tau)
    # Q = H_0·H_1·…·H_{n−3} applied to I, in reverse
    q = torch.eye(n, dtype=a.dtype, device=a.device).repeat(B, 1, 1)
    for v, tau in zip(reversed(vs), reversed(taus)):
        w = tau[:, None] * mm(v[:, None, :], q)[:, 0]
        q = q - v[:, :, None] * w[:, None, :]
    mask = rows[:, None] <= rows[None, :] + 1
    return torch.where(mask, a, 0.0), q


@batched((2,))
def _hessenberg(a):
    # an explicit batch size: a 0×0 matrix leaves -1 nothing to infer
    a3 = a.reshape((math.prod(a.shape[:-2]),) + a.shape[-2:])
    h, q = _hessenberg_core(a3)
    return q.reshape(a.shape), h.reshape(a.shape)


def hessenberg_decomp(a, device=None):
    """[Q, H] with A = Q·H·Qᵀ, H upper Hessenberg, Q orthogonal
    (``nd4js_tpu/la/hessenberg.py:159``). Batched over leading dims. An
    array-like ``a`` goes to ``device`` (default
    ``config.default_device``)."""
    a = as_tensor(a, device)
    if a.shape[-1] != a.shape[-2]:
        raise ValueError("hessenberg_decomp requires square matrices")
    return _hessenberg(a.to(default_float_for(a.dtype)))
