"""SVD by simultaneous-rotation ("Gram") one-sided Jacobi, the counterpart
of ``nd4js_tpu/la/svd_gram.py``: every pairwise rotation of an iteration
at once, as one orthogonal transform built from GEMMs.

    per iteration:
      G = WᵀW;  t_ij = Jacobi tangent of [[G_ii, G_ij], [G_ij, G_jj]]
      S = skew(t);  Φ = (I + S)·R⁻¹ with RᵀR = I − S²   (chol_leaf leaves)
        or, once ‖S‖_F < 0.15 over the whole batch, Φ = (I + S)·(I − S²)^{-1/2}
        by its three-term series (GEMMs only)
      [W; P] ← [W; P]·Φ

The seed is preconditioned: 'spectral' (N ≥ 128 under 'auto') takes
W₀ = A·V from ``eigh_tridiag_dc`` of AᵀA (the ``sytrd_panel`` kernel), so
the iteration is a short polish; 'qlp' grades A by two Householder QRs
(the ``house_panel`` kernel). Rectangular inputs are pre-reduced by QR
(M > N) or transposed (M < N). Every loop stops on a predicate over the
whole batch, read on the host once per iteration (the JAX package's
``while_loop`` and ``lax.cond`` on the same scalars); unconverged
batches get scalar finishing sweeps, and a batch in which any matrix has
a dead singular value gets U repaired by Householder QR, the whole batch
at once.

``branches`` counts, since its last reset, the iterations that took the
Cholesky ('exact') and the series ('poly') transform, the calls that ran
finishing sweeps and those that repaired U.
"""
from __future__ import annotations

import math

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core.debug import dassert, dcheck_finite
from ..core.mm import mm, mt
from .cholesky import _chol_inv_core
from .eigh import eigh_tridiag_dc
from .qr import _qr_house_flat
from .svd_jac import _brent_luk_shuffle, _descending, _rotation

__all__ = ["svd_gram"]

branches = {"exact": 0, "poly": 0, "finish": 0, "repair": 0}


def _robust_qr(a3):
    """Economic QR of (B, M, N) whose Q is orthogonal to machine precision
    for any conditioning: Householder with ``house_panel`` panels."""
    return _qr_house_flat(a3, True)


def _pair_tangents(g, eps):
    """Jacobi tangents of every (i, j) pair of the Gram batch g, exactly
    antisymmetric with a zero diagonal, and each matrix's relative
    off-diagonal max (``nd4js_tpu/la/svd_gram.py:65-106``). Pairs whose
    columns both sit below eps·max(d) on the σ² scale are frozen: their
    coupling is noise, and ``_complete_u``-style repair owns their basis."""
    d = torch.diagonal(g, dim1=-2, dim2=-1)
    di = d[..., :, None]
    dj = d[..., None, :]
    tiny = torch.finfo(g.dtype).tiny
    denom = torch.sqrt(di) * torch.sqrt(dj) + tiny
    small = g.abs() <= eps * 0.01 * denom + tiny
    dmax = d.amax(-1)[..., None, None]
    frozen = (di <= eps * dmax) & (dj <= eps * dmax)
    small = small | frozen
    safe = torch.where(small, 1.0, g)
    tau = (dj - di) / (2 * safe)
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1 + tau * tau))
    t = torch.where(tau == 0, 1.0, t)        # 45° for exact ties
    t = torch.where(small, 0.0, t)
    t = torch.triu(t, 1)
    t = t - mt(t)
    n = g.shape[-1]
    eye = torch.eye(n, dtype=g.dtype, device=g.device)
    off = torch.where(frozen, 0.0, g.abs() / denom) * (1 - eye)
    return t, off.amax(dim=(-2, -1))


def _gram_iterations(w, p, max_iters: int, tol):
    """The simultaneous-rotation iteration on (B, K, K) ``w``, accumulating
    the right factor into ``p``, while the batch's largest off measure
    (taken before each iteration's rotation) is above ``tol``
    (``nd4js_tpu/la/svd_gram.py:109-167``). Returns (w, p, off). One host
    read per iteration decides both the stop and the transform."""
    K = w.shape[-1]
    eps = torch.finfo(w.dtype).eps
    eye = torch.eye(K, dtype=w.dtype, device=w.device)
    off = w.new_full((w.shape[0],), float("inf"))
    for _ in range(max_iters):
        g = mm(mt(w), w)
        s, off = _pair_tangents(g, eps)
        s2 = mm(s, s)
        # σmax(S) ≤ ‖S‖_F gates the series
        sfro2 = (s * s).sum(dim=(-2, -1)).amax()
        done, tail = torch.stack([off.amax() <= tol,
                                  sfro2 < 0.15 ** 2]).tolist()
        if tail:
            branches["poly"] += 1
            s4 = mm(s2, s2)
            corr = eye + 0.5 * s2 + 0.375 * s4 + 0.3125 * mm(s4, s2)
            phi = corr + mm(s, corr)
        else:
            branches["exact"] += 1
            # Φ₀ᵀΦ₀ = I − S² for skew S: SPD, λ ∈ [1, 1 + σmax(S)²]
            _, linv = _chol_inv_core(eye - s2, base=64)
            phi = mt(linv) + mm(s, mt(linv))
        stacked = mm(torch.cat([w, p], dim=-2), phi)
        w, p = stacked[:, :K], stacked[:, K:]
        if done:
            break
    return w, p, off


def _finishing_sweeps(w, p, max_sweeps: int, tol):
    """Scalar one-sided Jacobi sweeps in Brent-Luk order, plain PyTorch,
    seeded with (w, p) (``nd4js_tpu/la/svd_gram.py:170-231``). An odd K
    gets an inert pad column (its p column starts at e_K)."""
    B, K, _ = w.shape
    eps = torch.finfo(w.dtype).eps
    tiny = torch.finfo(w.dtype).tiny
    pad = K % 2
    if pad:
        w = torch.cat([w, w.new_zeros((B, K, 1))], -1)
        corner = torch.eye(K + 1, dtype=p.dtype,
                           device=p.device)[K:, :].expand(B, 1, K + 1)
        p = torch.cat([torch.cat([p, p.new_zeros((B, K, 1))], -1), corner],
                      -2)
    n = K + pad
    h = n // 2
    wt, wb = w[..., :h], w[..., h:]
    pt, pb = p[..., :h], p[..., h:]
    off = w.new_full((B,), float("inf"))
    for _ in range(max_sweeps):
        if bool(off.amax() <= tol):
            break
        off = w.new_zeros((B,))
        for _ in range(n - 1):
            app = (wt * wt).sum(-2)
            aqq = (wb * wb).sum(-2)
            apq = (wt * wb).sum(-2)
            denom = torch.sqrt(app) * torch.sqrt(aqq) + tiny
            off = torch.maximum(off, (apq.abs() / denom).amax(-1))
            c, s = _rotation(app, aqq, apq, eps)
            c3, s3 = c[..., None, :], s[..., None, :]
            wt, wb = _brent_luk_shuffle(c3 * wt - s3 * wb, s3 * wt + c3 * wb)
            pt, pb = _brent_luk_shuffle(c3 * pt - s3 * pb, s3 * pt + c3 * pb)
    w = torch.cat([wt, wb], -1)
    p = torch.cat([pt, pb], -1)
    if pad:
        w = w[..., :K]
        p = p[..., :K, :K]
    return w, p, off


def _svd_gram_core(a3, max_iters: int, finish_sweeps: int, precond: str):
    """a3 (B, N, N) → (U, sv, Vt) with a3 = U·Σ·Vt
    (``nd4js_tpu/la/svd_gram.py:234-299``)."""
    B, N, _ = a3.shape
    eps = torch.finfo(a3.dtype).eps
    tol = eps * N
    if precond == "auto":
        precond = "spectral" if N >= 128 else "qlp"
    if precond == "spectral":
        _, vg = eigh_tridiag_dc(mm(mt(a3), a3))     # ascending eigenvalues
        q1, q2 = None, vg.flip(-1)                   # descending σ²
        w = mm(a3, q2)                               # A = W₀·Vgᵀ
    elif precond == "qlp":
        # A = Q1·R1, R1ᵀ = Q2·R2: W₀ = R2ᵀ = Q1ᵀ·A·Q2
        q1, r1 = _robust_qr(a3)
        q2, r2 = _robust_qr(mt(r1))
        w = mt(r2)
    else:
        raise ValueError(f"unknown precond {precond!r}")
    p = torch.eye(N, dtype=a3.dtype, device=a3.device).expand(B, N, N)
    w, p, off = _gram_iterations(w, p, max_iters, tol)
    if finish_sweeps > 0 and not bool(off.amax() <= tol):
        branches["finish"] += 1
        w, p, _ = _finishing_sweeps(w, p, finish_sweeps, tol)
    sv = torch.sqrt((w * w).sum(-2))
    order = _descending(sv)
    sv = torch.gather(sv, 1, order)
    idx = order[:, None, :].expand(B, N, N)
    w = torch.gather(w, 2, idx)
    p = torch.gather(p, 2, idx)
    uw = w / torch.where(sv > 0, sv, 1.0)[:, None, :]
    # the repair runs for the whole batch when any matrix has a dead
    # column: healthy matrices get U back up to the R-diagonal sign fix
    if bool((sv.amin(-1) <= eps * N * sv.amax(-1)).any()):
        branches["repair"] += 1
        q, r = _robust_qr(uw)
        d = torch.diagonal(r, dim1=-2, dim2=-1)
        uw = q * torch.where(d < 0, -1.0, 1.0)[:, None, :]
    u = uw if q1 is None else mm(q1, uw)
    return u, sv, mt(mm(q2, p))


def _svd_gram_flat(a3, max_iters, finish_sweeps, precond):
    M, N = a3.shape[-2:]
    if M < N:
        u, sv, v = _svd_gram_flat(mt(a3), max_iters, finish_sweeps, precond)
        return mt(v), sv, mt(u)
    if M > N:
        q, r = _robust_qr(a3)
        u, sv, v = _svd_gram_core(r, max_iters, finish_sweeps, precond)
        return mm(q, u), sv, v
    return _svd_gram_core(a3, max_iters, finish_sweeps, precond)


def svd_gram(a, max_iters: int = 100, finish_sweeps: int = 8,
             precond: str = "auto", device=None):
    """Simultaneous-rotation Jacobi SVD: A = U·diag(sv)·V (see the module
    docstring). Batched over leading dims. ``max_iters`` bounds the GEMM
    iteration, ``finish_sweeps`` the scalar-sweep fallback (0 disables
    it), ``precond`` is 'spectral', 'qlp' or 'auto'. An array-like ``a``
    goes to ``device`` (default ``config.default_device``)."""
    a = as_tensor(a, device)
    a = a.to(default_float_for(a.dtype))
    if a.ndim < 2:
        raise ValueError("svd expects ndim >= 2")
    lead = a.shape[:-2]
    M, N = a.shape[-2:]
    u, sv, v = _svd_gram_flat(a.reshape((max(1, math.prod(lead)), M, N)),
                              max_iters, finish_sweeps, precond)
    K = min(M, N)
    u, sv, v = (u.reshape(lead + (M, K)), sv.reshape(lead + (K,)),
                v.reshape(lead + (K, N)))
    dcheck_finite((u, sv, v), "svd_gram (u, sv, v)")
    dassert(sv[..., :-1] >= sv[..., 1:],
            "svd_gram: singular values not sorted descending")
    dassert(sv >= 0, "svd_gram: negative singular value")
    return u, sv, v
