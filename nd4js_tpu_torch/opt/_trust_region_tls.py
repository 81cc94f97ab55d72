"""Structured trust-region solver for ODR/TLS block systems, the
counterpart of ``nd4js_tpu/opt/_trust_region_tls.py``.

The ODR Jacobian over the unknowns u = [Δx, p] is

    J = [[ J21 = blockdiag(Bᵢ), J22 = Jp ],
         [ I                  , 0        ]]     (residuals [F1; Δx])

and with H = JᵀJ the (Δx, Δx) block is block-diagonal (BᵢᵀBᵢ + I +
λ·diag(dᵢ²) a point), so the regularised normal equations
(H + λD²)[ddx; dp] = −JᵀF reduce by Schur elimination of the Δx block to
M independent NX×NX Cholesky solves and one NP×NP solve of
S = Σᵢ (AᵢᵀAᵢ − Qᵢ Cᵢ⁻¹ Qᵢᵀ) + λDp². Memory is O(M·NY·(NP + NX)).

The factorisations are the port's own: ``la.cholesky._chol_core`` (whose
leaves are the ``chol_leaf`` kernel on the card: the (M, NX, NX) blocks
Cᵢ and the (1, NP, NP) S, in each structured solve) and
``la.tri._tril_inv_core``. Every contraction is an ``einsum`` at full
float32 precision (the port pins TF32 off). Moré's φ'(λ) comes from one
more structured solve, so the λ iteration of ``lm`` runs unchanged; it
reads on the host (``core.host.read``) whether the Gauss-Newton step lies
inside the radius, then its condition once an iteration (at most 32).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.host import read
from ..core.mm import mt
from ..la.cholesky import _chol_core
from ..la.tri import _tril_inv_core
from ._tree import vdot

__all__ = ["TlsState", "tls_state", "tls_regularized_step",
           "tls_newton_step", "tls_more_lambda_step"]


class TlsState(NamedTuple):
    p: torch.Tensor       # (NP,) parameters
    dx: torch.Tensor      # (M, NX) input errors
    f1: torch.Tensor      # (M, NY) fit residuals f(p, x + dx) − y
    a: torch.Tensor       # (M, NY, NP) ∂f/∂p a point
    b: torch.Tensor       # (M, NY, NX) ∂f/∂x a point
    g_p: torch.Tensor     # (NP,) gradient block
    g_dx: torch.Tensor    # (M, NX) gradient block
    d_p: torch.Tensor     # (NP,) column scaling
    d_dx: torch.Tensor    # (M, NX) column scaling


def tls_state(p, dx, f1, a, b, d_prev=None) -> TlsState:
    g_p = torch.einsum("myp,my->p", a, f1)
    g_dx = torch.einsum("myx,my->mx", b, f1) + dx
    d_p = torch.sqrt(torch.einsum("myp,myp->p", a, a))
    d_dx = torch.sqrt(torch.einsum("myx,myx->mx", b, b) + 1.0)
    if d_prev is not None:
        d_p = torch.maximum(d_p, d_prev[0])
        d_dx = torch.maximum(d_dx, d_prev[1])
    d_p = torch.where(d_p == 0, 1.0, d_p)
    return TlsState(p=p, dx=dx, f1=f1, a=a, b=b, g_p=g_p, g_dx=g_dx,
                    d_p=d_p, d_dx=d_dx)


def _solve_structured(st: TlsState, lam, rhs_p, rhs_dx):
    """Solve (JᵀJ + λD²)[ddx; dp] = [rhs_dx; rhs_p] by Schur elimination of
    the ddx block. Returns (dp, ddx)."""
    NP = st.p.shape[0]
    # per-point C_i = BᵢᵀBᵢ + I + λ·diag(d_dxᵢ²)   (M, NX, NX)
    c = torch.einsum("myi,myj->mij", st.b, st.b)
    eye = torch.eye(st.dx.shape[1], dtype=st.dx.dtype, device=st.dx.device)
    c = c + eye + lam * st.d_dx[:, :, None] ** 2 * eye
    lc_inv = _tril_inv_core(_chol_core(c))
    cinv = torch.einsum("mki,mkj->mij", lc_inv, lc_inv)   # C⁻¹ = L⁻ᵀL⁻¹
    q = torch.einsum("myp,myx->mpx", st.a, st.b)          # Qᵢ = AᵢᵀBᵢ
    qcinv = torch.einsum("mpx,mxz->mpz", q, cinv)
    # the Schur complement S = Σ AᵀA + λDp² − Σ Q C⁻¹ Qᵀ
    s = torch.einsum("myp,myq->pq", st.a, st.a) \
        + lam * torch.diag(st.d_p ** 2) \
        - torch.einsum("mpz,mqz->pq", qcinv, q)
    rp = rhs_p - torch.einsum("mpz,mz->p", qcinv, rhs_dx)
    eye_p = torch.eye(NP, dtype=s.dtype, device=s.device)
    ls_inv = _tril_inv_core(_chol_core(s + torch.finfo(s.dtype).tiny * eye_p))
    dp = torch.matmul(mt(ls_inv), torch.matmul(ls_inv, rp))
    ddx = torch.einsum("mij,mj->mi", cinv,
                       rhs_dx - torch.einsum("mpx,p->mx", q, dp))
    return dp, ddx


def tls_regularized_step(st: TlsState, lam):
    """Regularised step min ‖[J; √λD]u + [F; 0]‖. Returns
    (dp, ddx, r = ‖D·u‖, dr/dλ), Moré's quantities."""
    dp, ddx = _solve_structured(st, lam, -st.g_p, -st.g_dx)
    r = torch.sqrt(((st.d_p * dp) ** 2).sum()
                   + ((st.d_dx * ddx) ** 2).sum())
    # φ'(λ) = −wᵀ(H + λD²)⁻¹w / r with w = D²·u
    wp = st.d_p ** 2 * dp
    wdx = st.d_dx ** 2 * ddx
    zp, zdx = _solve_structured(st, lam, wp, wdx)
    safe = torch.where(r == 0, 1.0, r)
    dr = -(vdot(wp, zp) + vdot(wdx, zdx)) / safe
    return dp, ddx, r, dr


def tls_newton_step(st: TlsState):
    eps = torch.finfo(st.f1.dtype).eps
    jn = torch.maximum(st.a.abs().max(), st.b.abs().max())
    lam0 = (eps * torch.clamp(jn, min=1.0)) ** 2
    return tls_regularized_step(st, lam0)


def tls_more_lambda_step(st: TlsState, radius, max_inner: int = 32):
    """λ iteration for ‖D·u(λ)‖ ≈ radius (Moré's Algorithm 5.5). Returns
    (dp, ddx)."""
    dp, ddx, r, _ = tls_newton_step(st)
    if read(r <= radius):
        return dp, ddx
    up = torch.sqrt(((st.g_p / st.d_p) ** 2).sum()
                    + ((st.g_dx / st.d_dx) ** 2).sum()) / radius
    lo = torch.zeros_like(up)
    lam = torch.maximum(1e-3 * up, torch.sqrt(lo * up))
    dp, ddx, r, _ = tls_regularized_step(st, lam)
    it = 0
    while it < max_inner and read((r - radius).abs() > 0.1 * radius):
        dp, ddx, r, dr = tls_regularized_step(st, lam)
        lo = torch.where(r > radius,
                         torch.maximum(lo, lam - (r - radius) / dr), lo)
        up = torch.where(r < radius, lam, up)
        lam2 = lam - ((r - radius) / radius) * (r / dr)
        lam = torch.where(
            (lam2 <= lo) | (lam2 >= up) | ~torch.isfinite(lam2),
            torch.maximum(1e-3 * up, torch.sqrt(lo * up)), lam2)
        it += 1
    return dp, ddx
