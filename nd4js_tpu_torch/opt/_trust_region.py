"""Trust-region least-squares machinery (Moré's Levenberg-Marquardt), the
counterpart of ``nd4js_tpu/opt/_trust_region.py``: the solver state
{x, F, J, g, column scaling D}, the Gauss-Newton step by a rank-revealing
QR with a complete-orthogonal (URV) fallback for a rank-deficient J that
gives the minimum-‖D·dx‖ step, and the regularised step with
(‖D·dx‖, d‖D·dx‖/dλ) for Moré's λ iteration.

J is factorised once an outer iteration by the single-matrix pivoted QR
(``la.rrqr._rrqr_core``); each λ step then works on its (K, N) R: a QR of
the (K + N, N) stack [R_masked; √λ·D_P]. φ'(λ) = −‖R⁻ᵀ·(D²·dx)_P‖²/‖D·dx‖
is Moré's eq. (5.8).

Host reads (``core.host.read``), where the JAX package has ``lax.cond``
and ``lax.while_loop``: whether J has full rank (the URV branch runs only
when it has not), whether the Gauss-Newton step lies inside the radius,
and the λ iteration's condition once an iteration (at most 32).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import dt
from ..core.host import read
from ..core.mm import mm, mt
from ..la.qr import _qr_core
from ..la.rrqr import _rrqr_core, rrqr_rank
from ..la.tri import _tril_inv_core, _triu_solve, triu_t_solve
from ..la.urv import _urv_core

__all__ = ["LsqState", "lsq_state", "LsqFactor", "lsq_factor",
           "newton_step", "regularized_step", "more_lambda_step"]


class LsqState(NamedTuple):
    x: torch.Tensor        # (N,) parameters
    f: torch.Tensor        # (M,) residuals
    j: torch.Tensor        # (M, N) Jacobian
    g: torch.Tensor        # (N,) gradient of 0.5‖F‖² = JᵀF
    d: torch.Tensor        # (N,) column scaling (a running maximum)


def lsq_state(x, f, j, d_prev=None) -> LsqState:
    g = torch.einsum("ij,i->j", j, f)
    d = torch.sqrt((j * j).sum(0))
    if d_prev is not None:
        d = torch.maximum(d, d_prev)      # Moré: never shrink the scaling
    d = torch.where(d == 0, 1.0, d)
    return LsqState(x=x, f=f, j=j, g=g, d=d)


class LsqFactor(NamedTuple):
    """One pivoted QR of J, shared by the Newton step and every λ step."""
    r0: torch.Tensor       # (K, N) upper-triangular R of J[:, P]
    perm: torch.Tensor     # (N,) column pivots P
    qtf: torch.Tensor      # (K,) Qᵀ·F
    rank: torch.Tensor     # () numerical rank of J
    d_perm: torch.Tensor   # (N,) D[P]


def lsq_factor(st: LsqState) -> LsqFactor:
    q, r0, perm = _rrqr_core(st.j, economic=True)
    qtf = mm(mt(q), st.f[:, None])[:, 0]
    return LsqFactor(r0=r0, perm=perm, qtf=qtf, rank=rrqr_rank(r0),
                     d_perm=st.d[perm.long()])


def _unpermute(z_p: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(z_p).index_put((perm.long(),), z_p)


def _phi_prime(r_fac, dx, d, perm, dnorm):
    """Moré eq. (5.8): φ'(λ) = −‖R⁻ᵀ·(D²·dx)_P‖² / ‖D·dx‖, ``r_fac``
    upper triangular in permuted columns."""
    w = (dx * d * d)[perm.long()][:, None]
    z = triu_t_solve(r_fac, w)[:, 0]
    safe = torch.where(dnorm == 0, 1.0, dnorm)
    return torch.where(dnorm == 0, 0.0, -(z * z).sum() / safe)


def _newton_full_rank(fac: LsqFactor, st: LsqState):
    """rank == N: the unique minimiser; the scaling does not matter."""
    n = fac.r0.shape[1]
    z = _triu_solve.core(fac.r0[:n], -fac.qtf[:n, None], "block")[:, 0]
    dx = _unpermute(z, fac.perm)
    dnorm = torch.sqrt(((st.d * dx) ** 2).sum())
    return dx, dnorm, _phi_prime(fac.r0[:n], dx, st.d, fac.perm, dnorm)


def _newton_deficient(fac: LsqFactor, st: LsqState):
    """rank < N: the minimum-‖D·dx‖ solution by the complete orthogonal
    decomposition of the D-scaled R block."""
    k, n = fac.r0.shape
    dev = fac.r0.device
    rows = torch.arange(k, device=dev)[:, None] < fac.rank
    rs = torch.where(rows, fac.r0, 0.0) / fac.d_perm[None, :]  # scale in
    dtol = dt.eps(rs.dtype) * max(k, n)
    u2, r2, v2, rank2 = _urv_core(rs, dtol, 2.0)   # rs = U₂·L·V₂, L lower
    # a masked minimum-norm solve with J's rank, clamped to the URV's own
    # so that the masked L₁₁ stays invertible
    kk = min(k, n)
    live = torch.arange(kk, device=dev) < torch.minimum(fac.rank, rank2)
    eye = torch.eye(kk, dtype=r2.dtype, device=dev)
    l11 = torch.where(live[:, None] & live[None, :], r2[:kk, :kk], eye)
    rhs = torch.where(rows, -fac.qtf[:, None], 0.0)
    y1 = mm(mt(u2[:, :kk]), rhs)
    linv = _tril_inv_core(l11)
    z = torch.where(live[:, None], mm(linv, y1), 0.0)       # (kk, 1)
    if n > kk:
        z = torch.cat([z, z.new_zeros((n - kk, 1))], 0)
    x_s = mm(mt(v2), z)[:, 0]             # minimum norm in D-scaled coords
    dx = _unpermute(x_s / fac.d_perm, fac.perm)              # scale out
    dnorm = torch.sqrt((x_s * x_s).sum())  # ≡ ‖D·dx‖ by construction
    # φ'(0) by the URV triangle: V₂·x_s = [z; 0], so the Moré solve
    # collapses to w = L₁₁⁻ᵀ·z
    w = torch.where(live[:, None], mm(mt(linv), z[:kk]), 0.0)
    safe = torch.where(dnorm == 0, 1.0, dnorm)
    dr = torch.where(dnorm == 0, 0.0, -(w * w).sum() / safe)
    return dx, dnorm, dr


def _newton_from_factor(fac: LsqFactor, st: LsqState):
    m, n = st.j.shape
    if m < n or not read(fac.rank == n):
        # K < N is rank-deficient in the square sense
        return _newton_deficient(fac, st)
    return _newton_full_rank(fac, st)


def newton_step(st: LsqState):
    """Gauss-Newton step: the unique solution when J has full column rank,
    the minimum-‖D·dx‖ one by URV otherwise. Returns (dx, ‖D·dx‖,
    dr/dλ)."""
    return _newton_from_factor(lsq_factor(st), st)


def _regularized_from_factor(fac: LsqFactor, st: LsqState, lam):
    """Solve min ‖[J; √λ·D]·dx + [F; 0]‖ from the cached pivoted QR: a QR
    of the (K + N, N) stack [R_masked; √λ·D_P]. Returns (dx, r, dr)."""
    k, n = fac.r0.shape
    rows = torch.arange(k, device=fac.r0.device)[:, None] < fac.rank
    stack = torch.cat([torch.where(rows, fac.r0, 0.0),
                       torch.sqrt(lam) * torch.diag(fac.d_perm)], 0)
    rhs = torch.cat([torch.where(rows, -fac.qtf[:, None], 0.0),
                     fac.qtf.new_zeros((n, 1))], 0)
    q, r_fac = _qr_core(stack, economic=True)
    dx_p = _triu_solve.core(r_fac, mm(mt(q), rhs), "block")[:, 0]
    dx = _unpermute(dx_p, fac.perm)
    dnorm = torch.sqrt(((st.d * dx) ** 2).sum())
    return dx, dnorm, _phi_prime(r_fac, dx, st.d, fac.perm, dnorm)


def regularized_step(st: LsqState, lam):
    """Solve min ‖[J; √λ·D]·dx + [F; 0]‖. Returns (dx, r, dr) with
    r = ‖D·dx‖ and dr = dr/dλ."""
    return _regularized_from_factor(lsq_factor(st), st, lam)


def more_lambda_step(st: LsqState, radius, max_inner: int = 32):
    """λ ≥ 0 with ‖D·dx(λ)‖ ≈ radius (Moré's Algorithm 5.5). Factors J
    once; every λ step reuses its R. Returns dx."""
    fac = lsq_factor(st)
    dx, r, _ = _newton_from_factor(fac, st)
    if read(r <= radius):
        return dx
    up = torch.sqrt(((st.g / st.d) ** 2).sum()) / radius
    lo = torch.zeros_like(up)
    lam = torch.maximum(1e-3 * up, torch.sqrt(lo * up))
    dx, r, _ = _regularized_from_factor(fac, st, lam)
    it = 0
    while it < max_inner and read((r - radius).abs() > 0.1 * radius):
        dx, r, dr = _regularized_from_factor(fac, st, lam)
        lo = torch.where(r > radius,
                         torch.maximum(lo, lam - (r - radius) / dr), lo)
        up = torch.where(r < radius, lam, up)
        lam2 = lam - ((r - radius) / radius) * (r / dr)
        lam = torch.where(
            (lam2 <= lo) | (lam2 >= up) | ~torch.isfinite(lam2),
            torch.maximum(1e-3 * up, torch.sqrt(lo * up)), lam2)
        it += 1
    return dx
