"""The compact representation of the L-BFGS Hessian model, the part of
``nd4js_tpu/opt/_lbfgsb_solver.py`` that ``dogleg.min_dogleg`` uses:
B = θI − W·M·Wᵀ with W = [Y, θS] (n × 2m) and M⁻¹ = K =
[[−D, Lᵀ], [L, θSᵀS]], built by masked gathers from the ring buffer, and
B·v by a small Gauss elimination with partial pivoting. The generalized
Cauchy point and the subspace step of L-BFGS-B (``cauchy_point``,
``subspace_step``) are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.mm import mm, mt
from ._lbfgs_solver import LBFGSState

__all__ = ["compact_wk", "bv"]


def _small_solve(k: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Gauss elimination with partial pivoting for a small (q, q) system;
    rhs (q, r). A Python loop over q steps, no host read."""
    q = k.shape[0]
    aug = torch.cat([k, rhs], 1)                      # (q, q+r)
    rows = torch.arange(q, device=k.device)
    for j in range(q):
        cand = torch.where(rows >= j, aug[:, j].abs(), -1.0)
        p = torch.argmax(cand)
        swap = torch.where(rows == j, p, torch.where(rows == p, j, rows))
        aug = aug[swap]
        piv = aug[j, j]
        safe = torch.where(piv == 0, 1.0, piv)
        fac = torch.where(rows == j, 0.0, aug[:, j] / safe)
        aug = aug - fac[:, None] * aug[j][None, :]
    d = torch.diagonal(aug[:, :q])
    safe = torch.where(d == 0, 1.0, d)
    x = aug[:, q:] / safe[:, None]
    for i in range(q):
        j = q - 1 - i
        upd = x - (aug[:, j] / safe)[:, None] * x[j][None, :]
        x = torch.where((rows < j)[:, None], upd, x)
    return x


class CompactWK(NamedTuple):
    w: torch.Tensor        # (n, 2m) = [Y_chron, θ·S_chron] as columns
    k: torch.Tensor        # (2m, 2m) = M⁻¹, dead slots the identity
    theta: torch.Tensor    # () B₀ = θI scale
    valid: torch.Tensor    # (2m,) column validity mask


def compact_wk(mem: LBFGSState) -> CompactWK:
    """The compact representation from the ring buffer."""
    m, n = mem.s.shape
    theta = 1.0 / torch.where(mem.gamma == 0, 1.0, mem.gamma)
    kk = torch.arange(m, device=mem.s.device)
    idx = (mem.head - mem.count + kk) % m            # chronological
    val = kk < mem.count
    s = torch.where(val[:, None], mem.s[idx], 0.0)   # (m, n)
    y = torch.where(val[:, None], mem.y[idx], 0.0)
    sy = mm(s, mt(y))                                # (m, m) SᵀY
    ss = mm(s, mt(s))
    l = torch.tril(sy, -1)                           # strict lower
    k = torch.cat([torch.cat([-torch.diag(torch.diagonal(sy)), mt(l)], 1),
                   torch.cat([l, theta * ss], 1)], 0)
    # dead slots -> identity rows and columns (K stays invertible, W's
    # columns there are 0)
    val2 = torch.cat([val, val])
    eye = torch.eye(2 * m, dtype=k.dtype, device=k.device)
    k = torch.where(val2[:, None] & val2[None, :], k, eye)
    w = mt(torch.cat([y, theta * s], 0))             # (n, 2m)
    return CompactWK(w=w, k=k, theta=theta, valid=val2)


def bv(wk: CompactWK, v: torch.Tensor) -> torch.Tensor:
    """B·v = θ·v − W·K⁻¹·Wᵀ·v."""
    wtv = mm(mt(wk.w), v[:, None])
    u = _small_solve(wk.k, wtv)
    return wk.theta * v - mm(wk.w, u)[:, 0]
