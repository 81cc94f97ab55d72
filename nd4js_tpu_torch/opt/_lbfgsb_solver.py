"""L-BFGS-B machinery, the counterpart of
``nd4js_tpu/opt/_lbfgsb_solver.py``: the compact representation of the
L-BFGS Hessian model, B = θI − W·M·Wᵀ with W = [Y, θS] (n × 2m) and
M⁻¹ = K = [[−D, Lᵀ], [L, θSᵀS]], built by masked gathers from the ring
buffer; B·v by a small Gauss elimination with partial pivoting; the
generalized Cauchy point; and the subspace step on the free variables.

The JAX package walks the n sorted breakpoints of the Cauchy point with a
``lax.scan`` that solves against K at every segment. K does not change
during the walk, so here K⁻¹·Wᵀ is formed once (one small solve with all
n columns), the walk's recurrences in p, c, f′ and f″ become prefix sums
over the segments, and the Cauchy point is the first segment whose
minimiser lies inside it: a masked argmax, not a loop. A Cauchy point
costs the same number of ops whatever n, and reads nothing on the host.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.mm import mm, mt
from ._lbfgs_solver import LBFGSState
from ._tree import vdot

__all__ = ["compact_wk", "cauchy_point", "subspace_step", "bv"]


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


def cauchy_point(wk: CompactWK, x, g, lo, hi):
    """Generalized Cauchy point along the projected steepest-descent path
    (Byrd-Lu-Nocedal-Zhu, algorithm CP). Returns (x_cp, c = Wᵀ(x_cp − x),
    free), ``free`` marking the variables not driven to a bound.

    The JAX package's scan state before segment j, when every earlier
    segment was committed, is a prefix sum over the sorted breakpoints:
    K⁻¹p_j = K⁻¹p₀ + Σ_{i<j} g_i·K⁻¹w_i from one solve of K against
    [p₀, W_ordᵀ], K⁻¹c_j = Σ_{i≤j} Δt_i·K⁻¹p_i, and f′, f″ by the sums of
    their increments. The walk stops at the first segment whose
    minimiser Δt* = −f′/max(f″, f2_min) lies inside it or whose breakpoint
    is infinite; past it the sums may hold inf or NaN, which no selected
    value reads."""
    dt = x.dtype
    eps = torch.finfo(dt).eps
    safe_g = torch.where(g == 0, 1.0, g)
    t_break = torch.where(g < 0, (x - hi) / safe_g,
                          torch.where(g > 0, (x - lo) / safe_g, math.inf))
    t_break = torch.clamp(t_break, min=0.0)
    d = torch.where(t_break > 0, -g, 0.0)

    order = torch.argsort(t_break, stable=True)
    ts = t_break[order]
    ds = d[order]
    # variables off the path (d = 0: at a bound already, or a zero
    # gradient) commit nothing: every commit term is proportional to g_j
    gs = torch.where(ds == 0, 0.0, g[order])
    w_ord = wk.w[order]                               # (n, 2m)

    p0 = mm(mt(wk.w), d[:, None])[:, 0]               # (2m,)
    f1_0 = -vdot(d, d)
    sol = _small_solve(wk.k, torch.cat([p0[:, None], mt(w_ord)], 1))
    mp0, u = sol[:, 0], mt(sol[:, 1:])                # K⁻¹p₀, rows K⁻¹w_j
    f2_0 = -wk.theta * f1_0 - vdot(p0, mp0)
    f2_min = eps * torch.clamp(-f1_0, min=1.0)

    def before(v):
        """Exclusive prefix sums along the segments."""
        return torch.cat([torch.zeros_like(v[:1]), torch.cumsum(v[:-1], 0)])

    t_old = torch.cat([ts.new_zeros(1), ts[:-1]])
    dt_seg = ts - t_old
    kp_old = mp0 + before(gs[:, None] * u)            # K⁻¹p before j
    kc_new = torch.cumsum(dt_seg[:, None] * kp_old, 0)  # K⁻¹c after j
    wmc = (w_ord * kc_new).sum(1)
    wmp = (w_ord * kp_old).sum(1)
    wmw = (w_ord * u).sum(1)
    df2 = -wk.theta * gs * gs - 2.0 * gs * wmp - gs * gs * wmw
    f2_old = f2_0 + before(df2)
    df1 = dt_seg * f2_old + gs * gs + wk.theta * gs * (ts * ds) - gs * wmc
    f1_old = f1_0 + before(df1)

    dt_star = -f1_old / torch.maximum(f2_old, f2_min)
    inside = (dt_star < dt_seg) | ~torch.isfinite(ts)
    # the first True; index_select, as a 0-d index would be read on the
    # host
    first = torch.argmax(inside.to(torch.int32)).reshape(1)
    t_in = (t_old.index_select(0, first)
            + torch.clamp(dt_star.index_select(0, first), min=0.0))[0]
    t_cp = torch.where(f1_0 >= 0, 0.0,
                       torch.where(inside.any(), t_in, ts[-1]))
    # x_cp: each coordinate moves min(t_cp, t_break_i) along d
    move = torch.where(d == 0, 0.0, torch.minimum(t_cp, t_break) * d)
    x_cp = torch.clamp(x + move, lo, hi)
    c = mm(mt(wk.w), (x_cp - x)[:, None])[:, 0]
    free = t_cp < t_break                             # strictly interior
    return x_cp, c, free


def subspace_step(wk: CompactWK, x, g, x_cp, c, free, lo, hi):
    """Minimise the quadratic model over the free variables from the
    Cauchy point (the direct primal method, BLNZ §5.1):
    B_F⁻¹ = (1/θ)I + (1/θ²)·W_F·(I − (1/θ)M·W_FᵀW_F)⁻¹·M·W_Fᵀ. Returns the
    subspace minimiser clipped to the box."""
    m2 = wk.w.shape[1]
    z = x_cp - x
    mc = _small_solve(wk.k, c[:, None])[:, 0]
    # reduced gradient of the model at x_cp
    r = g + wk.theta * z - mm(wk.w, mc[:, None])[:, 0]
    r = torch.where(free, r, 0.0)

    wf = torch.where(free[:, None], wk.w, 0.0)         # rows masked
    wtr = mm(mt(wf), r[:, None])
    mwtr = _small_solve(wk.k, wtr)[:, 0]
    wtw = mm(mt(wf), wf)
    nmat = torch.eye(m2, dtype=x.dtype, device=x.device) \
        - _small_solve(wk.k, wtw) / wk.theta
    v = _small_solve(nmat, mwtr[:, None])
    d = -(r + mm(wf, v)[:, 0] / wk.theta) / wk.theta
    d = torch.where(free, d, 0.0)
    # the longest feasible step along d from x_cp
    safe_d = torch.where(d == 0, 1.0, d)
    to_hi = torch.where(d > 0, (hi - x_cp) / safe_d, math.inf)
    to_lo = torch.where(d < 0, (lo - x_cp) / safe_d, math.inf)
    amax = torch.clamp(torch.clamp(torch.minimum(to_hi, to_lo).min(),
                                   max=1.0), min=0.0)
    return torch.clamp(x_cp + amax * d, lo, hi)
