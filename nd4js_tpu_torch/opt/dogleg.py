"""Dogleg trust-region methods, the counterpart of
``nd4js_tpu/opt/dogleg.py``: ``lsq_dogleg(_gen)`` and the fit front take
the outer loop of ``lm`` with the dogleg path (Cauchy point → Newton
point, the sphere intersection by the stable quadratic of ``polyquad``)
in place of Moré's λ iteration; ``min_dogleg(_gen)`` minimises a general
function with an L-BFGS model (quasi-Newton point from the two-loop
recursion, Cauchy point from the compact B·v).

Which leg a step takes is one host read (``core.host.read``): a code for
Newton, scaled Cauchy or the leg between them; the step's accept or
reject selects with ``torch.where``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..core.host import read
from ._lbfgs_solver import LBFGSState, lbfgs_update, lbfgs_hv
from ._lbfgsb_solver import bv, compact_wk
from ._trust_region import LsqState, newton_step
from ._tree import vdot, where_tree
from .lbfgs import _init as _lbfgs_init
from .lm import (_DEFAULTS, _LMState, _accept_or_reject, _drive, _fit_fJ,
                 _fit_inputs, _generate, _init, _lsq_cond, _next_radius,
                 _report)
from .polyquad import roots1d_polyquad

__all__ = ["lsq_dogleg_gen", "lsq_dogleg", "fit_dogleg_gen",
           "min_dogleg_gen", "min_dogleg"]

_NEWTON, _CAUCHY, _LEG = 0, 1, 2


def _leg_choice(r_n, r_c, radius) -> int:
    """Newton point inside the radius, else the scaled Cauchy point when
    it is not inside, else the leg between them: one host read."""
    code = torch.where(r_n <= radius, _NEWTON,
                       torch.where(r_c >= radius, _CAUCHY, _LEG))
    return read(code)


def _on_sphere(c, dd, radius):
    """c + s·dd with ‖c + s·dd‖ = radius, s ∈ [0, 1] (vectors already in
    the scaled space)."""
    _, s = roots1d_polyquad(vdot(c, c) - radius * radius, 2 * vdot(c, dd),
                            vdot(dd, dd))
    return torch.clamp(torch.nan_to_num(s, nan=0.0), 0.0, 1.0)


def _dogleg_dx(st: LsqState, radius):
    """Dogleg step in D-scaled space."""
    dx_gn, r_gn, _ = newton_step(st)
    # Cauchy point: dx_c = −t·g, t = ‖g‖²/‖J·g‖²
    jg = torch.einsum("ij,j->i", st.j, st.g)
    jg2 = vdot(jg, jg)
    dx_c = -(vdot(st.g, st.g) / torch.where(jg2 == 0, 1.0, jg2)) * st.g
    r_c = torch.sqrt(((st.d * dx_c) ** 2).sum())
    choice = _leg_choice(r_gn, r_c, radius)
    if choice == _NEWTON:
        return dx_gn
    if choice == _CAUCHY:
        return dx_c * (radius / torch.where(r_c == 0, 1.0, r_c))
    # ‖D(dx_c + s·(dx_gn − dx_c))‖ = radius
    s = _on_sphere(st.d * dx_c, st.d * (dx_gn - dx_c), radius)
    return dx_c + s * (dx_gn - dx_c)


def _dogleg_step(fJ, opt, s: _LMState) -> _LMState:
    st = s.st
    dx = _dogleg_dx(st, s.radius)
    x_new = st.x + dx
    f_new, j_new = fJ(x_new)
    loss_new = 0.5 * (f_new * f_new).sum()
    pred = st.f + torch.einsum("ij,j->i", st.j, dx)
    predicted = s.loss - 0.5 * (pred * pred).sum()
    actual = s.loss - loss_new
    rho = actual / torch.where(predicted == 0, 1.0, predicted)
    dnorm = torch.sqrt(((st.d * dx) ** 2).sum())
    radius = _next_radius(opt, s, rho, dnorm, opt["shrinkUpper"])
    return _accept_or_reject(s, radius, x_new, f_new, j_new, loss_new,
                             actual)


def lsq_dogleg_gen(fJ, x0, device=None, **options):
    """Least-squares dogleg generator: yields (x, mse, ∇mse); raises
    OptimizationNoProgressError past stuckLimit rejected steps."""
    opt = {**_DEFAULTS, **options}
    step = functools.partial(_dogleg_step, fJ, opt)
    for s in _generate(step, _init(fJ, x0, opt, device), opt["stuckLimit"],
                       lambda s: s.st.x):
        yield _report(s)


def lsq_dogleg(fJ, x0, gtol: float = 1e-8, max_iter: int = 200,
               device=None, **options):
    """Dogleg least squares. Returns (x, mse, ∇mse, n_iter)."""
    opt = {**_DEFAULTS, **options}
    s = _drive(functools.partial(_dogleg_step, fJ, opt),
               _init(fJ, x0, opt, device), _lsq_cond(gtol, max_iter, opt))
    x, mse, g = _report(s)
    return x, mse, g, s.it


def fit_dogleg_gen(x, y, f, p0, jac=None, device=None, **options):
    """Curve-fit dogleg generator: yields (p, mse, ∇mse)."""
    x, y, p0 = _fit_inputs(x, y, p0, device)
    return lsq_dogleg_gen(_fit_fJ(x, y, f, jac), p0, **options)


# ---------------------------------------------------------------------
# general minimisation with an L-BFGS trust-region model
# ---------------------------------------------------------------------

class _MinDLState(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    mem: LBFGSState
    radius: torch.Tensor
    it: torch.Tensor
    stuck: torch.Tensor


def _min_dogleg_step(fg, opt, s: _MinDLState) -> _MinDLState:
    # quasi-Newton point from the L-BFGS inverse-Hessian model
    dx_qn = -lbfgs_hv(s.mem, s.g)
    # Cauchy point from the exact L-BFGS B·v model: t = g·g/g·Bg
    wk = compact_wk(s.mem)
    gg = vdot(s.g, s.g)
    gbg = vdot(s.g, bv(wk, s.g))
    t = torch.where(gbg > 0, gg / torch.where(gbg == 0, 1.0, gbg), 1.0)
    dx_c = -t * s.g
    r_c = torch.sqrt(vdot(dx_c, dx_c))
    choice = _leg_choice(torch.sqrt(vdot(dx_qn, dx_qn)), r_c, s.radius)
    if choice == _NEWTON:
        dx = dx_qn
    elif choice == _CAUCHY:
        dx = dx_c * (s.radius / torch.where(r_c == 0, 1.0, r_c))
    else:
        dx = dx_c + _on_sphere(dx_c, dx_qn - dx_c, s.radius) * (dx_qn - dx_c)

    x_new = s.x + dx
    f_new, g_new = fg(x_new)
    # exact model decrease: m(0) − m(dx) = −gᵀdx − ½·dxᵀ·B·dx
    predicted = -vdot(s.g, dx) - 0.5 * vdot(dx, bv(wk, dx))
    predicted = torch.maximum(predicted, -vdot(s.g, dx) * 0.5)
    actual = s.f - f_new
    rho = actual / torch.where(predicted == 0, 1.0, predicted)
    radius = torch.where(
        rho < opt["expectGainMin"],
        torch.clamp(s.radius * opt["shrinkUpper"], min=opt["rMin"]),
        torch.where(rho > opt["expectGainMax"],
                    torch.clamp(s.radius * opt["grow"], max=opt["rMax"]),
                    s.radius))
    acc = _MinDLState(x=x_new, f=f_new, g=g_new,
                      mem=lbfgs_update(s.mem, dx, g_new - s.g),
                      radius=radius, it=s.it + 1,
                      stuck=torch.zeros_like(s.stuck))
    rej = s._replace(radius=radius, it=s.it + 1, stuck=s.stuck + 1)
    return where_tree((actual > 0) & torch.isfinite(f_new), acc, rej)


def _min_init(fg, x0, hist_size, opt, device):
    fg, st = _lbfgs_init(fg, x0, hist_size, device)
    return fg, _MinDLState(
        x=st.x, f=st.f, g=st.g, mem=st.mem,
        radius=torch.tensor(opt["r0"], dtype=st.x.dtype, device=st.x.device),
        it=st.it, stuck=st.fails)


def min_dogleg_gen(fg, x0, hist_size: int = 8, device=None, **options):
    """General trust-region minimisation generator: yields (x, f, ∇f);
    raises OptimizationNoProgressError past stuckLimit rejected steps."""
    opt = {**_DEFAULTS, **options}
    fg, s = _min_init(fg, x0, hist_size, opt, device)
    step = functools.partial(_min_dogleg_step, fg, opt)
    for s in _generate(step, s, opt["stuckLimit"], lambda s: s.x):
        yield s.x, s.f, s.g


def min_dogleg(fg, x0, hist_size: int = 8, gtol: float = 1e-8,
               max_iter: int = 500, device=None, **options):
    """Trust-region minimisation until max|g| ≤ gtol, ``max_iter``
    iterations or more than stuckLimit rejected steps in a row. Returns
    (x, f, g, n_iter)."""
    opt = {**_DEFAULTS, **options}
    fg, s = _min_init(fg, x0, hist_size, opt, device)

    def cond(s):
        return (s.it < max_iter) & (s.g.abs().max() > gtol) \
            & (s.stuck <= opt["stuckLimit"])

    s = _drive(functools.partial(_min_dogleg_step, fg, opt), s, cond)
    return s.x, s.f, s.g, s.it
