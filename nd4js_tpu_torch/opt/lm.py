"""Trust-region Levenberg-Marquardt (Moré), the counterpart of
``nd4js_tpu/opt/lm.py``: the Gauss-Newton-in-radius test and Moré's λ
iteration (``_trust_region.more_lambda_step``), the trust-radius update
with the polynomial shrink, the stuck counter, and ``fit_lm(_gen)``.

Options follow the reference's knobs: {r0, rMin, rMax, shrinkLower,
shrinkUpper, grow, expectGainMin, expectGainMax, stuckLimit}. The step's
accept or reject selects with ``torch.where``. ``lsq_lm`` reads one flag
an iteration on the host (``core.host.read``), the generators one (the
stuck counter against its limit).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core.host import read
from ._trust_region import LsqState, lsq_state, more_lambda_step
from ._tree import vdot, where_tree
from .optimization_error import OptimizationNoProgressError

__all__ = ["lsq_lm_gen", "lsq_lm", "fit_lm_gen", "fit_lm"]


class _LMState(NamedTuple):
    st: LsqState
    radius: torch.Tensor
    it: torch.Tensor
    stuck: torch.Tensor
    loss: torch.Tensor       # 0.5 ‖F‖²


_DEFAULTS = dict(r0=1.0, rMin=1e-10, rMax=1e10,
                 shrinkLower=0.05, shrinkUpper=0.5, grow=1.5,
                 expectGainMin=0.25, expectGainMax=0.75,
                 stuckLimit=32)


def _next_radius(opt, s, rho, dnorm, shrink):
    return torch.where(
        rho < opt["expectGainMin"],
        torch.clamp(s.radius * shrink, min=opt["rMin"]),
        torch.where((rho > opt["expectGainMax"]) & (dnorm >= 0.9 * s.radius),
                    torch.clamp(s.radius * opt["grow"], max=opt["rMax"]),
                    s.radius))


def _accept_or_reject(s: _LMState, radius, x_new, f_new, j_new, loss_new,
                      actual) -> _LMState:
    st = s.st
    acc = _LMState(st=lsq_state(x_new, f_new, j_new, d_prev=st.d),
                   radius=radius, it=s.it + 1,
                   stuck=torch.zeros_like(s.stuck), loss=loss_new)
    rej = _LMState(st=st, radius=radius, it=s.it + 1, stuck=s.stuck + 1,
                   loss=s.loss)
    return where_tree((actual > 0) & torch.isfinite(loss_new), acc, rej)


def _lm_step(fJ, opt, s: _LMState) -> _LMState:
    st = s.st
    dx = more_lambda_step(st, s.radius)
    x_new = st.x + dx
    f_new, j_new = fJ(x_new)
    loss_new = 0.5 * (f_new * f_new).sum()
    # predicted reduction from the model ‖F + J·dx‖
    pred = st.f + torch.einsum("ij,j->i", st.j, dx)
    predicted = s.loss - 0.5 * (pred * pred).sum()
    actual = s.loss - loss_new
    rho = actual / torch.where(predicted == 0, 1.0, predicted)
    # polynomial shrink: the quadratic through (0, loss), slope g·dx,
    # (1, loss_new)
    gdx = vdot(st.g, dx)
    denom = 2 * (loss_new - s.loss - gdx)
    shrink = torch.where(denom > 0,
                         -gdx / torch.where(denom == 0, 1.0, denom),
                         opt["shrinkUpper"])
    shrink = torch.clamp(shrink, opt["shrinkLower"], opt["shrinkUpper"])
    dnorm = torch.sqrt(((st.d * dx) ** 2).sum())
    radius = _next_radius(opt, s, rho, dnorm, shrink)
    return _accept_or_reject(s, radius, x_new, f_new, j_new, loss_new,
                             actual)


def _init(fJ, x0, opt, device=None) -> _LMState:
    x0 = as_tensor(x0, device)
    x0 = x0.to(default_float_for(x0.dtype))
    f0, j0 = fJ(x0)
    zero = torch.zeros((), dtype=torch.int32, device=x0.device)
    return _LMState(st=lsq_state(x0, f0, j0),
                    radius=torch.tensor(opt["r0"], dtype=x0.dtype,
                                        device=x0.device),
                    it=zero, stuck=zero, loss=0.5 * (f0 * f0).sum())


def _report(s: _LMState):
    """(x, mse, ∇mse), the reference's report()."""
    m = s.st.f.numel()
    return s.st.x, 2 * s.loss / m, 2 * s.st.g / m


def _generate(step, s, stuck_limit, x_of):
    """Yield the report of each state; raise OptimizationNoProgressError
    when the stuck counter passes its limit."""
    while True:
        yield s
        s = step(s)
        if read(s.stuck > stuck_limit):
            raise OptimizationNoProgressError(x=x_of(s))


def _drive(step, s, cond):
    while read(cond(s)):
        s = step(s)
    return s


def lsq_lm_gen(fJ, x0, device=None, **options):
    """Infinite generator yielding (x, mse, ∇mse) per iteration. Raises
    OptimizationNoProgressError when the stuck counter passes stuckLimit.
    An array-like x0 goes to ``device`` (default
    ``config.default_device``)."""
    opt = {**_DEFAULTS, **options}
    s = _init(fJ, x0, opt, device)
    step = functools.partial(_lm_step, fJ, opt)
    for s in _generate(step, s, opt["stuckLimit"], lambda s: s.st.x):
        yield _report(s)


def _lsq_cond(gtol, max_iter, opt):
    def cond(s):
        return (s.it < max_iter) & (s.st.g.abs().max() > gtol) \
            & (s.stuck <= opt["stuckLimit"])
    return cond


def lsq_lm(fJ, x0, gtol: float = 1e-8, max_iter: int = 200, device=None,
           **options):
    """LM until max|g| ≤ gtol, ``max_iter`` iterations or more than
    stuckLimit rejected steps in a row. Returns (x, mse, ∇mse, n_iter)."""
    opt = {**_DEFAULTS, **options}
    s = _drive(functools.partial(_lm_step, fJ, opt),
               _init(fJ, x0, opt, device), _lsq_cond(gtol, max_iter, opt))
    x, mse, g = _report(s)
    return x, mse, g, s.it


def _fit_fJ(x, y, f, jac=None):
    def fJ(p):
        F = f(p, x) - y
        J = (jac(p, x) if jac is not None
             else torch.func.jacrev(lambda q: f(q, x))(p))
        return F.reshape(-1), J.reshape(F.numel(), -1)
    return fJ


def _fit_inputs(x, y, p0, device):
    x = as_tensor(x, device)
    return x, as_tensor(y, x.device), as_tensor(p0, x.device)


def fit_lm_gen(x, y, f, p0, jac=None, device=None, **options):
    """Curve-fit LM generator: yields (p, mse, ∇mse). ``f(p, x)`` is
    vectorised over x; the Jacobian is ``torch.func.jacrev``'s unless
    given. Array-likes go to ``device`` (default
    ``config.default_device``)."""
    x, y, p0 = _fit_inputs(x, y, p0, device)
    return lsq_lm_gen(_fit_fJ(x, y, f, jac), p0, **options)


def fit_lm(x, y, f, p0, jac=None, device=None, **kw):
    """Curve fit by :func:`lsq_lm`. Returns (p, mse, ∇mse, n_iter)."""
    x, y, p0 = _fit_inputs(x, y, p0, device)
    return lsq_lm(_fit_fJ(x, y, f, jac), p0, **kw)
