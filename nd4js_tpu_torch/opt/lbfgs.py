"""L-BFGS minimisation drivers, the counterpart of
``nd4js_tpu/opt/lbfgs.py``: ``min_lbfgs_gen`` (an infinite generator of
(x, f, ∇f), the user owns convergence), ``lbfgs_minimize`` (the driver
with gradient and iteration limits), and the least-squares and
curve-fit adapters. A failed line search forgets half the history and
retries from the same point.

One iteration is a plain function of the state (a NamedTuple of
tensors); success or failure of its line search selects with
``torch.where``. ``lbfgs_minimize`` reads one flag an iteration on the
host (``core.host.read``): whether to go on. Gradients default to
``torch.func.grad_and_value`` when the user gives only f.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core.host import read
from ._lbfgs_solver import (LBFGSState, lbfgs_init, lbfgs_update,
                            lbfgs_forget, lbfgs_hv)
from ._tree import vdot, where_tree
from .line_search._wolfe import wolfe_line_search

__all__ = ["min_lbfgs_gen", "lbfgs_minimize", "lsq_lbfgs_gen",
           "fit_lbfgs_gen"]


class _MinState(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    mem: LBFGSState
    it: torch.Tensor
    fails: torch.Tensor


def _grad_and_value(f) -> Callable:
    """fg(x) -> (f, ∇f) from f(x) -> f, by ``torch.func.grad_and_value``."""
    grad_and_value = torch.func.grad_and_value(f)

    def fg(x):
        g, v = grad_and_value(x)
        return v, g
    return fg


def _ensure_fg(fg_or_f, x0):
    """(fg, f0, g0) for fg(x) -> (f, g) or f(x) -> f: one call at ``x0``,
    which the solver needs anyway, tells them apart; a scalar f gets its
    gradient by ``torch.func.grad_and_value``."""
    out = fg_or_f(x0)
    if isinstance(out, tuple) and len(out) == 2:
        return (fg_or_f,) + out
    fg = _grad_and_value(fg_or_f)
    return (fg,) + fg(x0)


def _lbfgs_step(fg, st: _MinState, m: int) -> _MinState:
    neg_dir = lbfgs_hv(st.mem, st.g)     # H·g; the descent direction is −H·g
    # first iteration: a cautious step along the raw gradient
    gnorm = torch.sqrt(vdot(st.g, st.g))
    scale = torch.where(st.mem.count == 0,
                        1.0 / torch.clamp(gnorm, min=1.0), 1.0)
    x, f, g, alpha, ok = wolfe_line_search(
        fg, st.x, st.f, st.g, neg_dir * scale, c1=1e-4, c2=0.9)
    success = _MinState(x=x, f=f, g=g,
                        mem=lbfgs_update(st.mem, x - st.x, g - st.g),
                        it=st.it + 1, fails=torch.zeros_like(st.fails))
    # forget half the history and retry from the same point
    failure = st._replace(mem=lbfgs_forget(st.mem, (m + 1) // 2),
                          it=st.it + 1, fails=st.fails + 1)
    return where_tree(ok & (f < st.f), success, failure)


def _init(fg, x0, hist_size: int, device):
    x0 = as_tensor(x0, device)
    x0 = x0.to(default_float_for(x0.dtype))
    fg, f0, g0 = _ensure_fg(fg, x0)
    zero = torch.zeros((), dtype=torch.int32, device=x0.device)
    return fg, _MinState(x=x0, f=as_tensor(f0, x0.device), g=g0,
                         mem=lbfgs_init(hist_size, x0.numel(), x0.dtype,
                                        x0.device),
                         it=zero, fails=zero)


def min_lbfgs_gen(fg, x0, hist_size: int = 8, device=None):
    """Infinite generator yielding (x, f, ∇f) per iteration; the user owns
    the convergence test. An array-like x0 goes to ``device`` (default
    ``config.default_device``)."""
    fg, st = _init(fg, x0, hist_size, device)
    step = functools.partial(_lbfgs_step, fg, m=hist_size)
    while True:
        yield st.x, st.f, st.g
        st = step(st)


def lbfgs_minimize(fg, x0, hist_size: int = 8, gtol: float = 1e-8,
                   max_iter: int = 500, device=None):
    """L-BFGS until max|g| ≤ gtol, ``max_iter`` iterations or three failed
    line searches in a row. Returns (x, f, g, n_iter). An array-like x0
    goes to ``device`` (default ``config.default_device``)."""
    fg, st = _init(fg, x0, hist_size, device)
    while read((st.it < max_iter) & (st.g.abs().max() > gtol)
               & (st.fails < 3)):
        st = _lbfgs_step(fg, st, hist_size)
    return st.x, st.f, st.g, st.it


def _lsq_fg(fJ):
    """Least-squares adapter: fJ(x) -> (residuals F, Jacobian J);
    loss = mean(F²), grad = 2/M·Jᵀ·F."""
    def fg(x):
        F, J = fJ(x)
        m = F.numel()
        f = (F * F).sum() / m
        g = 2.0 / m * torch.einsum("ij,i->j", J.reshape(m, -1),
                                   F.reshape(-1))
        return f, g.reshape(x.shape)
    return fg


def lsq_lbfgs_gen(fJ, x0, **kw):
    """Least-squares L-BFGS generator: yields (x, mse, ∇mse)."""
    return min_lbfgs_gen(_lsq_fg(fJ), x0, **kw)


def fit_lbfgs_gen(x, y, f, p0, jac=None, device=None, **kw):
    """Curve-fit adapter: minimise mean((f(p, x) − y)²) over p. ``f(p, x)``
    is vectorised over x; the Jacobian defaults to ``torch.func.jacrev``.
    Array-likes go to ``device`` (default ``config.default_device``)."""
    x = as_tensor(x, device)
    y = as_tensor(y, x.device)

    def fJ(p):
        F = f(p, x) - y
        J = (jac(p, x) if jac is not None
             else torch.func.jacrev(lambda q: f(q, x))(p))
        return F, J

    return lsq_lbfgs_gen(fJ, as_tensor(p0, x.device), **kw)
