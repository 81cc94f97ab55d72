"""Box-constrained L-BFGS-B, the counterpart of ``nd4js_tpu/opt/lbfgsb.py``:
``min_lbfgsb_gen`` (an infinite generator of (x, f, ∇f)) and
``lbfgsb_minimize`` (the driver to a KKT tolerance).

One iteration: the generalized Cauchy point and the subspace step of
``_lbfgsb_solver`` give a direction, the bounded ``more_thuente_u123``
search (α₀ = αMax = 1, 30 trials) runs along it on f∘project, and the
memory takes the step's pair, or forgets half its history when the search
fails; success or failure selects with ``torch.where``. The model's part
reads nothing on the host, so on the card it replays as one CUDA graph
(``core.graph``); the search reads one flag a trial, and the driver one
an iteration.

Contract: monotone descent to a KKT point of min f s.t. lo ≤ x ≤ hi.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core import graph
from ..core.host import read
from ._lbfgs_solver import LBFGSState, lbfgs_forget, lbfgs_init, lbfgs_update
from ._lbfgsb_solver import cauchy_point, compact_wk, subspace_step
from ._tree import vdot, where_tree
from .lbfgs import _ensure_fg
from .line_search._engine import BOUND_REACHED, OK, line_search_engine
from .optimization_error import OptimizationNoProgressError

__all__ = ["min_lbfgsb_gen", "lbfgsb_minimize"]


class _BState(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    mem: LBFGSState
    it: torch.Tensor
    fails: torch.Tensor


def _project(x, lo, hi):
    return torch.clamp(x, lo, hi)


def _kkt_residual(x, g, lo, hi):
    """Projected-gradient norm: 0 at a KKT point."""
    return (_project(x - g, lo, hi) - x).abs().max()


def _direction(s, y, rho, head, count, gamma, x, g, lo, hi):
    """The search direction of one iteration, as a 1-tuple: towards the
    subspace minimiser, or the Cauchy point when that is not a descent
    direction (a degenerate model), or −g when neither is."""
    wk = compact_wk(LBFGSState(s, y, rho, head, count, gamma))
    x_cp, c, free = cauchy_point(wk, x, g, lo, hi)
    d = subspace_step(wk, x, g, x_cp, c, free, lo, hi) - x
    d_cp = x_cp - x
    return (torch.where(vdot(d, g) < 0, d,
                        torch.where(vdot(d_cp, g) < 0, d_cp, -g)),)


def _lbfgsb_step(fg, lo, hi, s: _BState, max_ls: int = 30) -> _BState:
    """One L-BFGS-B iteration."""
    d, = graph.run("lbfgsb direction", _direction, *s.mem, s.x, s.g, lo, hi)

    def fg_proj(x):
        return fg(_project(x, lo, hi))

    x_new, f_new, g_new, _, status, _ = line_search_engine(
        fg_proj, s.x, s.f, s.g, -d,
        fRed=1e-2, gRed=0.9, growMin=math.pi / 3, growMax=math.e - 1.5,
        shrinkLeast=0.1, variant="u123", alpha0=1.0, alpha_max=1.0,
        max_iter=max_ls)
    x_new = _project(x_new, lo, hi)
    found = ((status == OK) | (status == BOUND_REACHED)) & (f_new < s.f)
    success = _BState(x=x_new, f=f_new, g=g_new,
                      mem=lbfgs_update(s.mem, x_new - s.x, g_new - s.g),
                      it=s.it + 1, fails=torch.zeros_like(s.fails))
    failure = s._replace(mem=lbfgs_forget(s.mem, (s.mem.s.shape[0] + 1) // 2),
                         it=s.it + 1, fails=s.fails + 1)
    return where_tree(found, success, failure)


def _init_b(fg, x0, bounds, hist_size, device):
    """(fg, lo, hi, the state at the projected x0): f and ∇f are evaluated
    there, not at x0, which may lie outside the box."""
    x0 = as_tensor(x0, device)
    x0 = x0.to(default_float_for(x0.dtype))
    n = x0.numel()
    lo, hi = (as_tensor(b, x0.device).to(x0.dtype).expand(n).contiguous()
              for b in bounds)
    x0 = _project(x0, lo, hi)
    fg, f0, g0 = _ensure_fg(fg, x0)
    zero = torch.zeros((), dtype=torch.int32, device=x0.device)
    return fg, lo, hi, _BState(
        x=x0, f=as_tensor(f0, x0.device), g=g0,
        mem=lbfgs_init(hist_size, n, x0.dtype, x0.device), it=zero,
        fails=zero)


def min_lbfgsb_gen(fg, x0, bounds, hist_size: int = 8, device=None):
    """Generator yielding (x, f, ∇f) for min f s.t. lo ≤ x ≤ hi;
    ``bounds = (lo, hi)`` broadcastable to x. Raises
    OptimizationNoProgressError after more than five failed searches in a
    row. An array-like x0 goes to ``device`` (default
    ``config.default_device``)."""
    fg, lo, hi, s = _init_b(fg, x0, bounds, hist_size, device)
    step = functools.partial(_lbfgsb_step, fg, lo, hi)
    while True:
        yield s.x, s.f, s.g
        s = step(s)
        if read(s.fails > 5):
            raise OptimizationNoProgressError(x=s.x)


def lbfgsb_minimize(fg, x0, bounds, hist_size: int = 8, tol: float = 1e-8,
                    max_iter: int = 500, device=None):
    """Box-constrained minimisation until the projected-gradient (KKT)
    residual is ≤ tol, ``max_iter`` iterations or five failed searches in
    a row. Returns (x, f, g, n_iter). An array-like x0 goes to ``device``
    (default ``config.default_device``)."""
    fg, lo, hi, s = _init_b(fg, x0, bounds, hist_size, device)
    while read((s.it < max_iter) & (s.fails < 5)
               & (_kkt_residual(s.x, s.g, lo, hi) > tol)):
        s = _lbfgsb_step(fg, lo, hi, s)
    return s.x, s.f, s.g, s.it
