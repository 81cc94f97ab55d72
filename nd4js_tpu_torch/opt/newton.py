"""Newton's method for roots of vector functions, the counterpart of
``nd4js_tpu/opt/newton.py``: each step factors the Jacobian by
``la.lu_decomp`` (its panels through the ``lu_panel`` kernel on the card)
and solves with ``la.lu_solve``.

``root_newton`` evaluates F and J once an iteration and reads one flag on
the host, whether max|F| is still above ``tol``; the JAX package's loop
condition evaluates F and its body evaluates it again at the same x, so
the iterates are the same.
"""
from __future__ import annotations

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core.host import read
from ..la.lu import lu_decomp, lu_solve

__all__ = ["root_newton_gen", "root_newton"]


def _start(x0, device):
    x = as_tensor(x0, device)
    return x.to(default_float_for(x.dtype))


def _newton(x, F, J):
    lu, p = lu_decomp(J)
    return x + lu_solve(lu, p, -F[:, None])[:, 0]


def root_newton_gen(fJ, x0, device=None):
    """Generator yielding x per Newton iteration; ``fJ(x) -> (F, J)``. An
    array-like x0 goes to ``device`` (default ``config.default_device``)."""
    x = _start(x0, device)
    while True:
        yield x
        x = _newton(x, *fJ(x))


def root_newton(fJ, x0, tol: float = 1e-12, max_iter: int = 64,
                device=None):
    """Newton iterations until max|F| ≤ tol or ``max_iter`` steps. Returns
    (x, n_iter). An array-like x0 goes to ``device`` (default
    ``config.default_device``)."""
    x = _start(x0, device)
    it = 0
    F, J = fJ(x)
    while it < max_iter and read(F.abs().max() > tol):
        x = _newton(x, F, J)
        it += 1
        F, J = fJ(x)
    return x, torch.tensor(it, dtype=torch.int32, device=x.device)
