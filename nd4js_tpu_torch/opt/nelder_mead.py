"""Derivative-free Nelder-Mead simplex minimisation, the counterpart of
``nd4js_tpu/opt/nelder_mead.py``: reflection, expansion, contraction and
shrink on a regular initial simplex (``utils.regular_simplex``).

A step sorts the vertices stably (plateaus in f give ties), evaluates f
at the reflected, expanded and contracted points, and selects the new
worst vertex with ``torch.where``; the shrink's n + 1 evaluations run
only when nothing else helped, a host branch on one read. The vertices
are evaluated together by ``torch.func.vmap`` of f. The driver reads one
more flag an iteration, whether the spread of f is still above ftol.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core.host import read
from ..utils.geom import regular_simplex

__all__ = ["min_nelder_mead_gen", "min_nelder_mead"]


class _NMState(NamedTuple):
    xs: torch.Tensor       # (n+1, n) simplex vertices
    fs: torch.Tensor       # (n+1,)
    it: torch.Tensor


def _nm_step(f, s: _NMState) -> _NMState:
    n = s.xs.shape[1]
    order = torch.argsort(s.fs, stable=True)
    xs = s.xs[order]
    fs = s.fs[order]
    best, worst = fs[0], fs[n]
    centroid = torch.mean(xs[:n], 0)
    xr = centroid + (centroid - xs[n])          # reflection
    fr = f(xr)
    xe = centroid + 2 * (centroid - xs[n])      # expansion
    fe = f(xe)
    xc = centroid + 0.5 * (xs[n] - centroid)    # contraction
    fc = f(xc)

    use_expand = (fr < best) & (fe < fr)
    # the JAX package's precedence, kept as it stands:
    # ((fr < f_{n-1}) & ~expand) | ((fr < best) & (fe >= fr))
    use_reflect = (fr < fs[n - 1]) & ~use_expand | ((fr < best) & (fe >= fr))
    use_contract = (~use_expand) & (~use_reflect) \
        & (fc < torch.minimum(fr, worst))
    if read(use_expand | use_reflect | use_contract):
        new_x = torch.where(use_expand, xe,
                            torch.where(use_reflect, xr,
                                        torch.where(use_contract, xc, xs[n])))
        new_f = torch.where(use_expand, fe,
                            torch.where(use_reflect, fr,
                                        torch.where(use_contract, fc, worst)))
        xs = torch.cat([xs[:n], new_x[None]])
        fs = torch.cat([fs[:n], new_f[None]])
    else:
        # shrink towards the best vertex
        xs = xs[0] + 0.5 * (xs - xs[0])
        fs = torch.func.vmap(f)(xs)
    return _NMState(xs=xs, fs=fs, it=s.it + 1)


def _nm_init(f, x0, scale, device) -> _NMState:
    x0 = as_tensor(x0, device)
    x0 = x0.to(default_float_for(x0.dtype))
    xs = x0[None, :] + scale * regular_simplex(x0.numel(), x0.dtype,
                                               x0.device)
    return _NMState(xs=xs, fs=torch.func.vmap(f)(xs),
                    it=torch.zeros((), dtype=torch.int32, device=x0.device))


def min_nelder_mead_gen(f, x0, scale: float = 1.0, device=None):
    """Generator yielding (x_best, f_best) per iteration. An array-like x0
    goes to ``device`` (default ``config.default_device``)."""
    s = _nm_init(f, x0, scale, device)
    while True:
        i = torch.argmin(s.fs)
        yield s.xs[i], s.fs[i]
        s = _nm_step(f, s)


def min_nelder_mead(f, x0, scale: float = 1.0, ftol: float = 1e-12,
                    max_iter: int = 2000, device=None):
    """Nelder-Mead until the spread of f over the simplex is ≤
    ftol·(1 + |f_best|) or ``max_iter`` iterations. Returns (x, f,
    n_iter). An array-like x0 goes to ``device`` (default
    ``config.default_device``)."""
    s = _nm_init(f, x0, scale, device)
    while read((s.it < max_iter) & (s.fs.max() - s.fs.min()
                                    > ftol * (1 + s.fs.min().abs()))):
        s = _nm_step(f, s)
    i = torch.argmin(s.fs)
    return s.xs[i], s.fs[i], s.it
