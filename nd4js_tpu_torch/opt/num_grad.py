"""Numerical differentiation, the counterpart of
``nd4js_tpu/opt/num_grad.py``: 4-point central differences with
eps^(1/3)-scaled steps and cheap forward differences with √eps-scaled
ones, each step scaled by max(|x_i|, 1). The primary gradient path of the
port is ``torch.func``; these check user-supplied gradients.

The JAX package's ``jax.vmap`` over the coordinates is
``torch.func.vmap`` of the user's f over the stacked perturbed points, so
f is a torch function of one point.
"""
from __future__ import annotations

import numpy as np
import torch

from ..convert import as_tensor

__all__ = ["num_grad", "num_grad_forward"]


def _prepare(x, root):
    """(x as a float tensor, flat x, the step of each coordinate, the
    perturbations: row i is e_i·h_i). Integer input promotes to float64;
    the step's root of eps is taken in x's own precision, as numpy does
    for the JAX package."""
    x = as_tensor(x)
    if not x.dtype.is_floating_point:
        x = x.to(torch.float64)
    eps = np.finfo(str(x.dtype).removeprefix("torch.")).eps
    hh = float(root(eps)) * torch.clamp(x.abs(), min=1.0).reshape(-1)
    eye = torch.eye(x.numel(), dtype=x.dtype, device=x.device)
    return x, x.reshape(-1), hh, eye * hh[:, None]


def num_grad(f, h=None):
    """4-point central-difference gradient of a scalar function. Returns
    g(x) -> ∇f(x); an array-like x goes to ``config.default_device``."""
    def grad(x):
        x, flat, hh, d = _prepare(
            x, lambda eps: eps ** (1 / 3) if h is None else h)
        fv = torch.func.vmap(lambda z: f(z.reshape(x.shape)))
        g = (8 * (fv(flat + d) - fv(flat - d))
             - (fv(flat + 2 * d) - fv(flat - 2 * d))) / (12 * hh)
        return g.reshape(x.shape)

    return grad


def num_grad_forward(f, h=None):
    """Forward-difference gradient. Returns g(x) -> ∇f(x); an array-like
    x goes to ``config.default_device``."""
    def grad(x):
        x, flat, hh, d = _prepare(
            x, lambda eps: np.sqrt(eps) if h is None else h)
        f0 = f(x)
        g = (torch.func.vmap(lambda z: f(z.reshape(x.shape)))(flat + d)
             - f0) / hh
        return g.reshape(x.shape)

    return grad
