"""Parameter-linear least-squares curve fitting, the counterpart of
``nd4js_tpu/opt/fit_lin.py``: y ≈ Σ p_j·φ_j(x), with optional Tikhonov
regularisation, solved by ``la.lstsq`` (minimum norm, rank-aware; for
fewer than 128 basis functions the one-sided Jacobi SVD, whose tall
pre-QR runs ``house_panel`` and whose sweeps run ``jacobi_sweeps`` on the
card).
"""
from __future__ import annotations

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..la.svd import lstsq

__all__ = ["fit_lin"]


def fit_lin(x, y, funcs, regularization: float = 0.0, device=None):
    """Least-squares coefficients p (P,) for y ≈ Σ p_j·funcs[j](x).

    ``funcs``: a sequence of vectorised basis functions φ_j(x), or one
    function returning the (M, P) design matrix. ``regularization`` λ > 0
    appends √λ·I to the design matrix and P zeros to y. Array-likes go to
    ``device`` (default ``config.default_device``)."""
    x = as_tensor(x, device)
    y = as_tensor(y, x.device).reshape(-1)
    if callable(funcs):
        a = as_tensor(funcs(x), x.device)
    else:
        a = torch.stack([as_tensor(f(x), x.device).expand(y.shape)
                         for f in funcs], -1)
    a = a.to(default_float_for(a.dtype))
    y = y.to(a.dtype)
    if regularization > 0:
        p = a.shape[-1]
        lam = torch.sqrt(torch.tensor(regularization, dtype=a.dtype,
                                      device=a.device))
        a = torch.cat([a, lam * torch.eye(p, dtype=a.dtype,
                                          device=a.device)], 0)
        y = torch.cat([y, y.new_zeros(p)])
    return lstsq(a, y[:, None])[:, 0]
