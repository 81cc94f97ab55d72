"""Golden-section 1-D minimisation, the counterpart of
``nd4js_tpu/opt/gss.py``: a host loop that reads one flag an iteration,
whether the bracket is still wider than eps·(|lo| + |hi|); each step
selects its side with ``torch.where`` and, as the JAX package, evaluates
f at both new candidates and keeps the one its side needs.
"""
from __future__ import annotations

import math

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core.host import read

__all__ = ["min1d_gss"]

_INVPHI = (math.sqrt(5.0) - 1.0) / 2.0


def min1d_gss(f, a, b, max_iter: int = 200, device=None):
    """Minimise a unimodal f on [a, b] to floating-point precision. Python
    numbers become float64 tensors on ``device`` (default
    ``config.default_device``); a float tensor keeps its dtype."""
    a = as_tensor(a, device)
    a = a.to(default_float_for(a.dtype))
    b = as_tensor(b, a.device).to(a.dtype)
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    eps = torch.finfo(a.dtype).eps
    c = hi - _INVPHI * (hi - lo)
    d = lo + _INVPHI * (hi - lo)
    fc, fd = f(c), f(d)
    i = 0
    while i < max_iter and read(hi - lo > eps * (lo.abs() + hi.abs())):
        right = fc < fd                     # the minimum is left of d
        hi, lo = torch.where(right, d, hi), torch.where(right, lo, c)
        c, d = (torch.where(right, hi - _INVPHI * (hi - lo), d),
                torch.where(right, c, lo + _INVPHI * (hi - lo)))
        fc, fd = (torch.where(right, f(c), fd),
                  torch.where(right, fc, f(d)))
        i += 1
    return torch.where(fc < fd, c, d)
