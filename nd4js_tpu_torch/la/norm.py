"""Overflow/underflow-safe Frobenius norm, the counterpart of
``nd4js_tpu/la/norm.py``: scale by the largest magnitude, then take the
sum of squares of the scaled entries (two passes, no branches)."""
from __future__ import annotations

import torch

from ..convert import as_tensor

__all__ = ["norm_fro"]


def norm_fro(a, axis=None, keepdims: bool = False, device=None):
    """Frobenius norm over ``axis`` (an int, a tuple, or None for all).
    An empty tuple reduces nothing and gives |a|, as ``jnp.max(axis=())``
    does. An array-like ``a`` goes to ``device`` (default
    ``config.default_device``)."""
    a = as_tensor(a, device)
    dims = tuple(range(a.ndim)) if axis is None else axis
    if isinstance(dims, int):
        dims = (dims,)
    mag = a.abs()
    # torch's reductions read dim=() as "every dim": reduce nothing there
    amax = torch.amax(mag, dim=dims, keepdim=True) if dims else mag
    scale = torch.where(amax > 0, amax, torch.ones_like(amax))
    ss = (mag / scale) ** 2
    out = scale * torch.sqrt(ss.sum(dim=dims, keepdim=True) if dims else ss)
    return out if keepdims else out.squeeze(dims)
