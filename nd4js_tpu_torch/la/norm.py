"""Overflow/underflow-safe Frobenius norm, the counterpart of
``nd4js_tpu/la/norm.py``: scale by the largest magnitude, then take the
sum of squares of the scaled entries (two passes, no branches)."""
from __future__ import annotations

import torch

__all__ = ["norm_fro"]


def norm_fro(a: torch.Tensor, axis=None, keepdims: bool = False):
    """Frobenius norm over ``axis`` (an int, a tuple, or None for all)."""
    dims = tuple(range(a.ndim)) if axis is None else axis
    if isinstance(dims, int):
        dims = (dims,)
    mag = a.abs()
    amax = torch.amax(mag, dim=dims, keepdim=True)
    scale = torch.where(amax > 0, amax, torch.ones_like(amax))
    out = scale * torch.sqrt(((mag / scale) ** 2).sum(dim=dims, keepdim=True))
    if keepdims:
        return out
    return out.squeeze(dims) if dims else out
