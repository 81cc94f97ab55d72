"""Overflow/underflow-safe norms, the counterpart of
``nd4js_tpu/la/norm.py``: scale by the largest magnitude, then take the
sum of squares of the scaled entries (two passes, no branches)."""
from __future__ import annotations

import torch

from ..convert import as_tensor

__all__ = ["norm", "norm_fro", "safe_norm_2"]


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


def safe_norm_2(x, axis=-1, keepdims: bool = False, device=None):
    """2-norm of vectors along ``axis``, overflow/underflow safe."""
    return norm_fro(x, axis=axis, keepdims=keepdims, device=device)


def norm(a, ord="fro", axes=None, device=None):
    """Matrix or tensor norm; only 'fro' (or None) exists, as in the JAX
    package: over ``axes``, or over every axis when None."""
    if ord in ("fro", None):
        return norm_fro(a, axis=None if axes is None else tuple(axes),
                        device=device)
    raise NotImplementedError(
        f"norm ord={ord!r} (reference supports 'fro' only)")
