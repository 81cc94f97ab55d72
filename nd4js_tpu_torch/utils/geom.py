"""Geometry helpers, the counterpart of ``nd4js_tpu/utils/geom.py``:
``regular_simplex``, Nelder-Mead's initial simplex."""
from __future__ import annotations

import torch

from .. import config

__all__ = ["regular_simplex"]


def regular_simplex(n: int, dtype=None, device=None):
    """(n+1, n) vertices of a regular simplex centred at the origin: the
    vertices are pairwise equidistant. ``dtype`` defaults to
    ``config.default_float`` and ``device`` to ``config.default_device``."""
    dtype = dtype or config.default_float
    device = config.default_device if device is None else device
    # the classic construction: a scaled identity and a constant vector
    a = (1.0 - 1.0 / (n + 1) ** 0.5) / n
    base = torch.eye(n, dtype=dtype, device=device) - a
    last = -torch.ones((1, n), dtype=dtype, device=device) / (n + 1) ** 0.5
    v = torch.cat([base, last], 0)
    return v - v.mean(0, keepdim=True)
