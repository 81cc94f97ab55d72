"""Iterator and range helpers, the counterpart of
``nd4js_tpu/utils/iter.py``: ``linspace`` (a tensor), lazy ranges,
products and repeats, and argmin/argmax/min/max over iterables, arrays
or tensors."""
from __future__ import annotations

import itertools

import numpy as np
import torch

from .. import config

__all__ = ["linspace", "irange", "cartesian_prod", "repeat",
           "argmin", "argmax", "imin", "imax"]


def linspace(start, stop, num: int = 50, dtype=None, device=None):
    """``num`` evenly spaced values from start to stop, both included.
    ``dtype`` defaults to ``config.default_float`` and ``device`` to
    ``config.default_device``."""
    return torch.linspace(
        start, stop, num, dtype=dtype or config.default_float,
        device=config.default_device if device is None else device)


def irange(*args):
    """Lazy integer range."""
    return range(*args)


def cartesian_prod(*iterables):
    """Lazy cartesian product."""
    return itertools.product(*iterables)


def repeat(value_or_iterable, n=None):
    """A value n times, or an iterable cyclically."""
    if n is None:
        return itertools.cycle(value_or_iterable)
    return itertools.repeat(value_or_iterable, n)


def _as_seq(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().reshape(-1)
    if isinstance(x, np.ndarray):
        return x.reshape(-1)
    return list(x)


def argmin(x, key=None):
    """Index of the minimum (the first, among equal ones)."""
    s = _as_seq(x)
    if key is not None:
        return min(range(len(s)), key=lambda i: key(s[i]))
    return int(np.argmin(s))


def argmax(x, key=None):
    """Index of the maximum (the first, among equal ones)."""
    s = _as_seq(x)
    if key is not None:
        return max(range(len(s)), key=lambda i: key(s[i]))
    return int(np.argmax(s))


def imin(x, key=None):
    s = _as_seq(x)
    return s[argmin(s, key)]


def imax(x, key=None):
    s = _as_seq(x)
    return s[argmax(s, key)]
