"""Compensated accumulation, the counterpart of ``nd4js_tpu/core/kahan.py``.

``kahan_sum`` is the Kahan-Babuška (Neumaier) sum along an axis. The JAX
package runs it as a ``lax.scan``; the port runs the same recurrence in
the CUDA kernel ``csrc/kahan_sum.cu`` (``ops.kahan_sum``), one thread a
lane, and on the CPU in that kernel's plain version. Both round as the
scan does, so the results are bit-equal to the JAX package's.
"""
from __future__ import annotations

import math

import torch

from ..convert import as_tensor
from ..ops.kahan_sum import kahan_sum_cols

__all__ = ["kahan_sum", "two_sum", "kahan_dot"]


def two_sum(a, b):
    """Error-free transformation: a + b = s + err exactly (Knuth)."""
    s = a + b
    bb = s - a
    err = (a - bb) + (b - (s - bb))
    return s, err


def kahan_sum(x, axis=None, device=None):
    """Compensated (Kahan-Babuška) sum along ``axis`` (all elements when
    None), float32 or float64 (other dtypes raise TypeError).

    Sequential over the reduced axis: a CUDA tensor runs one kernel thread
    a lane of the other axes. Array-likes go to ``device`` (default
    ``config.default_device``); tensors keep theirs.
    """
    x = as_tensor(x, device)
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    x = x.movedim(axis, 0)
    rest = x.shape[1:]
    out = kahan_sum_cols(x.reshape(x.shape[0], math.prod(rest)))
    return out.reshape(rest)


def kahan_dot(a, b, axis=-1, device=None):
    """Compensated inner product sum(a*b) along ``axis``. The product is
    rounded on its own before the sum, as in the JAX package."""
    a = as_tensor(a, device)
    if device is None and not isinstance(b, torch.Tensor):
        device = a.device
    return kahan_sum(a * as_tensor(b, device), axis=axis)
