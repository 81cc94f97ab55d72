"""Debug assertions, the counterpart of ``nd4js_tpu/core/debug.py``.

PyTorch runs eagerly, so a check reads its value back and raises at
once. With ``config.debug_checks`` off (the default) the checks do
nothing and never synchronise with the device.
"""
from __future__ import annotations

import torch

from .. import config

__all__ = ["DebugCheckError", "dassert", "dcheck_finite"]


class DebugCheckError(AssertionError):
    """Raised when a debug_checks invariant fails."""


def dassert(cond, msg: str):
    """Raise DebugCheckError unless every element of ``cond`` holds,
    when config.debug_checks is on."""
    if not config.debug_checks:
        return
    if not bool(torch.as_tensor(cond).all()):
        raise DebugCheckError(f"nd4js_tpu_torch debug check failed: {msg}")


def dcheck_finite(x, msg: str):
    """Assert every floating tensor in ``x`` (a tensor or a tuple/list
    of them) is finite, when config.debug_checks is on."""
    if not config.debug_checks:
        return
    leaves = x if isinstance(x, (tuple, list)) else (x,)
    for leaf in leaves:
        if leaf.is_floating_point():
            dassert(torch.isfinite(leaf), f"{msg}: non-finite values")
