"""Typed optimisation errors, the counterpart of
``nd4js_tpu/opt/optimization_error.py``. Raised by the ``*_gen``
generators; the drivers (``lsq_lm``, ``odr_lm``, ...) stop instead, with
the stuck counter in their state."""
from __future__ import annotations

__all__ = ["OptimizationNoProgressError"]


class OptimizationNoProgressError(RuntimeError):
    def __init__(self, message: str = "Optimization makes no progress.",
                 x=None):
        super().__init__(message)
        self.x = x
