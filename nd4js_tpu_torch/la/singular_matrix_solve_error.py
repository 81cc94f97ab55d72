"""Typed error carrying the best-effort solution, the counterpart of
``nd4js_tpu/la/singular_matrix_solve_error.py``.

The square-solve facades raise it when the matrix is numerically
singular; ``.x`` carries the same masked, rank-truncated solution the
solvers return.
"""
from __future__ import annotations

__all__ = ["SingularMatrixSolveError"]


class SingularMatrixSolveError(ArithmeticError):
    """Raised by square-solve facades when the matrix is numerically
    singular. ``.x`` carries the best-effort (rank-truncated) solution."""

    def __init__(self, x, message: str = "Matrix is singular."):
        super().__init__(message)
        self.x = x
