"""Square-system solve, the counterpart of ``nd4js_tpu/la/solve.py``:
rank-revealing QR (the ``rrqr_kernel`` kernel), then the masked solve,
which raises SingularMatrixSolveError on a numerically singular matrix."""
from __future__ import annotations

from ..convert import as_tensor
from .rrqr import rrqr_decomp, rrqr_solve

__all__ = ["solve"]


def solve(a, y, device=None):
    """Solve A @ x = y for square A, batched over leading dims. An
    array-like ``a`` goes to ``device`` (default
    ``config.default_device``); y follows A."""
    a = as_tensor(a, device)
    if a.shape[-1] != a.shape[-2]:
        raise ValueError("solve() requires square matrices; use lstsq()")
    q, r, p = rrqr_decomp(a)
    return rrqr_solve(q, r, p, y)
