"""Matrix-product helpers for library internals.

Every GEMM inside a decomposition or solve goes through these, the
counterpart of ``nd4js_tpu/core/mm.py``. ``config`` pins float32
products to full precision (no TF32), so a plain ``torch.matmul`` keeps
the accuracy contracts in float32 and float64.
"""
from __future__ import annotations

import torch

from .. import config  # noqa: F401  (imported for its precision pin)

__all__ = ["mm", "mt", "einsum"]


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matrix product with broadcasting over leading dims."""
    return torch.matmul(a, b)


def mt(a: torch.Tensor) -> torch.Tensor:
    """Transpose of the trailing two axes (no conjugation)."""
    return a.transpose(-1, -2)


def einsum(subscripts: str, *operands) -> torch.Tensor:
    """``torch.einsum`` at the library's pinned precision (no TF32)."""
    return torch.einsum(subscripts, *operands)
