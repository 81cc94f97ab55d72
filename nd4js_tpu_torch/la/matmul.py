"""Batched matrix multiplication, the counterpart of ``matmul2`` in
``nd4js_tpu/la/matmul.py``, with its dtype promotion: the least upper
bound in the order int32 < float32 < float64 < complex64 < complex128
(``nd4js_tpu/dt.py:super_dtype``, copied here), then integers to
float64."""
from __future__ import annotations

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core.mm import mm

__all__ = ["matmul2"]

_RANK = {torch.int32: 0, torch.float32: 1, torch.float64: 2,
         torch.complex64: 3, torch.complex128: 4}


def _super_dtype(*dtypes) -> torch.dtype:
    for d in dtypes:
        if d not in _RANK:
            raise ValueError(
                f"Invalid dtype '{d}'. Must be one of "
                f"{sorted(str(k) for k in _RANK)}.")
    return max(dtypes, key=_RANK.__getitem__)


def matmul2(a, b, device=None) -> torch.Tensor:
    """Batched GEMM with broadcasting over leading dims. Array-likes go to
    ``device`` (default ``config.default_device``)."""
    a, b = as_tensor(a, device), as_tensor(b, device)
    if a.ndim < 2 or b.ndim < 2:
        raise ValueError("matmul2 expects ndim >= 2 operands")
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"inner dimensions mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    dtype = default_float_for(_super_dtype(a.dtype, b.dtype))
    return mm(a.to(dtype), b.to(dtype))
