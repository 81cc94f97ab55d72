"""Batched matrix multiplication, the counterpart of
``nd4js_tpu/la/matmul.py``: ``matmul2`` with its dtype promotion (the
least upper bound in the order int32 < float32 < float64 < complex64 <
complex128, ``nd4js_tpu/dt.py:super_dtype``, copied here, then integers
to float64), and the n-ary ``matmul``, parenthesised by the classic
matrix-chain-order dynamic program on the host: shapes are known before
any product runs, so the order costs nothing on the device."""
from __future__ import annotations

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core.mm import mm

__all__ = ["matmul", "matmul2"]

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


def _chain_order(dims):
    """Matrix-chain-order DP (``nd4js_tpu/la/matmul.py:41-61``):
    ``dims[i], dims[i+1]`` are the (rows, cols) of matrix i. Returns the
    split table s, s[i][j] the optimal split point of the product i..j
    (the first of equal costs)."""
    n = len(dims) - 1
    m = [[0] * n for _ in range(n)]
    s = [[0] * n for _ in range(n)]
    for length in range(2, n + 1):
        for i in range(0, n - length + 1):
            j = i + length - 1
            m[i][j] = float("inf")
            for k in range(i, j):
                cost = m[i][k] + m[k + 1][j] \
                    + dims[i] * dims[k + 1] * dims[j + 1]
                if cost < m[i][j]:
                    m[i][j] = cost
                    s[i][j] = k
    return s


def matmul(*matrices, device=None) -> torch.Tensor:
    """n-ary matmul, parenthesised by :func:`_chain_order` to minimise
    the flops; each product is :func:`matmul2` (leading dims broadcast).
    Array-likes go to ``device`` (default ``config.default_device``)."""
    if len(matrices) == 0:
        raise ValueError("matmul() requires at least one operand")
    mats = [as_tensor(m, device) for m in matrices]
    if len(mats) == 1:
        return mats[0]
    if len(mats) == 2:
        return matmul2(*mats)
    dims = [m.shape[-2] for m in mats] + [mats[-1].shape[-1]]
    for x, y in zip(mats[:-1], mats[1:]):
        if x.shape[-1] != y.shape[-2]:
            raise ValueError("inner dimensions mismatch in matmul chain")
    s = _chain_order(dims)

    def mult(i, j):
        if i == j:
            return mats[i]
        k = s[i][j]
        return matmul2(mult(i, k), mult(k + 1, j))

    return mult(0, len(mats) - 1)
