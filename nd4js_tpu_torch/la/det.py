"""Determinants, the counterpart of ``nd4js_tpu/la/det.py``: triangular
ones from the diagonal, general ones through partially pivoted LU (the
permutation's sign is exact)."""
from __future__ import annotations

import torch

from ..convert import as_tensor
from .lu import lu_decomp

__all__ = ["det", "slogdet", "det_tri", "slogdet_tri"]


def det_tri(a, device=None):
    """Determinant of a triangular matrix, batched."""
    return torch.diagonal(as_tensor(a, device), dim1=-2, dim2=-1).prod(-1)


def slogdet_tri(a, device=None):
    """(sign, log|det|) of a triangular matrix, batched."""
    d = torch.diagonal(as_tensor(a, device), dim1=-2, dim2=-1)
    return d.sign().prod(-1), d.abs().log().sum(-1)


def _perm_sign(p: torch.Tensor) -> torch.Tensor:
    """Parity of a permutation vector, batched: (−1)^inversions, by
    pairwise comparison (O(n²), vectorised)."""
    n = p.shape[-1]
    less = p[..., :, None] > p[..., None, :]
    upper = torch.ones((n, n), dtype=torch.bool, device=p.device).triu(1)
    inversions = (less & upper).sum(dim=(-2, -1))
    return 1.0 - 2.0 * (inversions % 2)


def det(a, device=None):
    """Determinant via pivoted LU, batched over leading dims."""
    lu, p = lu_decomp(a, device)
    d = torch.diagonal(lu, dim1=-2, dim2=-1)
    return d.prod(-1) * _perm_sign(p).to(lu.dtype)


def slogdet(a, device=None):
    """(sign, log|det|) via pivoted LU, batched over leading dims."""
    lu, p = lu_decomp(a, device)
    d = torch.diagonal(lu, dim1=-2, dim2=-1)
    sign = d.sign().prod(-1) * _perm_sign(p).to(lu.dtype)
    return sign, d.abs().log().sum(-1)
