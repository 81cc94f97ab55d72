"""Cholesky leaves of the half/half recursion: the CUDA kernel
``csrc/chol_leaf.cu`` (the port of ``nd4js_tpu/ops/chol_leaf.py``), its
plain PyTorch version, and a launch counter.

Outputs (L, L⁻¹ or None) of a batch (Nb, n, n) of SPD blocks, n ≤ 64:
L lower triangular with zeros above, A = L·Lᵀ. Both versions read only
the lower triangle of A, as ``_chol_base`` does
(``nd4js_tpu/la/cholesky.py:51-68``); the TPU kernel reads the transposed
block as it is (``chol_leaf.py:116-117``), which is the same only for
exactly symmetric input. Non-SPD input gives NaN, not an exception.
"""
from __future__ import annotations

import torch

from ..core.mm import mm
from . import _build

__all__ = ["LEAF", "chol_leaf", "chol_leaf_ref"]

LEAF = 64          # widest leaf the kernel takes

# Kernel launches since the last reset; only chol_leaf's CUDA branch adds
# to it.
launches = 0


def _chol_base(a: torch.Tensor) -> torch.Tensor:
    """Classical column-by-column Cholesky (``la/cholesky.py:51-68``):
    column j is A[:, j] minus the earlier columns' contribution, over the
    square root of its diagonal entry. Entries above the diagonal take no
    part in the lower factor and are cut by the final ``tril``."""
    n = a.shape[-1]
    cols = []
    for j in range(n):
        col = a[..., :, j]
        if j:
            prev = torch.stack(cols, dim=-1)                 # (..., n, j)
            col = col - mm(prev, prev[..., j, :, None])[..., 0]
        d = torch.sqrt(col[..., j])
        cols.append(col / d[..., None])
    return torch.tril(torch.stack(cols, dim=-1))


def _inv_base(l: torch.Tensor) -> torch.Tensor:
    """Forward substitution against I for a lower-triangular block
    (``la/cholesky.py:71-87``), row by row."""
    n = l.shape[-1]
    eye = torch.eye(n, dtype=l.dtype, device=l.device)
    rows = []
    for i in range(n):
        xi = eye[i]
        if i:
            prev = torch.stack(rows, dim=-2)                 # (..., i, n)
            xi = xi - mm(l[..., i, None, :i], prev)[..., 0, :]
        rows.append(xi / l[..., i, i, None])
    return torch.stack(rows, dim=-2)


def chol_leaf_ref(a: torch.Tensor, with_inv: bool):
    """Plain PyTorch version of the kernel: ``_chol_base`` and, when
    asked, ``_inv_base``."""
    l = _chol_base(a)
    return l, (_inv_base(l) if with_inv else None)


def chol_leaf(a: torch.Tensor, with_inv: bool):
    """Cholesky factor (and L⁻¹ when ``with_inv``) of a batch (Nb, n, n)
    of SPD blocks, n ≤ LEAF, reading only the lower triangle.

    A CUDA tensor runs the kernel (or raises); a CPU tensor runs
    :func:`chol_leaf_ref`.
    """
    global launches
    on_card = _build.check_operand(a, "chol_leaf", 3)
    nb, n, n2 = a.shape
    if n != n2 or n > LEAF:
        raise ValueError(f"chol_leaf: needs square blocks of at most {LEAF}, "
                         f"got {tuple(a.shape)}")
    if not on_card:
        return chol_leaf_ref(a, with_inv)
    a = a.contiguous()
    l = torch.empty_like(a)
    li = torch.empty_like(a) if with_inv else None
    f64 = a.dtype == torch.float64
    _build.launch("nd4js_chol_leaf_f64" if f64 else "nd4js_chol_leaf_f32",
                  a.device, a, l, li, nb, n)
    launches += 1
    return l, li
