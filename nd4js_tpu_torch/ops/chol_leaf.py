"""Cholesky leaves of the half/half recursion: the CUDA kernel
``csrc/chol_leaf.cu`` (the port of ``nd4js_tpu/ops/chol_leaf.py``), its
plain PyTorch version, its launch plan and a launch counter.

Outputs (L, L⁻¹ or None) of a batch (Nb, n, n) of SPD blocks, n ≤ 64:
L lower triangular with zeros above, A = L·Lᵀ. Both versions read only
the lower triangle of A, as ``_chol_base`` does
(``nd4js_tpu/la/cholesky.py:51-68``); the TPU kernel reads the transposed
block as it is (``chol_leaf.py:116-117``), which is the same only for
exactly symmetric input. Non-SPD input gives NaN, not an exception.

The kernel runs one thread block a matrix, right-looking with the inverse
formed in the same loop; :func:`plan` chooses the warps a block.
"""
from __future__ import annotations

import functools

import torch

from ..core.mm import mm
from . import _build
from ._build import SM_SMEM, SMS

__all__ = ["LEAF", "WARPS", "blocks_per_sm", "card_plan", "chol_leaf",
           "chol_leaf_ref", "plan"]

LEAF = 64          # widest leaf the kernel takes
# Warps a block, the kernel's instances (launch_w). Blocks of 2 and 4
# warps, for more matrices an SM at a large batch, were slower at every
# batch of the main path, 1024 included (PERF.md §6).
WARPS = (8, 16)

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


def blocks_per_sm(warps: int, n: int, dtype: torch.dtype) -> int:
    """Blocks of ``warps`` warps that one SM holds at once, as the kernel's
    launch bounds guarantee them (``min_blocks``: 16 / warps float32
    blocks, half as many float64) and as its shared memory (an n × (n + 1)
    block and the two columns of the broadcast) and the SM's 2048 threads
    allow."""
    elem = torch.finfo(dtype).bits // 8
    bound = max(1, 16 // warps // (elem // 4))
    smem = elem * (n * (n + 1) + 2 * LEAF) + 1024
    return min(bound, SM_SMEM // smem, 2048 // (32 * warps))


@functools.lru_cache(maxsize=256)
def plan(nb: int, n: int, dtype: torch.dtype, with_inv: bool,
         sms: int = SMS) -> int:
    """Warps a block for a batch of ``nb`` leaves of n × n on a card of
    ``sms`` SMs: the most of WARPS (the shorter dependent step, as each
    warp then updates fewer columns) whose blocks the card holds all at
    once by :func:`blocks_per_sm`, or the fewest when none does. A batch
    of 32 or 1 takes 16 warps; 1024 leaves take 8: in float32 the launch
    bounds promise two blocks of 8 warps an SM, so 264 at once and four
    waves, which measured faster than more, smaller blocks (PERF.md §6).
    ``with_inv`` is an input because the inverse's registers (X, 2·64/W
    a thread) are what a layout must hold within its launch bounds; both
    layouts hold them under the same bounds, and each measured fastest at
    the same batches with and without the inverse, so today it does not
    change the choice.
    Raises ValueError for a leaf the kernel does not take."""
    if not 0 <= n <= LEAF or nb < 0:
        raise ValueError(f"chol_leaf: needs 0 <= n <= {LEAF} and nb >= 0, "
                         f"got nb={nb}, n={n}")
    fits = [w for w in WARPS
            if nb <= blocks_per_sm(w, n, dtype) * sms]
    return max(fits) if fits else min(WARPS)


def card_plan(nb: int, n: int, dtype: torch.dtype, with_inv: bool,
              device) -> int:
    """:func:`plan` with the SM count of the card of ``device``."""
    return plan(nb, n, dtype, with_inv, _build.sms(device))


def chol_leaf(a: torch.Tensor, with_inv: bool):
    """Cholesky factor (and L⁻¹ when ``with_inv``) of a batch (Nb, n, n)
    of SPD blocks, n ≤ LEAF, reading only the lower triangle.

    A CUDA tensor runs the kernel with the warps of :func:`card_plan` (or
    raises); a CPU tensor runs :func:`chol_leaf_ref`.
    """
    on_card = _build.check_operand(a, "chol_leaf", 3)
    nb, n, n2 = a.shape
    if n != n2 or n > LEAF:
        raise ValueError(f"chol_leaf: needs square blocks of at most {LEAF}, "
                         f"got {tuple(a.shape)}")
    if not on_card:
        return chol_leaf_ref(a, with_inv)
    return _chol_leaf_in(a, with_inv,
                         card_plan(nb, n, a.dtype, with_inv, a.device))


def _chol_leaf_in(a: torch.Tensor, with_inv: bool, warps: int):
    """:func:`chol_leaf` on a CUDA tensor with ``warps`` warps a block (one
    of WARPS; the card's checks run each)."""
    global launches
    nb, n, _ = a.shape
    a = a.contiguous()
    l = torch.empty_like(a)
    li = torch.empty_like(a) if with_inv else None
    f64 = a.dtype == torch.float64
    _build.launch("nd4js_chol_leaf_f64" if f64 else "nd4js_chol_leaf_f32",
                  a.device, a, l, li, nb, n, warps)
    launches += 1
    return l, li
