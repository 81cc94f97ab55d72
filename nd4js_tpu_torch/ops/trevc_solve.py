"""All eigenvectors of split-complex upper triangular matrices by xTREVC
backward substitution: the CUDA kernel ``csrc/trevc_solve.cu`` (the port
of ``nd4js_tpu/ops/trevc_solve.py::trevc_solve``), its plain PyTorch
version, and a launch counter.

Solves (Tc − λ_k)·x_k = 0 for every column k at once, x[k, k] = 1 and
x[j > k, k] = 0, rows bottom-up: a pivot with |T[i, i] − λ_k| ≤ smallnum
is clamped to smallnum (a repeated eigenvalue then amplifies the earlier
eigendirection), the division is Smith's, and a column whose new entry
exceeds bignum is rescaled as a whole.

The kernel runs one thread block a tile of adjacent columns, x of the
tile in shared memory, the reference's 64-row blocks bottom-up with the
contraction below each block and the in-block recurrence on running sums;
:func:`plan` cuts the columns into uniform tiles of TILE columns.
"""
from __future__ import annotations

import functools

import torch

from ..core import cpx
from . import _build
from ._build import SMS

__all__ = ["TILE", "W_MAX", "card_plan", "plan", "smem_bytes",
           "trevc_solve", "trevc_solve_ref"]

NB = 64            # kNB: rows a block of the recurrence (the reference's nbk)
W_MAX = 8          # kWMax: columns a tile, one warp each
# Columns a tile of the plan: at (1, 1024, 1024) in float32 on an H100,
# uniform tiles of 4 (256 blocks, two an SM at most) were the fastest and
# steadiest of uniform tiles of 1, 2, 3, 4, 6 and 8 and of a plan narrow at
# the right and wide at the left (PERF.md §6); tiles of 2 varied by 2x.
TILE = 4

# Kernel launches since the last reset; only trevc_solve's CUDA branch adds
# to it, one per call (one call is the whole batch).
launches = 0

def trevc_solve_ref(tc_re, tc_im, lam_re, lam_im, smallnum, bignum: float,
                    nbk: int = 64):
    """Plain PyTorch version of the kernel: the blocked backward
    substitution ``_trevc_backsub_blocked``
    (``nd4js_tpu/la/schur.py:963-1035``) with the batch axis written out.
    Rows are processed in blocks of nbk bottom-up; each block's sum over the
    rows below it is one complex GEMM, the in-block recurrence runs row by
    row (nbk ≥ n − 1: the unblocked loop). tc: (B, n, n), lam: (B, n),
    smallnum: (B,). Returns x (re, im)."""
    B, n, _ = tc_re.shape
    dt, dev = tc_re.dtype, tc_re.device
    col = torch.arange(n, device=dev)
    small = smallnum[:, None]
    x = (torch.eye(n, dtype=dt, device=dev).repeat(B, 1, 1),
         tc_re.new_zeros((B, n, n)))
    b1 = n - 1                      # row n − 1 keeps its unit
    while b1 > 0:
        b0 = max(0, b1 - nbk)
        nb = b1 - b0
        tb = (tc_re[:, b0:b1, b0:b1], tc_im[:, b0:b1, b0:b1])
        # rows ≥ b1 of x are final: one complex GEMM for the whole block
        accp = cpx.matmul((tc_re[:, b0:b1, b1:], tc_im[:, b0:b1, b1:]),
                          (x[0][:, b1:], x[1][:, b1:]))
        xb = (x[0][:, b0:b1].clone(), x[1][:, b0:b1].clone())
        ftot = tc_re.new_ones((B, n))
        for step in range(nb):
            il = nb - 1 - step
            i = b0 + il
            trow = (tb[0][:, il, il + 1:, None], tb[1][:, il, il + 1:, None])
            prod = cpx.mul(trow, (xb[0][:, il + 1:], xb[1][:, il + 1:]))
            acc = (prod[0].sum(1) + accp[0][:, il],
                   prod[1].sum(1) + accp[1][:, il])
            den = (tb[0][:, il, il, None] - lam_re,
                   tb[1][:, il, il, None] - lam_im)
            clamp = cpx.cabs(den) <= small
            den = (torch.where(clamp, small, den[0]),
                   torch.where(clamp, 0.0, den[1]))
            xi = cpx.div((-acc[0], -acc[1]), den)
            xi = (torch.where(col > i, xi[0], torch.where(col == i, 1.0, 0.0)),
                  torch.where(col > i, xi[1], 0.0))
            m = torch.maximum(xi[0].abs(), xi[1].abs())
            f = torch.where(m > bignum, 1.0 / torch.where(m > bignum, m, 1.0),
                            1.0)
            fr = f[:, None, :]
            xb = (xb[0] * fr, xb[1] * fr)
            xb[0][:, il] = xi[0] * f
            xb[1][:, il] = xi[1] * f
            accp = (accp[0] * fr, accp[1] * fr)
            ftot = ftot * f
        fr = ftot[:, None, :]
        x = (torch.cat([x[0][:, :b0], xb[0], x[0][:, b1:] * fr], 1),
             torch.cat([x[1][:, :b0], xb[1], x[1][:, b1:] * fr], 1))
        b1 = b0
    return x


def smem_bytes(rows: int, w: int, dtype: torch.dtype) -> int:
    """Shared memory of a block whose tile is w columns, the last of them
    rows − 1: the diagonal block (64 rows of 65, both parts), the sums
    below the block (64 rows of w + 1, both parts) and x of the tile."""
    elem = torch.finfo(dtype).bits // 8
    return elem * (2 * NB * (NB + 1) + 2 * NB * (w + 1) + 2 * rows * w)


@functools.lru_cache(maxsize=256)
def plan(B: int, n: int, dtype: torch.dtype, sms: int = SMS):
    """Tiles of the kernel's launch on a batch (B, n, n): ((first column,
    width), ...), the rightmost first (the block scheduler starts the
    longest chains first), covering the columns 0 … n − 1 once.

    Uniform tiles of TILE columns from the right (the leftmost narrower
    when TILE does not divide n), or of the most columns whose x fits a
    block's shared memory when TILE's does not. Only one batch on one
    card was timed, B = 1 on 132 SMs, so neither B nor ``sms`` changes
    the width.
    Raises ValueError for n < 1 and for an n whose x does not fit one
    block even one column wide.
    """
    if n < 1 or B < 0:
        raise ValueError(f"trevc_solve: needs n >= 1 and B >= 0, got "
                         f"B={B}, n={n}")
    w = next((w for w in range(TILE, 0, -1)
              if smem_bytes(n, w, dtype) <= _build.SMEM_MAX), None)
    if w is None:
        raise ValueError(f"trevc_solve: x of one column of n={n} ({dtype}) "
                         f"does not fit a block's shared memory")
    return tuple((max(0, k1 - w), k1 - max(0, k1 - w))
                 for k1 in range(n, 0, -w))


def card_plan(B: int, n: int, dtype: torch.dtype, device):
    """:func:`plan` with the SM count of the card of ``device``."""
    return plan(B, n, dtype, _build.sms(device))


@functools.lru_cache(maxsize=64)
def _tiles_on(tiles: tuple, device) -> torch.Tensor:
    """The tiles as the kernel reads them, (first column, width) int32
    pairs, on ``device`` (made once per plan and card)."""
    return torch.tensor([v for t in tiles for v in t], dtype=torch.int32,
                        device=device)


def trevc_solve(tc_re, tc_im, lam_re, lam_im, smallnum, bignum: float):
    """Every eigenvector column of the upper triangular split-complex
    batch tc (B, n, n) with diagonal lam (B, n): x (re, im) with
    x[k, k] = 1 (up to growth rescaling) and x[j > k, k] = 0.
    smallnum: (B,) pivot clamp, bignum: the growth threshold.

    A CUDA tensor runs the kernel on the tiles of :func:`card_plan` (or
    raises); a CPU tensor runs :func:`trevc_solve_ref`.
    """
    on_card = _build.check_operand(tc_re, "trevc_solve", 3)
    B, n, n2 = tc_re.shape
    if n != n2 or tuple(tc_im.shape) != (B, n, n) \
            or tuple(lam_re.shape) != (B, n) or tuple(lam_im.shape) != (B, n) \
            or tuple(smallnum.shape) != (B,):
        raise ValueError(f"trevc_solve: needs tc (B, n, n) pairs, lam (B, n) "
                         f"and smallnum (B,), got {tuple(tc_re.shape)}, "
                         f"{tuple(lam_re.shape)}, {tuple(smallnum.shape)}")
    if not on_card:
        return trevc_solve_ref(tc_re, tc_im, lam_re, lam_im, smallnum, bignum)
    return _trevc_solve_in(tc_re, tc_im, lam_re, lam_im, smallnum, bignum,
                           card_plan(B, n, tc_re.dtype, tc_re.device))


def _trevc_solve_in(tc_re, tc_im, lam_re, lam_im, smallnum, bignum: float,
                    tiles, stages: int = 3):
    """:func:`trevc_solve` on CUDA tensors on the given tiles (any that
    cover the columns once, at most W_MAX wide; the card's checks run the
    plan's and uniform ones). ``stages`` 1 runs only the contractions below
    the row blocks and 2 only the in-block recurrences (on unit sums), to
    time them apart; x is then not the eigenvectors."""
    global launches
    B, n, _ = tc_re.shape
    args = [t.to(tc_re.dtype).contiguous()
            for t in (tc_re, tc_im, lam_re, lam_im, smallnum)]
    xre = torch.empty_like(args[0])
    xim = torch.empty_like(args[0])
    smem = max(smem_bytes(k0 + w, w, tc_re.dtype) for k0, w in tiles)
    if smem > _build.SMEM_MAX:
        raise ValueError(f"trevc_solve: a tile of {tiles} needs {smem} bytes "
                         f"of shared memory, over {_build.SMEM_MAX}")
    f64 = tc_re.dtype == torch.float64
    _build.launch("nd4js_trevc_solve_f64" if f64 else "nd4js_trevc_solve_f32",
                  tc_re.device, *args, _tiles_on(tuple(tiles), tc_re.device),
                  xre, xim, B, n, len(tiles), smem, float(bignum), stages)
    launches += 1
    return xre, xim
