"""Partial-pivot LU with virtual pivoting: the CUDA kernels
``csrc/lu_panel.cu`` (the port of ``lu_panel`` and ``lu_gesv`` in
``nd4js_tpu/ops/lu_panel.py``), their plain PyTorch versions, and launch
counters.

Both eliminate column by column without moving rows. Step j picks as
pivot the row, among those not yet used, with the largest |A[row, j]|,
ties going to the lowest row index; it divides the other unused rows'
entries of column j by the pivot (by 1 where the pivot is 0, so a zero
column gives a zero L column) and subtracts their multiple of the pivot
row from their later columns. ``rank[row]`` records the step at which a
row became pivot, B if it never did. The TPU kernels' transposed panels,
stripes of 8, deferred stripe updates and bf16 splits were Mosaic
devices and are not ported: this is plain right-looking elimination, in
full float32/float64.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["lu_gesv", "lu_gesv_ref", "lu_panel", "lu_panel_ref"]

# Kernel launches since the last reset; only each wrapper's CUDA branch
# adds to its count.
launches = {"lu_panel": 0, "lu_gesv": 0}


def _eliminate(a: torch.Tensor, steps: int, rank: torch.Tensor) -> None:
    """``steps`` elimination steps in place on a (Nb, M, C) and its rank
    (Nb, M), which enters as all ``steps`` (unused)."""
    nb, m, _ = a.shape
    rows = torch.arange(m, device=a.device)
    batch = torch.arange(nb, device=a.device)
    for j in range(steps):
        unused = rank == steps
        col = a[:, :, j]
        cand = torch.where(unused, col.abs(), -torch.ones_like(col))
        cmax = cand.amax(dim=1, keepdim=True)
        # the lowest row holding the maximum; none (p = M) if it is NaN
        p = torch.where(cand == cmax, rows, m).amin(dim=1)
        is_p = rows == p[:, None]
        piv = torch.where(is_p, col, torch.zeros_like(col)).sum(dim=1)
        safe = torch.where(piv == 0, torch.ones_like(piv), piv)
        live = unused & ~is_p
        l = torch.where(live, col / safe[:, None], torch.zeros_like(col))
        a[:, :, j] = torch.where(live, l, col)
        u = a[batch, p.clamp(max=m - 1), j + 1:]                 # pivot row
        u = torch.where((p < m)[:, None], u, torch.zeros_like(u))
        a[:, :, j + 1:] = torch.where(live[:, :, None],
                                      a[:, :, j + 1:] - l[:, :, None]
                                      * u[:, None, :], a[:, :, j + 1:])
        rank.masked_fill_(is_p, j)


def lu_panel_ref(panel: torch.Tensor):
    """Plain PyTorch version of the ``lu_panel`` kernel: (factored panel
    with rows in input order, rank int32)."""
    out = panel.clone()
    nb, m, b = panel.shape
    rank = torch.full((nb, m), b, dtype=torch.int32, device=panel.device)
    _eliminate(out, b, rank)
    return out, rank


def lu_panel(panel: torch.Tensor):
    """Partial-pivot LU of a batched panel (Nb, M, B), M ≥ B, with
    virtual pivoting → (panel_factored (Nb, M, B), rank (Nb, M) int32).

    Rows stay in input order: the pivot row of step j (rank j) holds U's
    row j from column j on, and every other row holds its L multipliers
    in the columns of the steps before it became pivot. Sorting rows by
    (rank, index) gives the LAPACK-packed panel.

    A CUDA tensor runs the kernel (or raises); a CPU tensor runs
    :func:`lu_panel_ref`.
    """
    on_card = _build.check_operand(panel, "lu_panel", 3)
    nb, m, b = panel.shape
    if m < b:
        raise ValueError(f"lu_panel: needs M >= B, got {tuple(panel.shape)}")
    if not on_card:
        return lu_panel_ref(panel)
    out = panel.clone(memory_format=torch.contiguous_format)
    rank = torch.empty((nb, m), dtype=torch.int32, device=panel.device)
    f64 = panel.dtype == torch.float64
    _build.launch("nd4js_lu_panel_f64" if f64 else "nd4js_lu_panel_f32",
                  panel.device, out, rank, nb, m, b)
    launches["lu_panel"] += 1
    return out, rank


def lu_gesv_ref(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the ``lu_gesv`` kernel: elimination of
    [A | y], then back substitution on the rows sorted by rank."""
    nb, n, _ = a.shape
    buf = torch.cat([a, y], dim=-1)
    rank = torch.full((nb, n), n, dtype=torch.int32, device=a.device)
    _eliminate(buf, n, rank)
    order = torch.argsort(rank, dim=1)
    buf = torch.gather(buf, 1, order[:, :, None].expand(buf.shape))
    z = buf[:, :, n:].clone()
    x = torch.empty_like(z)
    for j in range(n - 1, -1, -1):
        # a zero pivot yields inf/nan, as in the kernel and lu.js
        x[:, j] = z[:, j] / buf[:, j, j, None]
        z[:, :j] -= buf[:, :j, j, None] * x[:, None, j]
    return x


def lu_gesv(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve the square systems A·x = y, a (Nb, N, N), y (Nb, N, K) →
    x (Nb, N, K), by partial-pivot LU in ONE launch: the right-hand sides
    ride the elimination and back substitution runs in the kernel.
    Singular pivots give inf/nan and do not raise.

    A CUDA tensor runs the kernel (or raises); a CPU tensor runs
    :func:`lu_gesv_ref`.
    """
    on_card = _build.check_operand(a, "lu_gesv", 3)
    _build.check_operand(y, "lu_gesv", 3)
    nb, n, n2 = a.shape
    if n != n2 or y.shape[:2] != (nb, n):
        raise ValueError(f"lu_gesv: needs a (Nb, N, N) and y (Nb, N, K), got "
                         f"{tuple(a.shape)} and {tuple(y.shape)}")
    if y.dtype != a.dtype or y.device != a.device:
        raise ValueError("lu_gesv: a and y must share dtype and device")
    if not on_card:
        return lu_gesv_ref(a, y)
    k = y.shape[-1]
    f64 = a.dtype == torch.float64
    buf = torch.cat([a, y], dim=-1).contiguous()   # scratch, [A | y]
    x = a.new_empty((nb, n, k))
    _build.launch("nd4js_lu_gesv_f64" if f64 else "nd4js_lu_gesv_f32",
                  a.device, buf, x, nb, n, k)
    launches["lu_gesv"] += 1
    return x
