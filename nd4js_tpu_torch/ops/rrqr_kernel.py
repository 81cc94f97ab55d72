"""Column-pivoted Householder QR with downdated column norms: the CUDA
kernel ``csrc/rrqr.cu`` (the port of
``nd4js_tpu/ops/rrqr_kernel.py::rrqr_kernel``), its plain PyTorch version,
and a launch counter.

For each step j < K = min(M, N): the squared column norms (computed once
on entry) are clamped at 0; the pivot is the trailing column (index ≥ j)
of largest norm, the lowest index on a tie; columns, perm entries and
norms j and p swap; the reflector of column j (rows ≥ j) has
β = −sign(x₀)·‖x‖ and τ = (β − x₀)/β, τ = 0 for a zero column, v₀ = 1;
it is applied to the columns > j; column j becomes β at row j above
zeros; and the norms of the columns > j lose the square of their new
row-j entry. Outputs (R_packed (Nb, M, N), V (Nb, M, K) with a unit
diagonal and zeros above, taus (Nb, K), perm (Nb, N) int32), with
A[:, perm] = H_0···H_{K−1}·triu(R_packed).
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["rrqr_kernel", "rrqr_kernel_ref", "small_regime"]

# Kernel launches since the last reset; only rrqr_kernel's CUDA branch adds
# to it, one per call.
launches = 0


def small_regime(m: int, n: int, dtype: torch.dtype) -> bool:
    """True when one matrix, its reflector and its norms fit in one block's
    shared memory (the kernel then runs all K steps there); False when
    the matrix stays in global memory, two launches a step."""
    size = torch.finfo(dtype).bits // 8
    return (n * m + m + n + 32) * size + 4 * (n + 32) <= _build.SMEM_MAX


def rrqr_kernel_ref(a: torch.Tensor):
    """Plain PyTorch version of the kernel: ``_rrqr_kernel``
    (``nd4js_tpu/ops/rrqr_kernel.py:33-110``) with the batch axis written
    out. Returns (R_packed, V, taus, perm)."""
    nb, m, n = a.shape
    k = min(m, n)
    r = a.clone()
    V = a.new_zeros((nb, m, k))
    taus = a.new_zeros((nb, k))
    perm = torch.arange(n, dtype=torch.int32, device=a.device).repeat(nb, 1)
    norms = (a * a).sum(1)
    lanes = torch.arange(n, device=a.device)
    rows = torch.arange(m, device=a.device)
    batch = torch.arange(nb, device=a.device)
    for j in range(k):
        norms = torch.clamp(norms, min=0.0)
        cand = torch.where(lanes >= j, norms, -1.0)
        # argmax with the lowest index on a tie
        cmax = cand.amax(1, keepdim=True)
        p = torch.where(cand == cmax, lanes, n).amin(1)
        p = torch.where(p == n, j, p)          # all-NaN trailing norms
        colj, colp = r[:, :, j].clone(), r[batch, :, p].clone()
        r[:, :, j], r[batch, :, p] = colp, colj
        pj, pp = perm[:, j].clone(), perm[batch, p].clone()
        perm[:, j], perm[batch, p] = pp, pj
        nj, np_ = norms[:, j].clone(), norms[batch, p].clone()
        norms[:, j], norms[batch, p] = np_, nj
        x = colp
        x0 = x[:, j]
        sigma = (x[:, j + 1:] ** 2).sum(1)
        nrm = torch.sqrt(x0 * x0 + sigma)
        beta = torch.where(x0 >= 0, -nrm, nrm)
        den = x0 - beta
        safe_den = torch.where(den == 0, 1.0, den)
        v = torch.where(rows > j, x / safe_den[:, None], 0.0)
        v[:, j] = 1.0
        safe_beta = torch.where(beta == 0, 1.0, beta)
        tau = torch.where(nrm == 0, 0.0, (beta - x0) / safe_beta)
        w = tau[:, None] * (r[:, :, j + 1:] * v[:, :, None]).sum(1)
        r[:, :, j + 1:] -= v[:, :, None] * w[:, None, :]
        r[:, j + 1:, j] = 0.0
        r[:, j, j] = beta
        V[:, :, j] = v
        taus[:, j] = tau
        rrow = r[:, j, j + 1:]
        norms[:, j + 1:] = norms[:, j + 1:] - rrow * rrow
    return r, V, taus, perm


def rrqr_kernel(a: torch.Tensor):
    """Column-pivoted Householder factorisation of (Nb, M, N) → (R_packed,
    V, taus, perm), as the module docstring says.

    A CUDA tensor runs the kernel (or raises); a CPU tensor runs
    :func:`rrqr_kernel_ref`. The kernel returns R_packed and V as
    transposed views of column-major buffers.
    """
    global launches
    if not _build.check_operand(a, "rrqr_kernel", 3):
        return rrqr_kernel_ref(a)
    nb, m, n = a.shape
    k = min(m, n)
    at = a.mT.contiguous()
    rt = torch.empty_like(at)
    vt = a.new_empty((nb, k, m))
    taus = a.new_empty((nb, k))
    perm = torch.empty((nb, n), dtype=torch.int32, device=a.device)
    nrm = a.new_empty((nb, n))
    f64 = a.dtype == torch.float64
    _build.launch("nd4js_rrqr_f64" if f64 else "nd4js_rrqr_f32", a.device,
                  at, rt, vt, taus, perm, nrm, nb, m, n,
                  int(small_regime(m, n, a.dtype)))
    launches += 1
    return rt.mT, vt.mT, taus, perm
