"""Strong rank-revealing QR (Gu & Eisenstat), the counterpart of
``nd4js_tpu/la/srrqr.py``: [Q (M, M), R (M, N), P (N,), rank].

The column-pivoted QR of ``rrqr._rrqr_core`` first, then a loop of strong
swaps: the rank from the dtol·|R₀₀| diagonal threshold, the interchange
scores

    ρ(i, j) = √( (R₁₁⁻¹R₁₂)ᵢⱼ² + (γⱼ(R₂₂)·ωᵢ(R₁₁⁻¹))² )

for all (i, j) at once with a masked triangular inverse, and, while the
largest exceeds f, a swap of the two columns and a refactorisation of R
by the single-matrix Householder QR. The JAX package's
``lax.while_loop`` and ``lax.cond`` become a Python loop that reads one
flag a round on the host (``core.host.read``): whether a swap is due.
"""
from __future__ import annotations

import torch

from .. import dt
from ..config import default_float_for
from ..convert import as_tensor
from ..core.batch import batched
from ..core.host import read
from ..core.mm import mm
from .qr import _qr_core
from .rrqr import _rrqr_core
from .tri import _tril_inv_core

__all__ = ["srrqr_decomp_full", "srrqr_rank"]


def _masked_r11_inv(r: torch.Tensor, rank) -> torch.Tensor:
    """Inverse of R[:rank, :rank] embedded in a K×K zero block (masked)."""
    k = r.shape[-1]
    live = torch.arange(k, device=r.device) < rank
    both = live[:, None] & live[None, :]
    eye = torch.eye(k, dtype=r.dtype, device=r.device)
    r_m = torch.where(both, r, eye)
    # upper-triangular inverse via the reversed lower-triangular one
    inv = _tril_inv_core(r_m.flip(-2, -1).mT).mT.flip(-2, -1)
    return torch.where(both, inv, 0.0)


def _srrqr_core(a: torch.Tensor, dtol: float, f: float):
    """Strong RRQR of one matrix (M, N): (Q, R, P, rank)."""
    M, N = a.shape
    K = min(M, N)
    dev = a.device
    q, r, p = _rrqr_core(a, economic=False)
    idx_k = torch.arange(K, device=dev)
    idx_n = torch.arange(N, device=dev)
    tiny = torch.finfo(r.dtype).tiny

    def rank_of(r):
        d = torch.diagonal(r[:K, :K]).abs()
        thresh = dtol * torch.clamp(d[0], min=tiny)
        return (d > thresh).sum().to(torch.int32)

    def crit(r, rank):
        """Gu-Eisenstat interchange scores rho (K, N)."""
        r11inv = _masked_r11_inv(r[:K, :K], rank)              # (K, K)
        live = (idx_k < rank)[:, None] & (idx_n >= rank)[None, :]
        b = torch.where(live, mm(r11inv, r[:K, :]), 0.0)       # (K, N)
        omega = torch.sqrt((r11inv * r11inv).sum(1))           # rows of R11⁻¹
        r22 = torch.where((idx_k >= rank)[:, None] & (idx_n >= rank)[None, :],
                          r[:K, :], 0.0)
        gamma = torch.sqrt((r22 * r22).sum(0))                 # (N,)
        rho = torch.sqrt(b * b + (gamma[None, :] * omega[:, None]) ** 2)
        return torch.where(live, rho, 0.0)

    for _ in range(2 * N):
        rho = crit(r, rank_of(r)).reshape(-1)
        flat = torch.argmax(rho)
        if not read(rho[flat] > f):
            break
        # swap columns i and j of R (and P), refactorise
        i, j = flat // N, flat % N
        cols = torch.arange(N, device=dev)
        swap = torch.where(cols == i, j, torch.where(cols == j, i, cols))
        q2, r = _qr_core(r[:, swap], economic=False)
        q, p = mm(q, q2), p[swap]
    return q, r, p, rank_of(r)


@batched((2,))
def _srrqr(a, dtol, f):
    if a.ndim == 2:
        return _srrqr_core(a, dtol, f)
    # each matrix swaps on its own, as under the JAX package's vmap
    return tuple(torch.stack(o) for o in zip(*(_srrqr_core(m, dtol, f)
                                               for m in a)))


def srrqr_decomp_full(a, dtol=None, f: float = 2.0, device=None):
    """[Q, R, P, rank], a strong rank-revealing QR with A[:, P] = Q·R,
    batched over leading dims. dtol defaults to eps·max(M, N). An
    array-like ``a`` goes to ``device`` (default ``config.default_device``)."""
    a = as_tensor(a, device)
    a = a.to(default_float_for(a.dtype))
    if dtol is None:
        dtol = dt.eps(a.dtype) * max(a.shape[-2:])
    return _srrqr(a, dtol, f)


def srrqr_rank(r, dtol=None, device=None):
    """Rank from the SRRQR R factor's diagonal: #{i : |R_ii| > dtol·|R_00|}."""
    r = as_tensor(r, device)
    m, n = r.shape[-2:]
    k = min(m, n)
    if dtol is None:
        dtol = dt.eps(r.dtype) * max(m, n)
    d = torch.diagonal(r[..., :k, :k], dim1=-2, dim2=-1).abs()
    thresh = dtol * torch.clamp(d[..., :1], min=torch.finfo(r.dtype).tiny)
    return (d > thresh).sum(-1).to(torch.int32)
