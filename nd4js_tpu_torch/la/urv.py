"""URV, the complete orthogonal decomposition A = U·R·V, the counterpart
of ``nd4js_tpu/la/urv.py``: the strong RRQR first, then the rank-masked
row space re-triangularised by one Householder QR of Rᵀ, so that R is
nonzero only in its leading rank×rank (lower-)triangular block.
``urv_lstsq`` gives the minimum-norm least-squares solution for any
matrix, rank-deficient ones included.
"""
from __future__ import annotations

import torch

from .. import dt
from ..config import default_float_for
from ..convert import as_tensor
from ..core.batch import batched
from ..core.mm import mm, mt
from .permute import unpermute_cols
from .qr import _qr_core
from .srrqr import _srrqr_core
from .tri import _tril_inv_core

__all__ = ["urv_decomp_full", "urv_lstsq"]


def _urv_core(a: torch.Tensor, dtol: float, f: float):
    """URV of one matrix (M, N): (U, R, V, rank)."""
    M, N = a.shape
    q, r, p, rank = _srrqr_core(a, dtol, f)
    idx_m = torch.arange(M, device=a.device)
    idx_n = torch.arange(N, device=a.device)
    # zero the numerically negligible trailing block
    r = torch.where((idx_m[:, None] >= rank) & (idx_n[None, :] >= rank),
                    0.0, r)
    # annihilate the right block: the QR of Rᵀ gives R = Lᵀ·Wᵀ = R_new·V'
    s = torch.where(idx_m[:, None] < rank, r, 0.0)
    w, t = _qr_core(mt(s), economic=False)          # sᵀ (N, M) = w·t
    # fold the column permutation into V: A[:, P] = U·R·V' gives
    # A = U·R·V with V = unpermute_cols(V', P)
    return q, mt(t), unpermute_cols(mt(w), p), rank


@batched((2,))
def _urv(a, dtol, f):
    if a.ndim == 2:
        return _urv_core(a, dtol, f)
    return tuple(torch.stack(o) for o in zip(*(_urv_core(m, dtol, f)
                                               for m in a)))


def urv_decomp_full(a, dtol=None, f: float = 2.0, device=None):
    """[U, R, V, rank] with A = U·R·V, U (M, M) and V (N, N) orthogonal and
    R (M, N) nonzero only in its leading rank×rank lower-triangular block.
    Batched over leading dims. An array-like ``a`` goes to ``device``
    (default ``config.default_device``)."""
    a = as_tensor(a, device)
    a = a.to(default_float_for(a.dtype))
    if dtol is None:
        dtol = dt.eps(a.dtype) * max(a.shape[-2:])
    return _urv(a, dtol, f)


@batched((2, 2, 2, 0, 2))
def _urv_lstsq(u, r, v, rank, y):
    M, N = r.shape[-2:]
    K = min(M, N)
    live = torch.arange(K, device=r.device) < rank[..., None]
    eye = torch.eye(K, dtype=r.dtype, device=r.device)
    r11 = torch.where(live[..., :, None] & live[..., None, :],
                      r[..., :K, :K], eye)
    z = mm(_tril_inv_core(r11), mm(mt(u[..., :K]), y))
    z = torch.where(live[..., :, None], z, 0.0)
    if N > K:
        z = torch.cat([z, z.new_zeros(z.shape[:-2] + (N - K, z.shape[-1]))],
                      -2)
    return mm(mt(v), z)


def urv_lstsq(u, r, v, ranks, y, device=None):
    """Minimum-norm least squares from a URV decomposition:
    x = Vᵀ·[R₁₁⁻¹·(Uᵀy)₁ ; 0]. Leading dims broadcast; r, v, ranks and y
    go to u's device."""
    u = as_tensor(u, device)
    r, v, ranks, y = (as_tensor(t, u.device) for t in (r, v, ranks, y))
    return _urv_lstsq(u, r, v, ranks, y.to(u.dtype))
