"""Bunch-Kaufman PLDLᵀPᵀ, the symmetric-indefinite factorisation, the
counterpart of ``nd4js_tpu/la/pldlp.py``.

The JAX package runs a ``lax.while_loop`` over a column index k that
advances by 1 (a 1×1 pivot) or 2 (a 2×2 pivot), with a three-way
``lax.switch`` (1×1; 1×1 after swapping k and r; 2×2 after swapping k+1
and r), under ``vmap``, so each matrix has its own k. Here k is a tensor
of one index a matrix and the three branches are selected by mask: one
symmetric swap a step (the identity for branch 0, a gather of rows and
columns otherwise) and one rank-2 update whose second term is zero for a
1×1 pivot. A matrix whose k has reached n is left as it is. Every matrix
is done within n steps, so the loop runs exactly n masked steps and
reads nothing on the host.

Conventions: ``pldlp_decomp(A) -> (LD, P, blk)`` with P int32 and
A[P][:, P] = L·D·Lᵀ; LD packs unit-lower L below the diagonal and D on
it (a 2×2 block keeps its off-diagonal at LD[i+1, i]); ``blk`` marks the
first column of each 2×2 block of D.
"""
from __future__ import annotations

import math

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core.batch import batched
from ..core.mm import mm
from .permute import unpermute_rows
from .tri import _tril_inv_core, tril_t_solve

__all__ = ["pldlp_decomp", "pldlp_l", "pldlp_d", "pldlp_p", "pldlp_solve"]

_ALPHA = (1.0 + math.sqrt(17.0)) / 8.0


def _col(a, k):
    """Column k[b] of each matrix a[b]: (B, n)."""
    n = a.shape[-1]
    return torch.gather(a, 2, k[:, None, None].expand(-1, n, 1))[..., 0]


def _at(v, k):
    """v[b, k[b]]: (B,)."""
    return torch.gather(v, 1, k[:, None])[:, 0]


def _pldlp_core(a):
    """Bunch-Kaufman on a batch (B, n, n) of symmetric matrices
    (``nd4js_tpu/la/pldlp.py:57-151``, each matrix as its lane)."""
    B, n, _ = a.shape
    dev = a.device
    idx = torch.arange(n, device=dev)
    rows = idx[None, :, None]
    colsi = idx[None, None, :]
    p = torch.arange(n, dtype=torch.int32, device=dev).repeat(B, 1)
    blk = torch.zeros((B, n), dtype=torch.bool, device=dev)
    k = torch.zeros(B, dtype=torch.long, device=dev)
    zero = a.new_zeros(())
    for _ in range(n):
        act = k < n
        kc = k.clamp(max=n - 1)
        kk = k[:, None]
        ck = _col(a, kc)
        akk = _at(ck, kc)
        below = torch.where(idx > kk, ck.abs(), -1.0)
        lam = below.amax(-1)
        r = torch.argmax(below, -1)
        use_11 = (akk.abs() >= _ALPHA * lam) | (lam <= 0)
        cr = _col(a, r)
        sigma = torch.where((idx != r[:, None]) & (idx >= kk), cr.abs(),
                            -1.0).amax(-1)
        arr = _at(cr, r)
        case_b = akk.abs() * sigma >= _ALPHA * lam * lam
        case_c = arr.abs() >= _ALPHA * sigma
        # 0: 1×1; 1: 1×1 after swapping k and r; 2: 2×2 after k+1 and r
        dec = torch.where(use_11 | case_b, 0, torch.where(case_c, 1, 2))
        dec = torch.where(act, dec, 0)
        # the swap of i and r as a permutation of rows and columns; i = r
        # (no swap) for branch 0 and for the matrices that are done
        i = torch.where(dec == 1, k, torch.where(dec == 2, k + 1, r))
        perm = torch.arange(n, device=dev).repeat(B, 1)
        perm.scatter_(1, i[:, None], r[:, None])
        perm.scatter_(1, r[:, None], i[:, None])
        a = torch.gather(a, 1, perm[:, :, None].expand(-1, -1, n))
        a = torch.gather(a, 2, perm[:, None, :].expand(-1, n, -1))
        p = torch.gather(p, 1, perm)
        # the elimination, 1×1 or 2×2
        two = dec == 2
        k1 = k + 1
        ck = _col(a, kc)
        ck1 = _col(a, k1.clamp(max=n - 1))
        d11 = _at(ck, kc)
        # 1×1: l = a_k / a_kk below k
        safe = torch.where(d11 == 0, 1.0, d11)
        l11 = torch.where(idx > kk, ck / safe[:, None], 0.0)
        w11 = torch.where(idx > kk, ck, 0.0)
        # 2×2: [l1 l2] = [w1 w2]·D⁻¹, D = [[d11, d21], [d21, d22]]
        k1c = k1.clamp(max=n - 1)
        d21 = _at(ck, k1c)
        d22 = _at(ck1, k1c)
        det = d11 * d22 - d21 * d21
        safe_det = torch.where(det == 0, 1.0, det)[:, None]
        w1 = torch.where(idx > k1[:, None], ck, 0.0)
        w2 = torch.where(idx > k1[:, None], ck1, 0.0)
        l1 = (w1 * d22[:, None] - w2 * d21[:, None]) / safe_det
        l2 = (w2 * d11[:, None] - w1 * d21[:, None]) / safe_det
        tw = two[:, None]
        la_ = torch.where(tw, l1, l11)
        wa = torch.where(tw, w1, w11)
        lb = torch.where(tw, l2, zero)
        wb = torch.where(tw, w2, zero)
        a = a - la_[:, :, None] * wa[:, None, :] \
            - lb[:, :, None] * wb[:, None, :]
        # store l in column k (and row k); for a 2×2 pivot also l2 in k+1
        last = torch.where(two, k1, k)[:, None, None]
        kr = k[:, None, None]
        a = torch.where((colsi == kr) & (rows > last), la_[:, :, None], a)
        a = torch.where((rows == kr) & (colsi > last), la_[:, None, :], a)
        k1r = torch.where(two, k1, n)[:, None, None]
        a = torch.where((colsi == k1r) & (rows > last), lb[:, :, None], a)
        a = torch.where((rows == k1r) & (colsi > last), lb[:, None, :], a)
        blk = blk | (two[:, None] & (idx == kk))
        k = torch.where(act, torch.where(two, k + 2, k + 1), k)
    return a, p, blk


def pldlp_decomp(a, device=None):
    """Bunch-Kaufman factorisation of the symmetric part (A + Aᵀ)/2,
    batched over leading dims. Returns (LD, P, blk) with
    A[..., P, :][..., :, P] = L·D·Lᵀ. An array-like ``a`` goes to
    ``device`` (default ``config.default_device``)."""
    a = as_tensor(a, device)
    a = a.to(default_float_for(a.dtype))
    a = (a + a.transpose(-1, -2)) * 0.5
    lead, n = a.shape[:-2], a.shape[-1]
    ld, p, blk = _pldlp_core(a.reshape((-1, n, n)))
    return (ld.reshape(a.shape), p.reshape(lead + (n,)),
            blk.reshape(lead + (n,)))


def pldlp_l(ld, blk, device=None):
    """The unit-lower L factor of :func:`pldlp_decomp`'s packing."""
    ld = as_tensor(ld, device)
    blk = as_tensor(blk, ld.device)
    n = ld.shape[-1]
    r = torch.arange(n, device=ld.device)[:, None]
    c = torch.arange(n, device=ld.device)[None, :]
    # the 2×2 blocks' sub-diagonal entries at (i+1, i) belong to D
    is_d21 = (r == c + 1) & blk[..., None, :]
    return torch.where(is_d21, 0.0, torch.tril(ld, -1)) \
        + torch.eye(n, dtype=ld.dtype, device=ld.device)


def pldlp_d(ld, blk, device=None):
    """The block-diagonal D factor of :func:`pldlp_decomp`'s packing."""
    ld = as_tensor(ld, device)
    blk = as_tensor(blk, ld.device)
    n = ld.shape[-1]
    r = torch.arange(n, device=ld.device)[:, None]
    c = torch.arange(n, device=ld.device)[None, :]
    subv = torch.diagonal(ld, -1, -2, -1)
    subv = torch.where(blk[..., :n - 1], subv, 0.0)
    d = torch.where(r == c, ld, 0.0)
    return d + torch.diag_embed(subv, -1) + torch.diag_embed(subv, 1)


def pldlp_p(p, dtype=None, device=None):
    """The permutation vector as a one-hot matrix, in ``dtype`` (default
    float32)."""
    p = as_tensor(p, device)
    n = p.shape[-1]
    return (p[..., :, None] == torch.arange(n, device=p.device)).to(
        dtype or torch.float32)


@batched((2, 1, 1, 2))
def _pldlp_solve(ld, p, blk, y):
    """The solve on one leading batch axis (or none), as the JAX
    package's per-matrix ``_go`` (``nd4js_tpu/la/pldlp.py:220-258``)."""
    l = pldlp_l(ld, blk)
    d = pldlp_d(ld, blk)
    yp = torch.gather(y, -2, p.long()[..., :, None].expand(y.shape))
    z = mm(_tril_inv_core(l), yp)
    # the block-diagonal solve, 1×1 and 2×2 blocks at once
    dd = torch.diagonal(d, 0, -2, -1)
    sub = torch.diagonal(d, -1, -2, -1)
    pad = dd.new_zeros(dd.shape[:-1] + (1,))
    subp = torch.cat([sub, pad], -1)            # e at a block's first row
    subm = torch.cat([pad, sub], -1)            # e at its second row
    is_start = blk
    is_second = torch.cat([torch.zeros_like(blk[..., :1]), blk[..., :-1]],
                          -1)
    dnext = torch.cat([dd[..., 1:], pad], -1)
    dprev = torch.cat([pad, dd[..., :-1]], -1)
    zpad = z.new_zeros(z.shape[:-2] + (1, z.shape[-1]))
    znext = torch.cat([z[..., 1:, :], zpad], -2)
    zprev = torch.cat([zpad, z[..., :-1, :]], -2)
    det_2 = torch.where(is_start, dd * dnext - subp * subp, 1.0)
    det_2p = torch.where(is_second, dprev * dd - subm * subm, 1.0)
    x11 = z / torch.where(dd == 0, 1.0, dd)[..., :, None]
    x_start = (dnext[..., :, None] * z - subp[..., :, None] * znext) \
        / det_2[..., :, None]
    x_second = (dprev[..., :, None] * z - subm[..., :, None] * zprev) \
        / det_2p[..., :, None]
    x = torch.where(is_start[..., :, None], x_start,
                    torch.where(is_second[..., :, None], x_second, x11))
    w = tril_t_solve(l, x)
    return unpermute_rows(w, p)


def pldlp_solve(ld, p, blk, y, device=None):
    """Solve A·x = y from the Bunch-Kaufman factors (LD, P, blk); leading
    dims broadcast. Array-likes go to ``device`` (default
    ``config.default_device``), P, blk and y to LD's device; numpy
    factors of the JAX package (P int32, blk bool) go in as they are."""
    ld = as_tensor(ld, device)
    p, blk = as_tensor(p, ld.device), as_tensor(blk, ld.device)
    y = as_tensor(y, ld.device).to(ld.dtype)
    return _pldlp_solve(ld, p, blk, y)
