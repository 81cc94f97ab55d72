"""General (non-symmetric) eigendecomposition, the counterpart of
``nd4js_tpu/la/eigen.py``: diagonal balancing, then the real Schur form
(``la.schur``), its eigenvectors, and the balancing undone.

Balancing runs a fixed 8 simultaneous sweeps (every scale factor updated
at once) with the factors snapped to powers of two, so that it is exact.
"""
from __future__ import annotations

import math

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core import cpx
from ..core.batch import batched
from .schur import schur_decomp, schur_eigen, schur_eigenvals

__all__ = ["eigen", "eigenvals", "eigen_balance_pre"]

_SWEEPS = 8        # simultaneous balancing sweeps


def _balance_core(a, p: int = 2):
    """(d, D⁻¹·A·D) of a batch a (B, n, n) (``nd4js_tpu/la/eigen.py:
    27-52``). torch.round rounds half to even, as jnp.round does."""
    n = a.shape[-1]
    d = a.new_ones(a.shape[:-1])
    eye = torch.eye(n, dtype=torch.bool, device=a.device)
    for _ in range(_SWEEPS):
        off = torch.where(eye, 0.0, a.abs())
        if p == 2:
            r = torch.sqrt((off ** 2).sum(-1))
            c = torch.sqrt((off ** 2).sum(-2))
        else:
            r = off.sum(-1)
            c = off.sum(-2)
        safe_r = torch.where(r == 0, 1.0, r)
        safe_c = torch.where(c == 0, 1.0, c)
        f = torch.exp2(torch.round(torch.log2(torch.sqrt(safe_r / safe_c))))
        f = torch.where((r == 0) | (c == 0), 1.0, f)
        a = a * f[:, None, :] / f[:, :, None]
        d = d * f
    return d, a


@batched((2,))
def _balance(a, p: int):
    # an explicit batch size: a 0×0 matrix leaves -1 nothing to infer
    d, b = _balance_core(a.reshape((math.prod(a.shape[:-2]),) + a.shape[-2:]),
                         p)
    return d.reshape(a.shape[:-1]), b.reshape(a.shape)


def eigen_balance_pre(a, p: int = 2, device=None):
    """[D, B] with B = D⁻¹·A·D balanced, row and column norms equalised
    (``nd4js_tpu/la/eigen.py:55``). Batched. An array-like ``a`` goes to
    ``device`` (default ``config.default_device``)."""
    a = as_tensor(a, device)
    return _balance(a.to(default_float_for(a.dtype)), p)


def eigenvals(a, split: bool = False, device=None):
    """Complex eigenvalues (``nd4js_tpu/la/eigen.py:64``). Batched.
    ``split=True`` returns a (re, im) pair."""
    _, b = eigen_balance_pre(a, device=device)
    _, t = schur_decomp(b)
    return schur_eigenvals(t, split=split)


def eigen(a, split: bool = False, device=None):
    """[Λ, V] with A·V = V·diag(Λ), columns normalised
    (``nd4js_tpu/la/eigen.py:74``). Batched over leading dims.
    ``split=True`` returns ((Λre, Λim), (Vre, Vim)), ``split=False``
    complex tensors. An array-like ``a`` goes to ``device`` (default
    ``config.default_device``)."""
    d, b = eigen_balance_pre(a, device=device)
    q, t = schur_decomp(b)
    lam, v = schur_eigen(q, t, split=True)
    # unbalance: rows scale by D, then renormalise the columns
    dcol = d[..., :, None]
    v = (v[0] * dcol, v[1] * dcol)
    nrm = torch.sqrt(cpx.abs2(v).sum(-2, keepdim=True))
    v = cpx.scale(v, 1 / torch.where(nrm == 0, 1.0, nrm))
    if split:
        return lam, v
    return cpx.to_complex(lam), cpx.to_complex(v)
