"""Blocked symmetric tridiagonalisation A = Q·T·Qᵀ, T tridiagonal, the
counterpart of ``nd4js_tpu/la/sytrd.py``: LAPACK's sytrd/latrd shape.

    per panel of width bk ≤ 64 (the last of n = 1024 has bk = 63):
      C_trailing, V, W, taus, d, e = sytrd_panel(C, bk)   (CUDA kernel)
      T (bk×bk upper) = (diag(1/τ) + striu(VᵀV))⁻¹        (GEMMs)
    Q = Π_p (I − V_p·T_p·V_pᵀ) applied to I in reverse    (GEMMs)

Each panel is one kernel launch for the whole flattened batch; the
kernel does the rank-2b update of the trailing block itself.
"""
from __future__ import annotations

import math

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core.mm import mt
from ..ops.sytrd_panel import MAX_BK, sytrd_panel, sytrd_panel_ref
from .qr import _apply_q_batched, _form_t_batched

__all__ = ["sytrd"]

_PANEL = MAX_BK


def sytrd(a, panel: int = _PANEL, use_kernel: bool = True, device=None):
    """Symmetric tridiagonalisation, batched over leading dims: returns
    (d, e, q) with A = Q·tridiag(d, e)·Qᵀ for every matrix. Only the
    symmetric part (A + Aᵀ)/2 is used.

    ``use_kernel=False`` runs the panel's plain version on any device
    (for tests); otherwise ``ops.sytrd_panel.sytrd_panel`` runs, which
    launches the kernel for a CUDA tensor and runs the plain version for
    a CPU one. An array-like ``a`` goes to ``device`` (default
    ``config.default_device``)."""
    a = as_tensor(a, device)
    a = a.to(default_float_for(a.dtype))
    lead = a.shape[:-2]
    n = a.shape[-1]
    a = (a + mt(a)) * 0.5
    if n == 1:
        return a[..., 0], a.new_zeros(lead + (0,)), torch.ones_like(a)
    if n == 2:
        d = torch.diagonal(a, dim1=-2, dim2=-1)
        e = torch.diagonal(a, offset=-1, dim1=-2, dim2=-1)
        q = torch.eye(2, dtype=a.dtype, device=a.device).expand(a.shape)
        return d, e, q.clone()
    run_panel = sytrd_panel if use_kernel else sytrd_panel_ref
    B = max(1, math.prod(lead))
    c = a.reshape((B, n, n))
    ds, es, vts = [], [], []
    for k in range(0, n - 1, panel):
        bk = min(panel, n - 1 - k)
        c, V, W, taus, dd, ee = run_panel(c, bk)
        ds.append(dd)
        es.append(ee)
        Vm, T = _form_t_batched(V, taus)
        vts.append((k, Vm, T))
    ds.append(c.reshape((B, 1)))             # the final 1×1 trailing block
    d = torch.cat(ds, dim=-1)
    e = torch.cat(es, dim=-1)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    q = _apply_q_batched(vts, eye.expand(B, n, n))
    return (d.reshape(lead + (n,)), e.reshape(lead + (n - 1,)),
            q.reshape(lead + (n, n)))
