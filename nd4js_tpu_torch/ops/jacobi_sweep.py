"""Whole sweeps of one-sided (Hestenes) Jacobi rotations: the CUDA kernel
``csrc/jacobi_sweep.cu`` (the port of
``nd4js_tpu/ops/jacobi_sweep.py::jacobi_sweeps``), its plain PyTorch
version, and a launch counter.

W (Nb, M, n) and V (Nb, n, n), n even, are split into column halves:
pair i of a round rotates the column at top seat i (role p) against the
one at bottom seat i (role q), then the Brent-Luk shuffle

    top = [t0, b0, t1, …, t_{h−2}],  bottom = [b1, …, b_{h−1}, t_{h−1}]

moves every column but t0 one seat along a ring of n − 1 seats. A sweep
is n − 1 rounds, so every column ends where it started. The column norms
are computed once at the start of each sweep and carried through the
rotations (app' = c²·app − 2cs·apq + s²·aqq), clamped at 0 before each
use; only apq is reduced afresh each round. A pair is left alone when
|apq| ≤ tiny; t = 1 for τ = 0; c = rsqrt(1 + t²). ``off`` is the largest
|apq| / (√app·√aqq + tiny) seen before a rotation, over all rounds of
all sweeps of the call.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["jacobi_sweeps", "jacobi_sweeps_ref", "small_regime"]

# Kernel launches since the last reset; only jacobi_sweeps' CUDA branch
# adds to it, one per call (one call is ``sweeps`` whole sweeps).
launches = 0


def small_regime(m: int, n: int, dtype: torch.dtype) -> bool:
    """True when W and V of one matrix, with the carried norms, fit in one
    block's shared memory (the kernel then keeps a whole sweep there);
    False when they stay in global memory, one launch a round."""
    size = torch.finfo(dtype).bits // 8
    return (n * m + n * n + n + 32) * size <= _build.SMEM_MAX


def _shuffle(t, b):
    """Brent-Luk step on the two seat rows (``nd4js_tpu/la/svd_jac.py:57-65``)."""
    h = t.shape[-1]
    if h == 1:
        return t, b
    nt = torch.cat([t[..., :1], b[..., :1], t[..., 1:h - 1]], -1)
    nb = torch.cat([b[..., 1:], t[..., h - 1:]], -1)
    return nt, nb


def jacobi_sweeps_ref(w: torch.Tensor, v: torch.Tensor, sweeps: int = 1):
    """Plain PyTorch version of the kernel: ``_sweep_kernel``
    (``nd4js_tpu/ops/jacobi_sweep.py:56-118``) with the batch axis
    written out. Returns (W, V, off (Nb,))."""
    nb, _, n = w.shape
    h = n // 2
    tiny = torch.finfo(w.dtype).tiny
    wt, wb = w[..., :h], w[..., h:]
    vt, vb = v[..., :h], v[..., h:]
    off = w.new_zeros((nb,))
    for _ in range(sweeps):
        app = (wt * wt).sum(1)
        aqq = (wb * wb).sum(1)
        for _ in range(n - 1):
            apq = (wt * wb).sum(1)
            app = torch.clamp(app, min=0.0)
            aqq = torch.clamp(aqq, min=0.0)
            denom = torch.sqrt(app) * torch.sqrt(aqq) + tiny
            off = torch.maximum(off, (apq.abs() / denom).amax(1))
            small = apq.abs() <= tiny
            safe = torch.where(small, 1.0, apq)
            tau = (aqq - app) / (2 * safe)
            t = torch.sign(tau) / (tau.abs() + torch.sqrt(1 + tau * tau))
            t = torch.where(tau == 0, 1.0, t)
            t = torch.where(small, 0.0, t)
            c = torch.rsqrt(1 + t * t)
            s = t * c
            c3, s3 = c[:, None, :], s[:, None, :]
            nwt, nwb = c3 * wt - s3 * wb, s3 * wt + c3 * wb
            nvt, nvb = c3 * vt - s3 * vb, s3 * vt + c3 * vb
            c2, s2, cs2 = c * c, s * s, 2 * c * s
            napp = c2 * app - cs2 * apq + s2 * aqq
            naqq = s2 * app + cs2 * apq + c2 * aqq
            app, aqq = _shuffle(napp, naqq)
            wt, wb = _shuffle(nwt, nwb)
            vt, vb = _shuffle(nvt, nvb)
    return torch.cat([wt, wb], -1), torch.cat([vt, vb], -1), off


def jacobi_sweeps(w: torch.Tensor, v: torch.Tensor, sweeps: int = 1):
    """``sweeps`` whole one-sided Jacobi sweeps on W (Nb, M, n), n even,
    accumulating the rotations into V (Nb, n, n). Returns (W, V, off):
    the columns of W and V are where they started (a sweep takes each
    once round the tournament), off (Nb,) is the largest relative
    off-diagonal measure seen.

    A CUDA tensor runs the kernel (or raises); a CPU tensor runs
    :func:`jacobi_sweeps_ref`. The kernel returns W and V as transposed
    views of column-major buffers, which the next call reads without a
    copy.
    """
    global launches
    on_card = _build.check_operand(w, "jacobi_sweeps", 3)
    _build.check_operand(v, "jacobi_sweeps", 3)
    nb, m, n = w.shape
    if n % 2 or n < 2 or tuple(v.shape) != (nb, n, n) or v.dtype != w.dtype \
            or v.device != w.device or sweeps < 0:
        raise ValueError(f"jacobi_sweeps: needs W (Nb, M, n) with n even, "
                         f"V (Nb, n, n) of its dtype and device and "
                         f"sweeps >= 0, got {tuple(w.shape)}, "
                         f"{tuple(v.shape)}, sweeps={sweeps}")
    if not on_card:
        return jacobi_sweeps_ref(w, v, sweeps)
    wt_in = w.mT.contiguous()
    vt_in = v.mT.contiguous()
    wt = torch.empty_like(wt_in)
    vt = torch.empty_like(vt_in)
    off = w.new_empty((nb,))
    nrm = w.new_empty((nb, n))
    f64 = w.dtype == torch.float64
    _build.launch("nd4js_jacobi_sweeps_f64" if f64 else
                  "nd4js_jacobi_sweeps_f32", w.device, wt_in, vt_in, wt, vt,
                  off, nrm, nb, m, n, sweeps,
                  int(small_regime(m, n, w.dtype)))
    launches += 1
    return wt.mT, vt.mT, off
