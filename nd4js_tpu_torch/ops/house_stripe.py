"""Fused square QR solve: the CUDA kernel ``csrc/qr_gesv.cu`` (the port
of ``qr_gesv`` in ``nd4js_tpu/ops/house_stripe.py``), its plain PyTorch
version, and a launch counter. ``house_stripe_t`` is not ported yet
(ROADMAP.md, kernel queue).
"""
from __future__ import annotations

import torch

from . import _build
from .house_panel import householder_step

__all__ = ["qr_gesv", "qr_gesv_ref"]

# Kernel launches since the last reset; only qr_gesv's CUDA branch adds
# to it.
launches = 0


def qr_gesv_ref(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: Householder steps on
    [A | y], then back substitution R·x = Qᵀy."""
    n = a.shape[-1]
    buf = torch.cat([a, y], dim=-1)
    for j in range(n):
        householder_step(buf, j)
    z = buf[:, :, n:].clone()
    x = torch.empty_like(z)
    for j in range(n - 1, -1, -1):
        # a singular R yields inf/nan, as in the kernel
        x[:, j] = z[:, j] / buf[:, j, j, None]
        z[:, :j] -= buf[:, :j, j, None] * x[:, None, j]
    return x


def qr_gesv(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve the square systems A·x = y, a (Nb, N, N), y (Nb, N, K) →
    x (Nb, N, K), factorisation + Qᵀy + back substitution in ONE launch.

    A CUDA tensor runs the kernel (or raises); a CPU tensor runs
    :func:`qr_gesv_ref`.
    """
    global launches
    on_card = _build.check_operand(a, "qr_gesv", 3)
    _build.check_operand(y, "qr_gesv", 3)
    nb, n, n2 = a.shape
    if n != n2 or y.shape[:2] != (nb, n):
        raise ValueError(f"qr_gesv: needs a (Nb, N, N) and y (Nb, N, K), got "
                         f"{tuple(a.shape)} and {tuple(y.shape)}")
    if y.dtype != a.dtype or y.device != a.device:
        raise ValueError("qr_gesv: a and y must share dtype and device")
    if not on_card:
        return qr_gesv_ref(a, y)
    k = y.shape[-1]
    f64 = a.dtype == torch.float64
    buf = torch.cat([a, y], dim=-1).contiguous()   # scratch, [A | y]
    x = a.new_empty((nb, n, k))
    _build.launch("nd4js_qr_gesv_f64" if f64 else "nd4js_qr_gesv_f32",
                  a.device, buf, x, nb, n, k)
    launches += 1
    return x
