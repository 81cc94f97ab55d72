"""Compensated column sums: the CUDA kernel ``csrc/kahan_sum.cu``, its
plain PyTorch version and a launch counter.

``kahan_sum_cols(x)`` of a 2-D (n, lanes) float32 or float64 tensor is,
for each lane j, the Neumaier sum of x[0, j], …, x[n − 1, j] in that
order: the recurrence of ``nd4js_tpu/core/kahan.py:26-48``, where the JAX
package runs it as an XLA ``lax.scan`` (no Pallas kernel). The kernel, the
plain version and the scan round alike, so their results are bit-equal.

The kernel runs one thread a lane; ``core.kahan.kahan_sum`` moves the
reduced axis to the front so that a warp reads neighbouring addresses.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["kahan_sum_cols", "kahan_sum_cols_ref"]

# Kernel launches since the last reset; only kahan_sum_cols' CUDA branch
# adds to it.
launches = 0


def kahan_sum_cols_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the scan's body
    (``nd4js_tpu/core/kahan.py:40-45``) row by row."""
    s = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    c = torch.zeros_like(s)
    for xi in x:
        t = s + xi
        # Neumaier: pick the compensation branch by magnitude
        c = c + torch.where(s.abs() >= xi.abs(), (s - t) + xi, (xi - t) + s)
        s = t
    return s + c


def kahan_sum_cols(x: torch.Tensor) -> torch.Tensor:
    """Compensated sum over the rows of a (n, lanes) float32/float64
    tensor, shape (lanes,).

    A CUDA tensor runs the kernel (or raises); a CPU tensor runs
    :func:`kahan_sum_cols_ref`. No launch where there is nothing to sum
    (n = 0 gives zeros, lanes = 0 an empty tensor).
    """
    global launches
    on_card = _build.check_operand(x, "kahan_sum", 2)
    if not on_card:
        return kahan_sum_cols_ref(x)
    n, lanes = x.shape
    if n == 0 or lanes == 0:
        return torch.zeros(lanes, dtype=x.dtype, device=x.device)
    x = x.contiguous()
    out = torch.empty(lanes, dtype=x.dtype, device=x.device)
    f64 = x.dtype == torch.float64
    _build.launch("nd4js_kahan_sum_f64" if f64 else "nd4js_kahan_sum_f32",
                  x.device, x, out, n, lanes)
    launches += 1
    return out
