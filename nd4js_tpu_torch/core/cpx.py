"""Split-complex arithmetic: z represented as a (re, im) pair of real
tensors, the counterpart of ``nd4js_tpu/core/cpx.py``.

The card has native complex types, but the port keeps the JAX package's
(re, im) pairs on every complex-valued path (Schur eigenvectors, xTREVC)
so that both packages round alike and the tests compare like with like.
A complex product is four real GEMMs through :func:`core.mm.mm`; pairs
become native complex tensors only at the API boundary.
"""
from __future__ import annotations

import torch

from .mm import mm

__all__ = ["cpx", "add", "sub", "mul", "div", "conj", "abs2", "cabs",
           "matmul", "scale", "where", "to_complex", "from_complex",
           "sqrt_of_real"]


def cpx(re, im=None):
    re = torch.as_tensor(re)
    if im is None:
        im = torch.zeros_like(re)
    return re, torch.as_tensor(im)


def add(a, b):
    return a[0] + b[0], a[1] + b[1]


def sub(a, b):
    return a[0] - b[0], a[1] - b[1]


def mul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def conj(a):
    return a[0], -a[1]


def abs2(a):
    return a[0] * a[0] + a[1] * a[1]


def cabs(a):
    # overflow-safe |z|
    return torch.hypot(a[0], a[1])


def div(a, b):
    """Smith's algorithm: overflow/underflow-safe complex division,
    branch for branch as ``nd4js_tpu/core/cpx.py:55-73``."""
    br, bi = b
    use_r = torch.abs(br) >= torch.abs(bi)
    safe_br = torch.where(br == 0, 1.0, br)
    safe_bi = torch.where(bi == 0, 1.0, bi)
    # |br| >= |bi| branch
    r1 = bi / torch.where(use_r, safe_br, 1.0)
    den1 = br + bi * r1
    den1 = torch.where(den1 == 0, 1.0, den1)
    re1 = (a[0] + a[1] * r1) / den1
    im1 = (a[1] - a[0] * r1) / den1
    # |bi| > |br| branch
    r2 = br / torch.where(use_r, 1.0, safe_bi)
    den2 = bi + br * r2
    den2 = torch.where(den2 == 0, 1.0, den2)
    re2 = (a[0] * r2 + a[1]) / den2
    im2 = (a[1] * r2 - a[0]) / den2
    return torch.where(use_r, re1, re2), torch.where(use_r, im1, im2)


def matmul(a, b):
    """Complex GEMM from four real GEMMs."""
    return (mm(a[0], b[0]) - mm(a[1], b[1]),
            mm(a[0], b[1]) + mm(a[1], b[0]))


def scale(a, s):
    """Multiply by a real scalar or tensor."""
    return a[0] * s, a[1] * s


def where(pred, a, b):
    return torch.where(pred, a[0], b[0]), torch.where(pred, a[1], b[1])


def to_complex(a):
    """Combine a pair into a native complex tensor."""
    return torch.complex(a[0], a[1])


def from_complex(z):
    z = torch.as_tensor(z)
    return z.real, z.imag



def sqrt_of_real(x):
    """Complex square root of a *real* tensor as a pair: (√x, 0) where
    x ≥ 0, (0, √−x) elsewhere."""
    x = torch.as_tensor(x)
    pos = x >= 0
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return (torch.sqrt(torch.where(pos, x, zero)),
            torch.sqrt(torch.where(pos, zero, -x)))
