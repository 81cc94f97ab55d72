"""1-D root finding: bisection, Brent and Illinois, the counterpart of
``nd4js_tpu/opt/root1d.py``.

Each JAX ``lax.while_loop`` is a host loop that reads one flag an
iteration, whether to go on; each step selects with ``torch.where``. The
bracket must satisfy f(a)·f(b) ≤ 0, checked with one read before the
loop (ValueError otherwise, as the JAX package raises outside ``jit``).
Python numbers become float64 tensors on ``device`` (default
``config.default_device``); a float tensor keeps its dtype.
"""
from __future__ import annotations

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core.host import read
from ..dt import midl

__all__ = ["root1d_bisect", "root1d_brent", "root1d_illinois"]


def _bracket(f, a, b, device):
    """(a, b, f(a), f(b)) as tensors of one float dtype, the bracket
    checked."""
    a = as_tensor(a, device)
    a = a.to(default_float_for(a.dtype))
    b = as_tensor(b, a.device).to(a.dtype)
    fa, fb = f(a), f(b)
    if read(fa * fb > 0):
        raise ValueError("root1d: f(a) and f(b) must bracket a root")
    return a, b, fa, fb


def _closer(a, b, fa, fb):
    return torch.where(fa.abs() <= fb.abs(), a, b)


def root1d_bisect(f, a, b, max_iter: int = 200, device=None):
    """Bisection to the floating-point limit."""
    a, b, fa, fb = _bracket(f, a, b, device)
    i = 0
    while i < max_iter:
        m = midl(a, b)
        if not read((m != a) & (m != b) & (fa != 0) & (fb != 0)):
            break
        fm = f(m)
        left = (fm < 0) == (fa < 0)
        a, fa = torch.where(left, m, a), torch.where(left, fm, fa)
        b, fb = torch.where(left, b, m), torch.where(left, fb, fm)
        i += 1
    return _closer(a, b, fa, fb)


def root1d_illinois(f, a, b, max_iter: int = 128, device=None):
    """Illinois-type regula falsi (Ford variant)."""
    a, b, fa, fb = _bracket(f, a, b, device)
    eps = torch.finfo(a.dtype).eps
    i = 0
    while i < max_iter and read(
            ((b - a).abs() > eps * torch.maximum(a.abs(), b.abs()))
            & (fa != 0) & (fb != 0)):
        den = fb - fa
        den = torch.where(den == 0, torch.ones_like(den), den)
        c = b - fb * (b - a) / den
        c = torch.clamp(c, torch.minimum(a, b), torch.maximum(a, b))
        fc = f(c)
        same_side = (fc < 0) == (fb < 0)
        # Illinois: when the new point replaces b on the same side twice,
        # halve fa to force the bracket to move
        a, fa = torch.where(same_side, a, b), torch.where(same_side,
                                                          fa * 0.5, fb)
        b, fb = c, fc
        i += 1
    return _closer(a, b, fa, fb)


def root1d_brent(f, a, b, max_iter: int = 128, device=None):
    """Brent's method: bisection, secant and inverse quadratic
    interpolation."""
    a, b, fa, fb = _bracket(f, a, b, device)
    eps = torch.finfo(a.dtype).eps
    # keep |f(b)| <= |f(a)|
    swap = fa.abs() < fb.abs()
    a, b = torch.where(swap, b, a), torch.where(swap, a, b)
    fa, fb = torch.where(swap, fb, fa), torch.where(swap, fa, fb)
    c, fc, d = a, fa, a
    mflag = torch.ones((), dtype=torch.bool, device=a.device)
    i = 0
    while i < max_iter and read(
            (fb != 0)
            & ((b - a).abs() > 2 * eps * torch.clamp(b.abs(), min=1.0))):
        # inverse quadratic interpolation, or the secant
        use_iqi = (fa != fc) & (fb != fc)
        d1 = a * fb * fc / torch.where(use_iqi, (fa - fb) * (fa - fc), 1.0)
        d2 = b * fa * fc / torch.where(use_iqi, (fb - fa) * (fb - fc), 1.0)
        d3 = c * fa * fb / torch.where(use_iqi, (fc - fa) * (fc - fb), 1.0)
        den = fb - fa
        s_sec = b - fb * (b - a) / torch.where(den == 0, 1.0, den)
        s = torch.where(use_iqi, d1 + d2 + d3, s_sec)
        # the acceptance conditions, else bisection
        lo = (3 * a + b) / 4
        bad = ((s < torch.minimum(lo, b)) | (s > torch.maximum(lo, b))
               | (mflag & ((s - b).abs() >= (b - c).abs() / 2))
               | (~mflag & ((s - b).abs() >= (c - d).abs() / 2)))
        s = torch.where(bad, midl(a, b), s)
        mflag = bad
        fs = f(s)
        d, c, fc = c, b, fb
        left = (fa * fs) < 0
        a2, fa2 = torch.where(left, a, s), torch.where(left, fa, fs)
        b2, fb2 = torch.where(left, s, b), torch.where(left, fs, fb)
        # keep |f(b)| <= |f(a)|
        swap = fa2.abs() < fb2.abs()
        a, b = torch.where(swap, b2, a2), torch.where(swap, a2, b2)
        fa, fb = torch.where(swap, fb2, fa2), torch.where(swap, fa2, fb2)
        i += 1
    return torch.where(fa.abs() < fb.abs(), a, b)
