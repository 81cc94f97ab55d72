"""Polymorphic scalar/array math, the counterpart of ``nd4js_tpu/math.py``:
thin wrappers over torch's elementwise functions that also take Python
scalars and numpy arrays, as the JAX package's jnp functions do.

A Python scalar beside a tensor takes the dtype torch gives a scalar
operand (so 0.1 meets a float64 tensor in float64) and the tensor's
device; host data with no tensor beside it goes to ``device`` (default
``config.default_device``) with torch's dtypes (a Python float is
float32, an int int64). ``cbrt`` has no torch function: it is
|x|^(1/3) with the sign of x, within an ulp of a correctly rounded cube
root on exact cubes.
"""
from __future__ import annotations

import numpy as np
import torch

from . import config

__all__ = ["add", "sub", "mul", "div", "neg", "abs", "sqrt", "exp",
           "conj", "is_close", "cbrt", "atan2", "hypot", "sign",
           "min", "max"]

_SCALARS = (bool, int, float, complex)


def _lift(xs, device):
    """The arguments as tensors: tensors as they are, host data on the
    device of the first tensor among them, else on ``device``."""
    t0 = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    if device is None:
        device = config.default_device if t0 is None else t0.device
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif t0 is not None and isinstance(x, _SCALARS):
            out.append(torch.as_tensor(x, dtype=torch.result_type(t0, x),
                                       device=device))
        else:
            out.append(torch.as_tensor(np.asarray(x), device=device))
    return out


def _unary(fn, name, doc):
    def f(x, *, device=None):
        (x,) = _lift((x,), device)
        return fn(x)
    f.__name__ = f.__qualname__ = name
    f.__doc__ = doc
    return f


def _binary(fn, name, doc):
    def f(x, y, *, device=None):
        x, y = _lift((x, y), device)
        return fn(x, y)
    f.__name__ = f.__qualname__ = name
    f.__doc__ = doc
    return f


def _conj(x):
    return x.conj().resolve_conj()


def _floats(x):
    """Integers and bools as torch's default float."""
    return x if x.is_floating_point() or x.is_complex() \
        else x.to(torch.get_default_dtype())


def _cbrt(x):
    x = _floats(x)
    return torch.copysign(x.abs().pow(1 / 3), x)


def _hypot(x, y):
    return torch.hypot(_floats(x), _floats(y))


def _sign(x):
    return torch.sgn(x) if x.is_complex() else torch.sign(x)


add = _binary(torch.add, "add", "x + y, elementwise, with broadcasting.")
sub = _binary(torch.sub, "sub", "x − y, elementwise, with broadcasting.")
mul = _binary(torch.mul, "mul", "x · y, elementwise, with broadcasting.")
div = _binary(torch.true_divide, "div",
              "x / y (true division), elementwise, with broadcasting.")
neg = _unary(torch.neg, "neg", "−x, elementwise.")
abs = _unary(torch.abs, "abs", "|x|, elementwise.")  # noqa: A001
sqrt = _unary(torch.sqrt, "sqrt", "√x, elementwise (NaN for x < 0 real).")
exp = _unary(torch.exp, "exp", "eˣ, elementwise.")
conj = _unary(_conj, "conj", "Complex conjugate (a real x as it is).")
cbrt = _unary(_cbrt, "cbrt",
              "Real cube root |x|^(1/3) with the sign of x (−0 kept), "
              "elementwise; integers become torch's default float.")
atan2 = _binary(torch.atan2, "atan2", "atan2(y, x), elementwise.")
hypot = _binary(_hypot, "hypot", "√(x² + y²) without overflow.")
sign = _unary(_sign, "sign",
              "sign(x); x/|x| for complex x (0 at 0), elementwise.")
min = _binary(torch.minimum, "min",  # noqa: A001
              "Elementwise minimum (NaN propagates).")
max = _binary(torch.maximum, "max",  # noqa: A001
              "Elementwise maximum (NaN propagates).")


def is_close(x, y, rtol: float = 1e-5, atol: float = 1e-8, *, device=None):
    """|x − y| ≤ atol + rtol·|y|, elementwise, with the test matchers'
    defaults; integers and bools compare for equality."""
    x, y = _lift((x, y), device)
    dtype = torch.result_type(x, y)
    if not (dtype.is_floating_point or dtype.is_complex):
        return x == y
    return torch.isclose(x.to(dtype), y.to(dtype), rtol=rtol, atol=atol)
