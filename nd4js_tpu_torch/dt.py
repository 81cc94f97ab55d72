"""Dtype system, the counterpart of ``nd4js_tpu/dt.py``: the promotion
lattice of the five array dtypes, machine epsilon, scalar casts and the
float bit-tricks (``next_up``/``next_down``/``midl``, ``bit_count``).

Dtypes are torch dtypes. Functions that take a dtype also accept a numpy
dtype or a dtype name. ``next_up``/``next_down`` are ``torch.nextafter``,
vectorised, on the tensor's device, for any float dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from .convert import as_tensor

__all__ = [
    "ARRAY_TYPES", "eps", "cast_scalar", "dtypeof", "super_dtype",
    "is_subdtype", "next_up", "next_down", "midl", "bit_count",
]

# dtype name -> torch dtype; the reference's 'object' dtype has no tensor
# counterpart and is absent, as in the JAX package
ARRAY_TYPES = {
    "int32": torch.int32,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}

# total promotion order
_RANK = {"int32": 0, "float32": 1, "float64": 2, "complex64": 3, "complex128": 4}
_NAMES = {v: k for k, v in ARRAY_TYPES.items()}


def _name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        name = _NAMES.get(dtype, str(dtype).removeprefix("torch."))
    else:
        name = np.dtype(dtype).name
    if name not in ARRAY_TYPES:
        raise ValueError(
            f"Invalid dtype '{name}'. Must be one of {sorted(ARRAY_TYPES)}.")
    return name


def eps(dtype) -> float:
    """Machine epsilon of ``dtype`` (of its real part for a complex one);
    ValueError for int32."""
    name = _name(dtype)
    dtype = ARRAY_TYPES[name]
    if not (dtype.is_floating_point or dtype.is_complex):
        raise ValueError(f"eps: dtype {name} is not inexact")
    if dtype.is_complex:
        dtype = torch.float32 if dtype == torch.complex64 else torch.float64
    return float(torch.finfo(dtype).eps)


def cast_scalar(x, dtype, device=None) -> torch.Tensor:
    """``x`` as a 0-d tensor of ``dtype`` on ``device`` (default
    ``config.default_device``)."""
    return as_tensor(np.asarray(x), device).to(ARRAY_TYPES[_name(dtype)])


def dtypeof(value) -> str:
    """Dtype name a scalar value would be stored as."""
    if isinstance(value, (bool, np.bool_)):
        return "int32"
    if isinstance(value, (int, np.integer)):
        if -(2 ** 31) <= int(value) < 2 ** 31:
            return "int32"
        return "float64"
    if isinstance(value, (float, np.floating)):
        return "float64"
    if isinstance(value, (complex, np.complexfloating)):
        return "complex128"
    if isinstance(value, torch.Tensor) and value.ndim == 0:
        return _name(value.dtype)
    a = np.asarray(value)
    if a.ndim == 0:
        return _name(a.dtype)
    raise ValueError(f"Not a scalar: {value!r}")


def super_dtype(*dtypes) -> torch.dtype:
    """Least upper bound in the promotion order."""
    if not dtypes:
        raise ValueError("super_dtype() requires at least one dtype")
    best = max((_name(dt) for dt in dtypes), key=_RANK.__getitem__)
    return ARRAY_TYPES[best]


def is_subdtype(sub, sup) -> bool:
    """True iff ``sub`` promotes to ``sup``."""
    return _RANK[_name(sub)] <= _RANK[_name(sup)]


def next_up(x, device=None) -> torch.Tensor:
    """Smallest float greater than x."""
    x = as_tensor(x, device)
    return torch.nextafter(x, torch.full_like(x, float("inf")))


def next_down(x, device=None) -> torch.Tensor:
    """Largest float smaller than x."""
    x = as_tensor(x, device)
    return torch.nextafter(x, torch.full_like(x, float("-inf")))


def midl(x, y, device=None) -> torch.Tensor:
    """Overflow-safe midpoint x/2 + y/2 (exact for finite floats), used by
    bisection-style root finders."""
    x = as_tensor(x, device)
    return x * 0.5 + as_tensor(y, x.device) * 0.5


def bit_count(x, device=None) -> torch.Tensor:
    """Population count of int32 values (of their 32-bit two's complement),
    int32. torch has no popcount, so the bits are counted with shifts and
    masks on int64, where the 32-bit products below cannot overflow."""
    x = as_tensor(x, device).to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)
