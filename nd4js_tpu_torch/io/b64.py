"""Base64 codec for raw array bytes, the counterpart of
``nd4js_tpu/io/b64.py``."""
from __future__ import annotations

import base64

import numpy as np
import torch

from ..core.ndarray import asarray
from ._host import to_host

__all__ = ["b64_encode", "b64_decode"]


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def b64_encode(a) -> str:
    """Array data -> base64 string (dtype and shape not included)."""
    return base64.b64encode(to_host(a).tobytes()).decode("ascii")


def b64_decode(text: str, dtype, shape=None, device=None) -> torch.Tensor:
    """Base64 string -> tensor of ``dtype`` (a numpy or torch dtype or a
    name), reshaped to ``shape`` if given, on ``device``."""
    arr = np.frombuffer(base64.b64decode(text), dtype=_np_dtype(dtype))
    if shape is not None:
        arr = arr.reshape(shape)
    return asarray(arr, device=device)
