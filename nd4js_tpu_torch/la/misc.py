"""Small ``la`` odds and ends, the counterpart of ``nd4js_tpu/la/misc.py``."""
from __future__ import annotations

import torch

from ..convert import as_tensor

__all__ = ["transpose_inplace"]


def transpose_inplace(a, device=None) -> torch.Tensor:
    """The transpose of the trailing two axes, a view: tensors are not
    transposed in place here, as JAX arrays are not. An array-like ``a``
    goes to ``device`` (default ``config.default_device``)."""
    return as_tensor(a, device).transpose(-1, -2)
