"""Identity and diagonal constructors and extractors, the counterpart of
``nd4js_tpu/la/eye_diag.py``."""
from __future__ import annotations

import torch

from .. import config
from ..convert import as_tensor

__all__ = ["eye", "diag", "diag_mat"]


def eye(*shape, dtype=None, device=None) -> torch.Tensor:
    """eye(N), eye(M, N) or eye(b0, ..., M, N): the batched identity, a
    broadcast view (as ``jnp.broadcast_to`` gives it) on ``device``
    (default ``config.default_device``) in ``dtype`` (default
    ``config.default_float``)."""
    if dtype is None:
        dtype = config.default_float
    if len(shape) == 1:
        shape = (shape[0], shape[0])
    *batch, m, n = shape
    e = torch.eye(m, n, dtype=dtype, device=(
        config.default_device if device is None else device))
    return e.expand(tuple(batch) + (m, n))


def diag_mat(d, device=None) -> torch.Tensor:
    """The diagonal matrix of the last axis of ``d``, as d·I (so a
    non-finite entry spreads along its row, as in the JAX package). An
    array-like ``d`` goes to ``device`` (default
    ``config.default_device``)."""
    d = as_tensor(d, device)
    n = d.shape[-1]
    return d[..., :, None] * torch.eye(n, dtype=d.dtype, device=d.device)


def diag(a, offset: int = 0, device=None) -> torch.Tensor:
    """The ``offset`` diagonal of (..., M, N), a view. An array-like ``a``
    goes to ``device`` (default ``config.default_device``)."""
    return torch.diagonal(as_tensor(a, device), offset, -2, -1)
